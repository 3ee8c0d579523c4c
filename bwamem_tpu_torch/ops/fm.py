"""Device FM index and the batched occ/extend/SA primitives, in PyTorch.

Port of bwamem_tpu/ops/fm.py.  The interleaved BWT+occ array lives on
the device as one ``(n_blocks, 16)`` table (one row per 64-byte occ
block: four 64-bit checkpoint counts, then 128 2-bit symbols), stored
as int32 bit patterns because PyTorch has few uint32 operations.  The
wide ``(rows, 128)`` TPU layout and its byte-plane copies are not
ported: a CUDA kernel reads the narrow table with plain loads at every
size.

The functions below are the plain PyTorch versions (the specs the CUDA
kernels are held against); ``sa_lookup`` is the SA-walk kernel's
wrapper.  Coordinates follow the JAX package's dtype rule: int32 tables
when the doubled pack fits 31 bits, int64 beyond; the arithmetic itself
runs in int64, which gives the same values.

Split tables (``mem --shard-tables``, the JAX package's
``BWAMEM_TPU_SHARD_TABLES=1``): ``DeviceFmIndex.split`` cuts the occ
table and the sampled SA by rows into one contiguous part per device of
a mesh (``SplitTable``), each part copied from the host straight to its
device, and returns a ``SplitFmIndex``, which answers what a
DeviceFmIndex answers.  The plain versions read every row through one
accessor (``take``), which takes either kind of table; the kernels
resolve a row to its part and load it where it lies (csrc/fm.cuh), with
no collective: where the JAX package gathers row indices from every
shard and scatters the rows back (its ops/fm.py _sharded_lookup), a
card loads a peer card's row over NVLink.
"""

import copy
import ctypes
import os

import numpy as np
import torch
from torch import nn

from . import _kernels
from ..index.fmindex import sa8_nbytes

WORDS_PER_BLOCK = 16
_M55 = 0x55555555
_M32 = 0xFFFFFFFF
UPLOAD_ROWS = 1 << 22   # rows a slice of a table's upload (256 MiB of occ)
SA8_MAX_BYTES = 2048 << 20   # BWAMEM_TPU_SA8_MAX_MB's default, 2048 MiB


def coordinate_dtype(seq_len: int) -> torch.dtype:
    """The coordinate dtype of an index of seq_len doubled bases: int32
    while seq_len + 2 < 2^31 (the interval arithmetic forms seq_len + 1
    style values), else int64; BWAMEM_TPU_FORCE_I64 takes int64 at any
    size (the wide path on a small genome)."""
    if seq_len + 2 >= 1 << 31 or os.environ.get("BWAMEM_TPU_FORCE_I64"):
        return torch.int64
    return torch.int32


def dense_sa_fits(nbytes: int) -> bool:
    """Whether a .sa8 sample of nbytes (as loaded, int64) serves the SA
    walk: up to the cap, BWAMEM_TPU_SA8_MAX_MB MiB (a float, as the JAX
    package reads it) or SA8_MAX_BYTES where it is unset; past it the
    sparse .sa (interval 32) does."""
    mb = os.environ.get("BWAMEM_TPU_SA8_MAX_MB")
    return nbytes <= (SA8_MAX_BYTES if mb is None else float(mb) * (1 << 20))


def dense_sa_serves(prefix: str) -> bool:
    """Whether the index at prefix has a .sa8 sample that from_host
    would take, reckoned from the file's header without loading it."""
    nbytes = sa8_nbytes(prefix + ".sa8")
    return nbytes is not None and dense_sa_fits(nbytes)


def upload(dst: torch.Tensor, src: np.ndarray) -> None:
    """dst[:len(src)] = src (converted to dst's dtype), UPLOAD_ROWS rows
    at a time: a slice's conversion or staging is the only temporary,
    never a whole host copy of the table."""
    for lo in range(0, len(src), UPLOAD_ROWS):
        part = src[lo:lo + UPLOAD_ROWS]
        dst[lo:lo + len(part)].copy_(torch.from_numpy(part))


def upload_blocks(dst: torch.Tensor, bwt: np.ndarray, seq_len: int) -> None:
    """The compact interleaved uint32 array into dst, the (n_blocks, 16)
    int32 occ table: the full blocks straight from a view of bwt, the
    final one (it may carry fewer than 8 words on disk) zero-padded."""
    n_plain_words = (seq_len + 15) >> 4
    full = n_plain_words >> 3
    words = np.asarray(bwt).view(np.int32)
    upload(dst, words[:full * 16].reshape(-1, WORDS_PER_BLOCK))
    if full < dst.shape[0]:
        rem = n_plain_words - full * 8
        last = np.zeros(WORDS_PER_BLOCK, np.int32)
        last[:8 + rem] = words[full * 16:full * 16 + 8 + rem]
        dst[full].copy_(torch.from_numpy(last))


MAX_PARTS = 8   # csrc/fm.cuh kMaxParts: one part per card of a node


class SplitTable:
    """A table cut by rows into contiguous parts: part i holds rows
    [i * rows, (i + 1) * rows), the last part what is left (a part is
    empty where the table is too short to reach it).  The parts are
    allocations of their own, so no device holds the whole table."""

    def __init__(self, parts, rows: int):
        self.parts = tuple(parts)
        self.rows = rows
        n = sum(p.shape[0] for p in self.parts)
        self.shape = torch.Size((n, *self.parts[0].shape[1:]))
        self.dtype = self.parts[0].dtype
        # the kernels' argument: a host array of the parts' addresses
        self.arg = (ctypes.c_void_p * len(self.parts))(
            *(p.data_ptr() for p in self.parts))

    @staticmethod
    def part_rows(n: int, k: int) -> int:
        """Rows of each of k parts of n rows but the last: ceil(n / k),
        at least 2, rounded up to a multiple of 2^shift, shift =
        max(0, bit_length - 29), so that the kernels' part lookup
        (csrc/fm.cuh row_at) divides 32-bit numbers; the rounding moves
        fewer than one row in 2^28."""
        rows = max(-(-n // k), 2)
        shift = max(rows.bit_length() - 29, 0)
        return -(-rows >> shift) << shift

    @classmethod
    def cut(cls, table: torch.Tensor, devices) -> "SplitTable":
        """table cut into one part per device, in order (a device may
        repeat), part_rows rows a part, each copied from table to its
        device on its own."""
        k, n = len(devices), table.shape[0]
        if not 2 <= k <= MAX_PARTS:
            raise ValueError(f"a table splits into 2 to {MAX_PARTS} parts, "
                             f"not {k}")
        rows = cls.part_rows(n, k)
        return cls([table[min(i * rows, n):min((i + 1) * rows, n)].to(
            torch.device(d), copy=True) for i, d in enumerate(devices)],
            rows)

    def element_size(self) -> int:
        return self.parts[0].element_size()

    def take(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows idx [...] as table[idx] gives them (negative ids from the
        end, IndexError past it), on idx's device: each part's rows
        gathered where they lie."""
        n = self.shape[0]
        idx = idx.to(torch.int64)
        if idx.numel() and (int(idx.min()) < -n or int(idx.max()) >= n):
            raise IndexError(f"a row id outside [-{n}, {n})")
        idx = torch.where(idx < 0, idx + n, idx)
        part = idx // self.rows
        off = idx - part * self.rows
        out = torch.empty((*idx.shape, *self.shape[1:]), dtype=self.dtype,
                          device=idx.device)
        for i, p in enumerate(self.parts):
            sel = part == i
            out[sel] = p[off[sel].to(p.device)].to(idx.device)
        return out


def take(table, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a whole table (a tensor) or a SplitTable: the one
    row accessor of the plain versions."""
    if isinstance(table, SplitTable):
        return table.take(idx)
    return table[idx]


def kernel_parts(table):
    """The first three arguments of the FM kernels' entries for a table:
    a host array of its parts' addresses, their count and the rows of
    each but the last; a whole table is one part."""
    if isinstance(table, SplitTable):
        return table.arg, len(table.parts), table.rows
    return (ctypes.c_void_p * 1)(table.data_ptr()), 1, table.shape[0]


def check_parts(table, idx: int, what: str) -> None:
    """ValueError unless every part of table (a whole table: itself) lies
    on card idx or on a card whose memory idx reaches by peer access
    (_kernels.enable_peer), 16-byte aligned (the kernels load a row in
    16-byte pieces)."""
    parts = table.parts if isinstance(table, SplitTable) else (table,)
    for p in parts:
        card = p.get_device()
        if card != idx and not _kernels.reaches(idx, card):
            raise ValueError(f"{what}: a table part on {p.device}, which "
                             f"cuda:{idx} cannot load (peer access not "
                             f"enabled)")
        if p.data_ptr() % 16:
            raise ValueError(f"{what}: a table part is not 16-byte aligned "
                             f"(the kernels load a row in 16-byte pieces)")


class DeviceFmIndex(nn.Module):
    """The FM index on a device: occ blocks, L2, primary, seq_len and the
    sampled SA are registered buffers, so ``.to(device)`` moves them
    together.  Python-int copies of the scalars ride along for kernel
    arguments and host arithmetic."""

    def __init__(self, blocks, L2, primary, seq_len, sa, sa_intv: int):
        super().__init__()
        # tensors are taken as they are, arrays copied (occ words as
        # int32 bit patterns)
        if not isinstance(blocks, torch.Tensor):
            blocks = torch.from_numpy(
                np.array(blocks, dtype=np.uint32).view(np.int32))
        L2, sa = (t if isinstance(t, torch.Tensor)
                  else torch.from_numpy(np.array(t)) for t in (L2, sa))
        self.register_buffer("blocks", blocks)
        self.register_buffer("L2", L2)
        self.register_buffer("primary", torch.tensor(
            int(primary), dtype=L2.dtype, device=L2.device))
        self.register_buffer("seq_len", torch.tensor(
            int(seq_len), dtype=L2.dtype, device=L2.device))
        self.register_buffer("sa", sa)
        self.sa_intv = int(sa_intv)
        self.primary_int = int(primary)
        self.seq_len_int = int(seq_len)
        self.L2_host = L2.cpu().numpy().astype(np.int64)
        self.L2_host_ptr = self.L2_host.ctypes.data   # a kernel argument

    @property
    def cdt(self) -> torch.dtype:
        """Coordinate dtype (int32 for sub-Gbp genomes, else int64)."""
        return self.L2.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def replica(self, device) -> "DeviceFmIndex":
        """The index with its tables on device, this one left where it is
        (the per-card copies of a reads mesh); itself where its tables
        lie there already."""
        device = torch.device(device)
        if self.blocks.device == device:
            return self
        new = copy.copy(self)
        new._buffers = {k: v.to(device) for k, v in self._buffers.items()}
        return new

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    def split(self, devices) -> "SplitFmIndex":
        """The occ table and the sampled SA cut into one part per device
        of devices, in order (SplitTable.cut: each part copied on its own,
        so none of them holds a whole table); the scalars and L2 on the
        first device."""
        devices = [torch.device(d) for d in devices]
        return SplitFmIndex(SplitTable.cut(self.blocks, devices),
                            SplitTable.cut(self.sa, devices), self.L2,
                            self.primary_int, self.seq_len_int, self.sa_intv,
                            devices[0])

    @classmethod
    def from_host(cls, fm, device="cpu") -> "DeviceFmIndex":
        """Tables of a host FmIndex (bwamem_tpu.index.fmindex.FmIndex),
        made on device and filled slice by slice from the host index's
        own arrays (upload): the host holds no copy of a table beside
        them for a card, the tensor itself on the CPU."""
        device = torch.device(device)
        seq_len = int(fm.seq_len)
        cdt = coordinate_dtype(seq_len)
        # denser sample when the index ships the .sa8 sidecar: identical
        # values, ~4x fewer psi-walk steps; past the size cap the sparse
        # .sa wins
        sa8 = getattr(fm, "sa8", None)
        if sa8 is not None and not dense_sa_fits(sa8.nbytes):
            sa8 = None
        sa_host = sa8 if sa8 is not None else fm.sa
        blocks = torch.empty(((seq_len + 127) >> 7, WORDS_PER_BLOCK),
                             dtype=torch.int32, device=device)
        upload_blocks(blocks, fm.bwt, seq_len)
        sa = torch.empty(len(sa_host), dtype=cdt, device=device)
        upload(sa, np.asarray(sa_host))
        L2 = torch.tensor(np.asarray(fm.L2, np.int64), dtype=cdt,
                          device=device)
        return cls(blocks, L2, fm.primary, seq_len, sa,
                   fm.sa8_intv if sa8 is not None else fm.sa_intv)

    @classmethod
    def from_jax_arrays(cls, blocks, L2, primary, seq_len, sa, sa_intv):
        """The JAX index's arrays, as numpy, taken over unchanged (the
        narrow (n_blocks, 16) layout only)."""
        blocks = np.asarray(blocks)
        if blocks.ndim != 2 or blocks.shape[1] != WORDS_PER_BLOCK:
            raise ValueError(f"expected (n_blocks, 16) occ blocks, got "
                             f"{blocks.shape}")
        return cls(blocks, np.asarray(L2), int(np.asarray(primary)),
                   int(np.asarray(seq_len)), np.asarray(sa), int(sa_intv))


class SplitFmIndex:
    """The index with its occ table (``blocks``) and sampled SA (``sa``)
    as SplitTables, the parts on the devices of a mesh, and L2, primary
    and seq_len on one device, its own (``device``): the attributes of a
    DeviceFmIndex, so the plain versions and the kernels' wrappers take
    either.  ``on(device)`` is the same parts seen from another device."""

    def __init__(self, blocks: SplitTable, sa: SplitTable, L2, primary: int,
                 seq_len: int, sa_intv: int, device):
        self.blocks = blocks
        self.sa = sa
        self.sa_intv = int(sa_intv)
        self.primary_int = int(primary)
        self.seq_len_int = int(seq_len)
        self.L2_host = np.asarray(L2.cpu(), np.int64)
        self.L2_host_ptr = self.L2_host.ctypes.data
        self._place(L2, device)

    def _place(self, L2, device) -> None:
        self._device = torch.device(device)
        self.L2 = L2.to(self._device)
        self.primary = torch.tensor(self.primary_int, dtype=L2.dtype,
                                    device=self._device)
        self.seq_len = torch.tensor(self.seq_len_int, dtype=L2.dtype,
                                    device=self._device)

    @property
    def cdt(self) -> torch.dtype:
        return self.L2.dtype

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    def on(self, device) -> "SplitFmIndex":
        """The same parts, the scalars and L2 on device."""
        new = copy.copy(self)
        new._place(self.L2, device)
        return new


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of non-negative int64 values below 2^32 (SWAR)."""
    x = x - ((x >> 1) & _M55)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _rows(blocks: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """Occ-block rows [..., 16] as int64 words in [0, 2^32)."""
    return take(blocks, blk).to(torch.int64) & _M32


def occ4(blocks, primary: int, k: torch.Tensor) -> torch.Tensor:
    """Batched bwt_occ4: per-base counts of bwt[0..k] inclusive, 0 for
    k == -1.  k: int[...]; returns int64[..., 4]."""
    k = k.to(torch.int64)
    valid = k >= 0
    kk = k - (k >= primary).to(torch.int64)
    kk = torch.where(valid, kk, torch.zeros_like(kk))
    row = _rows(blocks, kk >> 7)
    ck = row[..., 0:8:2] | (row[..., 1:8:2] << 32)
    words = row[..., 8:16]
    off = kk & 127
    wi = (off >> 4).unsqueeze(-1)
    r = ((~off) & 15).unsqueeze(-1)
    j = torch.arange(8, device=k.device)
    pmask = (~((torch.ones_like(r) << (r * 2)) - 1)) & _M32
    wmask = torch.where(j < wi, torch.full_like(pmask, _M32),
                        torch.where(j == wi, pmask,
                                    torch.zeros_like(pmask)))
    w = words & wmask
    hb = (w >> 1) & _M55
    lb = w & _M55
    # one popcount over the three symbol masks: 3 (11), 2 (10), 1 (01)
    c3, c2, c1 = _popcount32(torch.stack(
        [hb & lb, hb & (~lb & _M32), lb & (~hb & _M32)])).sum(-1)
    c0 = (off + 1) - c1 - c2 - c3
    within = torch.stack([c0, c1, c2, c3], dim=-1)
    return torch.where(valid.unsqueeze(-1), ck + within,
                       torch.zeros_like(ck))


def extend(blocks, primary: int, L2: torch.Tensor, x0, x1, s,
           is_back: bool):
    """Batched bwt_extend.  Returns (ok0, ok1, oks), each int64[..., 4]:
    the candidate bi-intervals for bases 0..3."""
    x0, x1, s = (t.to(torch.int64) for t in (x0, x1, s))
    L2 = L2.to(torch.int64)
    fwd = x0 if is_back else x1
    both = occ4(blocks, primary, torch.stack([fwd - 1, fwd - 1 + s]))
    tk, tl = both[0], both[1]
    occ_side = L2[:4] + 1 + tk
    oks = tl - tk
    bump = ((fwd <= primary) & (fwd + s - 1 >= primary)).to(torch.int64)
    same3 = (x1 if is_back else x0) + bump
    same2 = same3 + oks[..., 3]
    same1 = same2 + oks[..., 2]
    same0 = same1 + oks[..., 1]
    same = torch.stack([same0, same1, same2, same3], dim=-1)
    if is_back:
        return occ_side, same, oks
    return same, occ_side, oks


def bwt_b0(blocks, x: torch.Tensor) -> torch.Tensor:
    """Batched bwt_B0: the BWT symbol at $-removed position x."""
    x = x.to(torch.int64)
    row = _rows(blocks, x >> 7)
    w = torch.gather(row, -1, (8 + ((x >> 4) & 7)).unsqueeze(-1))[..., 0]
    return (w >> (((~x) & 15) * 2)) & 3


def occ1(blocks, primary: int, L2, seq_len: int, k, c) -> torch.Tensor:
    """Batched bwt_occ via occ4 + select; k == seq_len and k == -1
    handled like the reference."""
    k = k.to(torch.int64)
    L2 = L2.to(torch.int64)
    at_end = k == seq_len
    all4 = occ4(blocks, primary, torch.where(at_end, torch.full_like(k, -1),
                                             k))
    sel = torch.gather(all4, -1, c.unsqueeze(-1))[..., 0]
    return torch.where(at_end, L2[c + 1] - L2[c], sel)


def inv_psi(blocks, primary: int, L2, seq_len: int, k) -> torch.Tensor:
    """Batched bwt_invPsi."""
    k = k.to(torch.int64)
    x = k - (k > primary).to(torch.int64)
    c = bwt_b0(blocks, x)
    nxt = L2.to(torch.int64)[c] + occ1(blocks, primary, L2, seq_len, k, c)
    return torch.where(k == primary, torch.zeros_like(k), nxt)


def sa_lookup_batched(dfm, k: torch.Tensor,
                      max_steps: int = 128):
    """Plain version of the SA walk (bwt_sa): all keys walk inverse-Psi
    steps in lock-step, each until it reaches a sampled row or
    max_steps.  Returns (vals in the coordinate dtype, -1 where over;
    over bool)."""
    intv = dfm.sa_intv
    if intv & (intv - 1):
        raise ValueError(f"sa_intv must be a power of two, got {intv}")
    mask = intv - 1
    k = k.to(torch.int64)
    steps = torch.zeros_like(k)
    for _ in range(max_steps):
        act = (k & mask) != 0
        if not bool(act.any()):
            break
        k2 = inv_psi(dfm.blocks, dfm.primary_int, dfm.L2, dfm.seq_len_int,
                     k)
        k = torch.where(act, k2, k)
        steps = steps + act.to(torch.int64)
    over = (k & mask) != 0
    si = torch.where(over, torch.zeros_like(k), k >> (intv.bit_length() - 1))
    vals = steps + take(dfm.sa, si).to(torch.int64)
    vals = torch.where(over, torch.full_like(vals, -1), vals)
    return vals.to(dfm.cdt), over


def sa_walk_cuda(dfm, k: torch.Tensor, max_steps: int):
    """Launch the SA-walk kernel (csrc/sa.cu) on CUDA keys; it writes the
    values in the coordinate dtype and the flags as bool."""
    intv = dfm.sa_intv
    if intv & (intv - 1):
        raise ValueError(f"sa_intv must be a power of two, got {intv}; "
                         "such indexes take the host walk")
    idx = _kernels.card_of(k, "sa_walk")
    check_parts(dfm.blocks, idx, "sa_walk")
    check_parts(dfm.sa, idx, "sa_walk")
    keys = _kernels.on_card(k, torch.int64, idx)
    n = keys.numel()
    cdt = dfm.cdt
    vals = torch.empty(n, dtype=cdt, device=k.device)
    over = torch.empty(n, dtype=torch.bool, device=k.device)
    if n:
        sa, _, sa_rows = kernel_parts(dfm.sa)
        _kernels.SA.launch(
            idx, *kernel_parts(dfm.blocks), dfm.primary_int,
            dfm.seq_len_int, dfm.L2_host_ptr, sa, sa_rows,
            int(dfm.sa.dtype == torch.int64), intv, keys.data_ptr(), n,
            int(max_steps), vals.data_ptr(), int(cdt == torch.int64),
            over.data_ptr())
    return vals, over


def sa_lookup(dfm, k: torch.Tensor, max_steps: int = 128):
    """bwt_sa for a batch of rows: the SA-walk kernel for CUDA keys, the
    plain version for CPU keys."""
    if k.is_cuda:
        return sa_walk_cuda(dfm, k, max_steps)
    return sa_lookup_batched(dfm, k, max_steps)
