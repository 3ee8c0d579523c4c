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
"""

import os

import numpy as np
import torch
from torch import nn

from . import _kernels

WORDS_PER_BLOCK = 16
_M55 = 0x55555555
_M32 = 0xFFFFFFFF
_SA8_MAX_BYTES = 2048 << 20   # the JAX package's BWAMEM_TPU_SA8_MAX_MB


def _uniform_blocks(bwt: np.ndarray, seq_len: int) -> np.ndarray:
    """Repack the compact interleaved uint32 array into (n_blocks, 16)
    (the final block may carry fewer than 8 words on disk)."""
    n_blocks = (seq_len + 127) >> 7
    n_plain_words = (seq_len + 15) >> 4
    out = np.zeros((n_blocks, WORDS_PER_BLOCK), dtype=np.uint32)
    full = n_plain_words >> 3
    out[:full] = bwt[:full * 16].reshape(-1, 16)
    if full < n_blocks:
        rem = n_plain_words - full * 8
        out[full, :8 + rem] = bwt[full * 16:full * 16 + 8 + rem]
    return out


class DeviceFmIndex(nn.Module):
    """The FM index on a device: occ blocks, L2, primary, seq_len and the
    sampled SA are registered buffers, so ``.to(device)`` moves them
    together.  Python-int copies of the scalars ride along for kernel
    arguments and host arithmetic."""

    def __init__(self, blocks, L2, primary, seq_len, sa, sa_intv: int):
        super().__init__()
        L2 = torch.from_numpy(np.array(L2))
        self.register_buffer("blocks", torch.from_numpy(
            np.array(blocks, dtype=np.uint32).view(np.int32)))
        self.register_buffer("L2", L2)
        self.register_buffer("primary", torch.tensor(int(primary),
                                                     dtype=L2.dtype))
        self.register_buffer("seq_len", torch.tensor(int(seq_len),
                                                     dtype=L2.dtype))
        self.register_buffer("sa", torch.from_numpy(np.array(sa)))
        self.sa_intv = int(sa_intv)
        self.primary_int = int(primary)
        self.seq_len_int = int(seq_len)
        self.L2_host = L2.numpy().astype(np.int64)
        self.L2_host_ptr = self.L2_host.ctypes.data   # a kernel argument

    @property
    def cdt(self) -> torch.dtype:
        """Coordinate dtype (int32 for sub-Gbp genomes, else int64)."""
        return self.L2.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @classmethod
    def from_host(cls, fm) -> "DeviceFmIndex":
        """Tables of a host FmIndex (bwamem_tpu.index.fmindex.FmIndex),
        on the CPU; move them with ``.to(device)``."""
        blocks = _uniform_blocks(fm.bwt, int(fm.seq_len))
        # +2 margin: interval arithmetic forms seq_len+1 style values
        cdt = np.int32 if int(fm.seq_len) + 2 < (1 << 31) else np.int64
        if os.environ.get("BWAMEM_TPU_FORCE_I64"):  # test the wide path
            cdt = np.int64
        # denser sample when the index ships the .sa8 sidecar: identical
        # values, ~4x fewer psi-walk steps; past the size cap the sparse
        # .sa wins
        sa8 = getattr(fm, "sa8", None)
        if sa8 is not None and sa8.nbytes > _SA8_MAX_BYTES:
            sa8 = None
        sa = (sa8 if sa8 is not None else fm.sa).astype(cdt)
        return cls(blocks, fm.L2.astype(cdt), fm.primary, fm.seq_len, sa,
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


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of non-negative int64 values below 2^32 (SWAR)."""
    x = x - ((x >> 1) & _M55)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _rows(blocks: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """Occ-block rows [..., 16] as int64 words in [0, 2^32)."""
    return blocks[blk].to(torch.int64) & _M32


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


def sa_lookup_batched(dfm: DeviceFmIndex, k: torch.Tensor,
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
    vals = steps + dfm.sa.to(torch.int64)[si]
    vals = torch.where(over, torch.full_like(vals, -1), vals)
    return vals.to(dfm.cdt), over


def sa_walk_cuda(dfm: DeviceFmIndex, k: torch.Tensor, max_steps: int):
    """Launch the SA-walk kernel (csrc/sa.cu) on CUDA keys; it writes the
    values in the coordinate dtype and the flags as bool."""
    intv = dfm.sa_intv
    if intv & (intv - 1):
        raise ValueError(f"sa_intv must be a power of two, got {intv}; "
                         "such indexes take the host walk")
    idx = _kernels.card_of(k, "sa_walk")
    if dfm.blocks.get_device() != idx:
        raise ValueError(f"keys on {k.device}, index on {dfm.device}")
    keys = _kernels.on_card(k, torch.int64, idx)
    n = keys.numel()
    cdt = dfm.cdt
    vals = torch.empty(n, dtype=cdt, device=k.device)
    over = torch.empty(n, dtype=torch.bool, device=k.device)
    if n:
        _kernels.SA.launch(
            idx, dfm.blocks.data_ptr(), dfm.primary_int, dfm.seq_len_int,
            dfm.L2_host_ptr, dfm.sa.data_ptr(),
            int(dfm.sa.dtype == torch.int64), intv, keys.data_ptr(), n,
            int(max_steps), vals.data_ptr(), int(cdt == torch.int64),
            over.data_ptr())
    return vals, over


def sa_lookup(dfm: DeviceFmIndex, k: torch.Tensor, max_steps: int = 128):
    """bwt_sa for a batch of rows: the SA-walk kernel for CUDA keys, the
    plain version for CPU keys."""
    if k.is_cuda:
        return sa_walk_cuda(dfm, k, max_steps)
    return sa_lookup_batched(dfm, k, max_steps)
