"""Occ-row gather, occ4 by key, dependent row chains and a loop inside a
kernel: the wrappers of csrc/occ.cu and csrc/microbench.cu, and their
plain PyTorch versions.

Port of the last TPU kernels: bwamem_tpu/ops/pallas_occ.py (the DMA row
gather and its occ4 entry), bwamem_tpu/ops/pallas_onehot.py (the row
gather as a one-hot matmul), and the kernels of
tools/microbench_dmawave.py, tools/microbench_bigsmem.py (gw, gwk),
tools/microbench_palloop.py and tools/probe_mosaic_features.py, which
``python -m bwamem_tpu_torch.microbench`` runs.  Each wrapper
launches its kernel for a CUDA tensor and runs the plain version for a
CPU tensor; the layouts and paddings of the TPU kernels are not kept
(tests hold the function, not the layout).

Tables are int32 bit patterns (the occ table's uint32 words, as in
ops/fm.py).  The chains' arithmetic is uint32 in the kernel and int64
masked to 32 bits here, which gives the same values as the TPU's
wrapping int32.
"""

import torch

from . import _kernels, fm
from .fm import occ4 as occ4_plain

_M32 = 0xFFFFFFFF
MUL_A = 1103515245
ADD_B = 12345
# microbench_dmawave.py's `vdirect` differs from `dep` only by the TPU's
# index bounce; the card has none
CHAIN_MODES = ("dep", "nodep", "null", "full", "xpose", "dma")
MODE_ALIASES = {"vdirect": "dep"}
CHAIN_K = (1, 2, 4, 8)
AFFINE_MUL = 1.000001
AFFINE_ADD = 0.5


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 bit patterns."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _parts(table):
    """A table's parts: a fm.SplitTable's, or the whole table."""
    return table.parts if isinstance(table, fm.SplitTable) else (table,)


def _check_table(table: torch.Tensor) -> None:
    if table.dtype != torch.int32 or table.dim() != 2:
        raise ValueError(f"expected an int32 (n_rows, W) table, got "
                         f"{table.dtype} {tuple(table.shape)}")


# ---- row gather -----------------------------------------------------------

def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor,
                      transpose: bool = False) -> torch.Tensor:
    """Rows table[ids]: int32 [..., W], or (W, n) for 1-D ids with
    transpose; a zero row where an id lies outside [0, n_rows)."""
    _check_table(table)
    ids = ids.to(torch.int64)
    ok = ((ids >= 0) & (ids < table.shape[0])).reshape(-1)
    flat = torch.where(ok, ids.reshape(-1), 0)
    rows = torch.index_select(table, 0, flat)
    rows = torch.where(ok.unsqueeze(1), rows, torch.zeros_like(rows))
    if transpose:
        if ids.dim() != 1:
            raise ValueError("the transposed gather takes 1-D ids")
        return rows.t().contiguous()
    return rows.reshape(*ids.shape, table.shape[1])


def gather_rows_cuda(table: torch.Tensor, ids: torch.Tensor,
                     transpose: bool = False) -> torch.Tensor:
    """Launch bm_gather_rows (csrc/occ.cu) on CUDA ids."""
    _check_table(table)
    idx = _kernels.card_of(ids, "gather_rows")
    if table.get_device() != idx:
        raise ValueError(f"ids on {ids.device}, table on {table.device}")
    if transpose and ids.dim() != 1:
        raise ValueError("the transposed gather takes 1-D ids")
    if not table.is_contiguous():
        table = table.contiguous()
    flat = _kernels.on_card(ids, torch.int64, idx)
    n, W = flat.numel(), table.shape[1]
    out = torch.empty((W, n) if transpose else (n, W), dtype=torch.int32,
                      device=idx)
    if n:
        _kernels.GATHER.launch(idx, table.data_ptr(), table.shape[0], W,
                               flat.data_ptr(), n, int(transpose),
                               out.data_ptr())
    return out if transpose or ids.dim() == 1 \
        else out.view(*ids.shape, W)


def gather_rows(table, ids, transpose: bool = False) -> torch.Tensor:
    """The row-gather kernel for CUDA ids, the plain version for CPU."""
    if ids.is_cuda:
        return gather_rows_cuda(table, ids, transpose)
    return gather_rows_plain(table, ids, transpose)


# ---- occ4 -----------------------------------------------------------------

def occ4_cuda(blocks, primary: int, k: torch.Tensor) -> torch.Tensor:
    """Launch bm_occ4 (csrc/occ.cu): bwt_occ4 of int keys [...] on the
    (n_blocks, 16) table, whole or a fm.SplitTable; int64 [..., 4], zeros
    for k < 0 and for a key past the table (which the plain version
    refuses)."""
    for part in _parts(blocks):
        _check_table(part)
    if blocks.shape[1] != 16:
        raise ValueError(f"expected (n_blocks, 16) occ blocks, got "
                         f"{tuple(blocks.shape)}")
    idx = _kernels.card_of(k, "occ4")
    fm.check_parts(blocks, idx, "occ4")
    if isinstance(blocks, torch.Tensor) and not blocks.is_contiguous():
        blocks = blocks.contiguous()
    keys = _kernels.on_card(k, torch.int64, idx)
    out = torch.empty((*k.shape, 4), dtype=torch.int64, device=k.device)
    if keys.numel():
        _kernels.OCC4.launch(idx, *fm.kernel_parts(blocks), blocks.shape[0],
                             int(primary), keys.data_ptr(), keys.numel(),
                             out.data_ptr())
    return out


def occ4(blocks, primary: int, k: torch.Tensor) -> torch.Tensor:
    """bwt_occ4 by key: the kernel for CUDA keys, ops/fm.py occ4 for CPU
    keys."""
    if k.is_cuda:
        return occ4_cuda(blocks, primary, k)
    return occ4_plain(blocks, primary, k)


# ---- dependent row chains -------------------------------------------------

def _chain_args(table, idx0, mode):
    _check_table(table)
    mode = MODE_ALIASES.get(mode, mode)
    if mode not in CHAIN_MODES:
        raise ValueError(f"unknown chain mode {mode!r}")
    n_rows, W = table.shape
    if W % 4 or (mode == "full" and W < 16) or not 0 < n_rows < 1 << 31:
        raise ValueError(f"chain over a ({n_rows}, {W}) table: W must be a "
                         f"multiple of 4 (16 or more for full), n_rows in "
                         f"[1, 2^31)")
    if idx0.dim() != 2 or idx0.shape[0] not in CHAIN_K:
        raise ValueError(f"idx0 must be (K, C) with K in {CHAIN_K}, got "
                         f"{tuple(idx0.shape)}")
    return mode


def row_chain_plain(table: torch.Tensor, idx0: torch.Tensor, T: int,
                    mode: str = "dep") -> torch.Tensor:
    """K chains of T dependent row fetches for each of C lanes (the
    formulas in csrc/microbench.cu).  table: int32 (n_rows, W); idx0:
    int32 (K, C), the first row ids (as uint32, mod n_rows).  Returns
    int32 (C,): per lane, the sum over its chains of the last row id and
    of every fetched row's sum, mod 2^32."""
    mode = _chain_args(table, idx0, mode)
    n_rows = table.shape[0]
    st = (idx0.to(torch.int64) & _M32) % n_rows
    acc = torch.zeros_like(st)
    for t in range(T):
        if mode == "null":
            nxt = st * MUL_A + ADD_B + t
        else:
            r = st & ~7 if mode == "xpose" else st
            rows = fm._rows(table, r)                       # (K, C, W)
            s = rows.sum(-1) & _M32
            acc = (acc + s) & _M32
            if mode == "dep":
                nxt = (st ^ s) * MUL_A + ADD_B + t
            elif mode == "nodep":
                nxt = st * MUL_A + ADD_B + t
            elif mode == "full":
                nxt = st + rows[..., 0] + rows[..., 8] + t
            elif mode == "xpose":
                nxt = st + rows[..., 0] + t
            else:                                           # dma
                nxt = st + s + t
        st = (nxt & _M32) % n_rows
    return _as_int32((st + acc).sum(0) & _M32)


def row_chain_cuda(table: torch.Tensor, idx0: torch.Tensor, T: int,
                   mode: str = "dep") -> torch.Tensor:
    """Launch bm_row_chain (csrc/microbench.cu) on CUDA row ids."""
    mode = _chain_args(table, idx0, mode)
    idx = _kernels.card_of(idx0, "row_chain")
    if table.get_device() != idx:
        raise ValueError(f"idx0 on {idx0.device}, table on {table.device}")
    table = _kernels.on_card(table, torch.int32, idx)
    if table.data_ptr() % 16:
        raise ValueError("the chain kernel reads 16-byte words: the table "
                         "must be 16-byte aligned")
    idx0 = _kernels.on_card(idx0, torch.int32, idx)
    K, C = idx0.shape
    out = torch.empty(C, dtype=torch.int32, device=idx0.device)
    if C:
        _kernels.CHAIN.launch(idx, table.data_ptr(), table.shape[0],
                              table.shape[1], idx0.data_ptr(), C, K, int(T),
                              CHAIN_MODES.index(mode), out.data_ptr())
    return out


def row_chain(table, idx0, T: int, mode: str = "dep") -> torch.Tensor:
    """The chain kernel for CUDA row ids, the plain version for CPU."""
    if idx0.is_cuda:
        return row_chain_cuda(table, idx0, T, mode)
    return row_chain_plain(table, idx0, T, mode)


# ---- a loop inside one kernel --------------------------------------------

def affine_loop_plain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """c = c * 1.000001 + 0.5, iters times, in float32: two rounded
    operations a step, as the kernel does them."""
    a = torch.tensor(AFFINE_MUL, dtype=torch.float32, device=x.device)
    b = torch.tensor(AFFINE_ADD, dtype=torch.float32, device=x.device)
    c = x.to(torch.float32)
    for _ in range(iters):
        c = torch.add(torch.mul(c, a), b)
    return c


def affine_loop_cuda(x: torch.Tensor, iters: int) -> torch.Tensor:
    """Launch bm_affine_loop (csrc/microbench.cu): iters steps in one
    kernel."""
    if x.dtype != torch.float32:
        raise ValueError(f"expected float32, got {x.dtype}")
    idx = _kernels.card_of(x, "affine_loop")
    x = _kernels.on_card(x, torch.float32, idx)
    out = torch.empty_like(x)
    if x.numel():
        _kernels.LOOP.launch(idx, x.data_ptr(), x.numel(), int(iters),
                             out.data_ptr())
    return out


def affine_loop(x, iters: int) -> torch.Tensor:
    """The loop kernel for a CUDA tensor, the plain version for CPU."""
    if x.is_cuda:
        return affine_loop_cuda(x, iters)
    return affine_loop_plain(x, iters)
