"""The extension rows on the device, from per-seed scalars.

Port of bwamem_tpu/ops/pallas_extbuild.py.  The flat route's extension
groups normally upload four 4-bit-packed sequence rows per seed, which
the host packer (native/pack.cpp) cuts from the read and the reference.
With ``BWAMEM_TPU_ONCHIP_EXT=1`` (or ``force``) the engine uploads the
chunk's reads once and each group's per-seed scalars only, and
``build_rows`` cuts the same rows on the device: the kernel
(csrc/extbuild.cu) for CUDA tensors, the plain version below for CPU
tensors.  ``extend_lr_onchip`` is ``build_rows`` followed by the fused
extension (ops/ksw.py ksw_extend_lr_batched) on the rows it built.

The JAX builder's limits are the TPU's and are not carried over: its
VMEM caps on the reads matrix and the pac rows (MAX_READS,
MAX_PAC_ROWS), its power-of-two LQ and its LT + 255 <= 1024 window
(Mosaic's static rolls and a four-row pac gather), and its int32
coordinates ((l_pac << 1) < 2^31).  Here coordinates are int64 and every
query bucket and target bucket (LT up to 1056) is served.
"""

import numpy as np
import torch

from . import _kernels
from .ksw import ksw_extend_lr_batched


def pac_tensor(pac: np.ndarray) -> torch.Tensor:
    """The index's 2-bit pac (bwamem_tpu/index/bntseq.py: four bases a
    byte, the first in the high bits) as a uint8 tensor."""
    return torch.from_numpy(np.ascontiguousarray(pac, dtype=np.uint8))


def reads_matrix(seqs, width: int) -> np.ndarray:
    """int8 [n_reads, width]: the first `width` nt4 bases of each read,
    pad 4."""
    q = np.full((len(seqs), width), 4, np.int8)
    for i, s in enumerate(seqs):
        q[i, :min(len(s), width)] = s[:width]
    return q


def _pack_rows(a: torch.Tensor) -> torch.Tensor:
    """[B, L] bases 0..4 -> [B, L/2] int8, two a byte, low nibble first."""
    return (a[:, 0::2] | (a[:, 1::2] << 4)).to(torch.int8)


def build_rows_plain(reads_q, pac, l_pac: int, rid, qb0, slen, rb0,
                     rmax0, rmax1, lquery, LQ: int, LT: int):
    """Plain version of build_rows (the semantics of _make_builder,
    bwamem_tpu/ops/pallas_extbuild.py:109-215)."""
    i64 = torch.int64
    dev = reads_q.device
    rid, qb0, slen, lquery, rb0, rmax0, rmax1 = (
        t.to(i64) for t in (rid, qb0, slen, lquery, rb0, rmax0, rmax1))
    col = lambda v: v.unsqueeze(1)  # noqa: E731
    four = torch.full((), 4, dtype=i64, device=dev)
    rows = reads_q.to(i64)[rid]                              # [B, W]
    W = rows.shape[1]
    jq = torch.arange(LQ, device=dev).unsqueeze(0)
    qe0 = qb0 + slen

    def query(pos, n):
        got = rows.gather(1, pos.clamp(0, W - 1))
        return torch.where(jq < col(n), got, four)
    lq = query(col(qb0) - 1 - jq, qb0)
    rq = query(col(qe0) + jq, lquery - qe0)

    rev = col(rmax0 >= l_pac)
    jt = torch.arange(LT, device=dev).unsqueeze(0)

    def target(pos, n):
        f = torch.where(rev, 2 * l_pac - 1 - pos, pos)
        f = f.clamp(0, 4 * len(pac) - 1)
        b = (pac[f >> 2].to(i64) >> ((~f & 3) << 1)) & 3
        b = torch.where(rev, 3 - b, b)
        return torch.where(jt < col(n), b, four)
    zero = torch.zeros_like(qb0)
    lt = target(col(rb0) - 1 - jt, torch.where(qb0 > 0, rb0 - rmax0, zero))
    rt = target(col(rb0 + slen) + jt,
                torch.where(qe0 != lquery, rmax1 - rb0 - slen, zero))
    return tuple(_pack_rows(a) for a in (lq, lt, rq, rt))


def check_host_windows(n_reads: int, W: int, l_pac: int, rid, qb0, slen,
                       rb0, rmax0, rmax1, lquery) -> None:
    """ValueError where a lane's read or reference window lies out of
    range, when the caller holds the lanes on the host (none of them on
    the card: reading those would synchronise)."""
    lanes = (rid, qb0, slen, lquery, rb0, rmax0, rmax1)
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in lanes):
        return
    rid, qb0, slen, lquery, rb0, rmax0, rmax1 = (
        torch.as_tensor(t).to(torch.int64) for t in lanes)
    if bool(((rid < 0) | (rid >= n_reads) | (qb0 < 0) | (slen < 0)
             | (qb0 + slen > lquery) | (lquery > W) | (rmax0 < 0)
             | (rmax1 > 2 * l_pac)
             | ((rmax0 < l_pac) & (rmax1 > l_pac))).any()):
        raise ValueError("build_rows: a lane's read or reference window "
                         "exceeds its bucket")


def build_rows_cuda(reads_q, pac, l_pac: int, rid, qb0, slen, rb0, rmax0,
                    rmax1, lquery, LQ: int, LT: int):
    """Launch the row builder (csrc/extbuild.cu bm_build_rows): a thread
    per 16 output bytes.  The lanes' windows are checked where the caller
    holds them on the host; on the card the kernel clamps each position
    into the read's row and the pac instead."""
    if LQ % 2 or LT % 2 or LQ <= 0 or LT <= 0:
        raise ValueError(f"LQ and LT must be even and positive, got "
                         f"{LQ}, {LT}")
    if reads_q.dtype != torch.int8 or reads_q.dim() != 2:
        raise ValueError("reads_q must be int8 [n_reads, width]")
    if pac.dtype != torch.uint8 or pac.dim() != 1:
        raise ValueError("pac must be uint8 [n_bytes]")
    n_reads, W = reads_q.shape
    if 4 * pac.shape[0] < l_pac:
        raise ValueError(f"pac holds fewer than l_pac={l_pac} bases")
    windows = (rid, qb0, slen, rb0, rmax0, rmax1, lquery)
    check_host_windows(n_reads, W, l_pac, *windows)
    idx = _kernels.card_of(reads_q, "build_rows")
    if pac.get_device() != idx:
        raise ValueError(f"reads on {reads_q.device}, pac on {pac.device}")
    i32, i64 = torch.int32, torch.int64
    lane = _kernels.on_card_all(idx, *zip(
        windows, (i32, i32, i32, i64, i64, i64, i32)))
    B = lane[0].shape[0]
    if any(t.shape != (B,) for t in lane):
        raise ValueError(f"the per-seed arrays must have shape ({B},)")
    if B and not (n_reads and W):
        raise ValueError("build_rows: no reads to cut the query rows from")
    dev = reads_q.device
    outs = [torch.empty(B, w // 2, dtype=torch.int8, device=dev)
            for w in (LQ, LT, LQ, LT)]
    if B:
        reads_q = _kernels.on_card(reads_q, torch.int8, idx)
        pac = _kernels.on_card(pac, torch.uint8, idx)
        _kernels.BUILD.launch(
            idx, reads_q.data_ptr(), n_reads, W, pac.data_ptr(),
            pac.shape[0], l_pac, *(t.data_ptr() for t in lane), LQ, LT, B,
            *(o.data_ptr() for o in outs), bucket=f"LQ{LQ}")
    return tuple(outs)


def build_rows(reads_q, pac, l_pac: int, rid, qb0, slen, rb0, rmax0, rmax1,
               lquery, LQ: int, LT: int):
    """The four extension rows (lq, lt, rq, rt) of B seeds, packed two
    bases a byte with pad 4: [B, LQ/2], [B, LT/2], [B, LQ/2], [B, LT/2],
    equal to native/pack.cpp's lq_pk, lt_pk, rq_pk and rt_pk.  reads_q
    int8 [n_reads, W] holds the chunk's reads (pad 4, W at least the
    longest), pac the index's 2-bit pac; per seed: rid (its read), qb0
    and slen (the seed on the read), rb0 (on the doubled reference),
    rmax0/rmax1 (its chain's reference window) and lquery (the read's
    length).  The kernel for CUDA tensors, the plain version for CPU
    tensors."""
    fn = build_rows_cuda if reads_q.is_cuda else build_rows_plain
    return fn(reads_q, pac, l_pac, rid, qb0, slen, rb0, rmax0, rmax1,
              lquery, LQ, LT)


def extend_lr_onchip(reads_q, pac, l_pac: int, rid, qb0, slen, rb0, rmax0,
                     rmax1, lquery, llq, llt, rlq, rlt, sc_seed, mat,
                     o_del: int, e_del: int, o_ins: int, e_ins: int,
                     w0: int, pc5: int, pc3: int, zdrop: int, LQ: int,
                     LT: int):
    """ksw_extend_lr_batched on rows built on the device
    (bwamem_tpu/ops/pallas_extbuild.py extend_lr_onchip): the same eight
    outputs (score, truesc, qb, rb, qe, re, aw0, aw1)."""
    lq, lt, rq, rt = build_rows(reads_q, pac, l_pac, rid, qb0, slen, rb0,
                                rmax0, rmax1, lquery, LQ, LT)
    return ksw_extend_lr_batched(
        lq, lt, llq, llt, rq, rt, rlq, rlt, mat, o_del, e_del, o_ins,
        e_ins, w0, pc5, pc3, zdrop, sc_seed, qb0, rb0, rmax0, lquery, slen,
        LQ=LQ, LT=LT)
