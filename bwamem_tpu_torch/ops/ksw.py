"""Batched banded extension (ksw_extend2), the fused left+right seed
extension and banded global alignment with traceback, in PyTorch.

Port of bwamem_tpu/ops/ksw.py.  ``ksw_extend_lr_batched`` extends every
seed left and right with the x2 band-doubling retries
(software/bwamem.c:1120-1176); ``ksw_extend2_batched`` is one
ksw_extend2 per lane; ``ksw_global2_batched`` is ksw_global2
(software/ksw.c:501-585) with the traceback on the device.  On CUDA
tensors each launches its kernel (csrc/extend.cu: one warp per lane;
csrc/global.cu: one warp per lane); on CPU tensors each runs its plain
version below, the JAX package's lock-step DP (each row vectorized over
the query and over lanes, the F dependency resolved by a prefix max) with
a Python loop over rows.
"""

import numpy as np
import torch

from . import _kernels

NEG = -0x40000000
# out-of-band fill of the global DP's prefix scan: below every in-band
# value (bwamem_tpu/ops/ksw.py NEG2)
NEG2 = -0x60000000


def unpack4(p: torch.Tensor, L: int) -> torch.Tensor:
    """4-bit-packed rows (two bases per byte) -> (B, L) int64 bases."""
    p = p.to(torch.int64)
    return torch.stack([p & 15, (p >> 4) & 15], dim=-1).reshape(
        p.shape[0], L)


def extend_plain(query, target, qlen, tlen, mat, o_del: int, e_del: int,
                 o_ins: int, e_ins: int, w_in, end_bonus, zdrop: int, h0,
                 LQ: int, LT: int, active=None):
    """Plain batched ksw_extend2 (bwamem_tpu/ops/ksw.py _extend_impl).
    query [B, LQ] / target [B, LT] bases; per-lane qlen, tlen, w_in,
    end_bonus, h0; `active` masks lanes off.  Returns (best, qle, tle,
    gtle, gscore, max_off), int64[B]."""
    B = query.shape[0]
    dev = query.device
    i64 = torch.int64
    query, target = query.to(i64), target.to(i64)
    qlen, tlen = qlen.to(i64), tlen.to(i64)
    w_in, end_bonus = w_in.to(i64), end_bonus.to(i64)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    h0 = h0.to(i64).clamp(min=0)
    mat = mat.to(i64).reshape(-1)
    max_sc = int(mat.max())

    # band clamp (ksw.c:398-406): double math truncated toward zero
    qlen_f = qlen.double()
    max_ins = ((qlen_f * max_sc + end_bonus - o_ins) / e_ins + 1.0).to(i64)
    w = torch.minimum(w_in, max_ins.clamp(min=1))
    max_del = ((qlen_f * max_sc + end_bonus - o_del) / e_del + 1.0).to(i64)
    w = torch.minimum(w, max_del.clamp(min=1))

    jv = torch.arange(LQ + 1, device=dev).unsqueeze(0)
    jq = torch.arange(LQ, device=dev).unsqueeze(0)
    col = lambda v: v.unsqueeze(1)  # noqa: E731
    z = torch.zeros((), dtype=i64, device=dev)
    neg = torch.full((), NEG, dtype=i64, device=dev)

    eh_h = torch.where(jv == 0, col(h0),
                       (col(h0) - oe_ins - (jv - 1) * e_ins).clamp(min=0))
    eh_h = torch.where(jv <= col(qlen), eh_h, z)
    eh_e = torch.zeros(B, LQ + 1, dtype=i64, device=dev)
    i = torch.zeros(B, dtype=i64, device=dev)
    beg = torch.zeros_like(i)
    end = qlen.clone()
    best = h0.clone()
    max_i = torch.full_like(i, -1)
    max_j = torch.full_like(i, -1)
    max_ie = torch.full_like(i, -1)
    gscore = torch.full_like(i, -1)
    max_off = torch.zeros_like(i)
    done = tlen <= 0
    if active is not None:
        done = done | ~active.bool()

    while True:
        alive = ~done & (i < tlen)
        if not bool(alive.any()):
            break
        h1 = (h0 - (o_del + e_del * (i + 1))).clamp(min=0)
        beg = torch.maximum(beg, i - w)
        end = torch.minimum(torch.minimum(end, i + w + 1), qlen)
        degen = beg >= end
        run = alive & ~degen

        tch = target.gather(1, col(i.clamp(0, LT - 1)))
        qp = mat[tch * 5 + query]                                 # [B, LQ]
        band = (jq >= col(beg)) & (jq < col(end))
        hdiag = eh_h[:, :LQ]
        e = eh_e[:, :LQ]
        g = torch.where(band, hdiag + qp, neg)
        g = torch.maximum(g, torch.where(band, e, neg))
        # F by a prefix max within the band
        a_vec = torch.where(band, g + jq * e_ins, neg)
        cm = a_vec.cummax(1).values
        cm_prev = torch.cat([torch.full((B, 1), NEG, dtype=i64, device=dev),
                             cm[:, :-1]], dim=1)
        f = (cm_prev - oe_ins - (jq - 1) * e_ins).clamp(min=0)
        f = torch.where(jq == col(beg), z, f)
        h = torch.where(band, torch.maximum(g, f), z)

        mrow = h.max(1).values
        # mj: LAST band index achieving mrow; end-1 when mrow == 0
        hit = band & (h >= col(mrow)) & col(mrow > 0)
        mj = torch.where(hit, jq, torch.full_like(jq, -1)).max(1).values
        mj = torch.where(mrow > 0, mj, end - 1)

        # E update + H shift-store (ksw.c:436-447)
        new_e = torch.maximum(e - e_del, (h - oe_del).clamp(min=0))
        eh_e_new = torch.where(band & col(run), new_e, eh_e[:, :LQ])
        eh_e_new = torch.cat([eh_e_new, eh_e[:, LQ:]], dim=1)
        eh_e_new = torch.where(col(run) & (jv == col(end)), z, eh_e_new)
        h_shift = torch.cat([torch.zeros(B, 1, dtype=i64, device=dev), h],
                            dim=1)
        store = (jv >= col(beg) + 1) & (jv <= col(end))
        eh_h_new = torch.where(store, h_shift, eh_h)
        eh_h_new = torch.where(jv == col(beg), col(h1), eh_h_new)
        eh_h_new = torch.where(col(run), eh_h_new, eh_h)

        h1_last = h.gather(1, col((end - 1).clamp(0, LQ - 1)))[:, 0]
        g_upd = run & (end == qlen) & (gscore <= h1_last)
        # a degenerate band still applies the j == qlen gscore update
        # with the first-column h1 before its break (ksw.c:450-456)
        g_upd_d = alive & degen & (beg == qlen) & (gscore <= h1)
        max_ie = torch.where(g_upd | g_upd_d, i, max_ie)
        gscore = torch.where(g_upd, h1_last,
                             torch.where(g_upd_d, h1, gscore))

        zero_brk = run & (mrow == 0)
        improved = run & ~zero_brk & (mrow > best)
        di = i - max_i
        dj = mj - max_j
        zd = torch.where(di > dj, best - mrow - (di - dj) * e_del,
                         best - mrow - (dj - di) * e_ins)
        z_brk = run & ~zero_brk & ~improved & (zdrop > 0) & (zd > zdrop)
        off = (mj - i).abs()
        max_off = torch.where(improved & (max_off < off), off, max_off)
        best = torch.where(improved, mrow, best)
        max_i = torch.where(improved, i, max_i)
        max_j = torch.where(improved, mj, max_j)

        done = done | (alive & degen) | zero_brk | z_brk | (~alive & ~done)
        cont = run & ~zero_brk & ~z_brk

        # band narrowing over the new H row (ksw.c:463-466)
        z0 = eh_h_new == 0
        lowz = z0 & (jv >= col(beg)) & (jv <= col(mj))
        beg_new = torch.where(lowz, jv, col(beg) - 1).max(1).values + 1
        hiz = z0 & (jv >= col(mj) + 2) & (jv <= col(end))
        first_hi = torch.where(hiz, jv, torch.full_like(jv, LQ + 2)) \
            .min(1).values
        end_new = torch.minimum(first_hi, torch.maximum(mj + 2, end + 1))

        i = torch.where(cont, i + 1, i)
        beg = torch.where(cont, beg_new, beg)
        end = torch.where(cont, end_new, end)
        eh_h, eh_e = eh_h_new, eh_e_new
    return best, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off


def extend_lr_plain(lq, lt, llq, llt, rq, rt, rlq, rlt, mat, o_del, e_del,
                    o_ins, e_ins, w0, pc5, pc3, zdrop, sc_seed, s_qbeg,
                    s_rbeg, rmax0, l_query, s_len, LQ: int, LT: int):
    """Plain version of the fused left+right extension over packed rows
    (bwamem_tpu/ops/ksw.py _extend_lr_core)."""
    i64 = torch.int64
    lq, rq = unpack4(lq, LQ), unpack4(rq, LQ)
    lt, rt = unpack4(lt, LT), unpack4(rt, LT)
    llq, llt, rlq, rlt = (t.to(i64) for t in (llq, llt, rlq, rlt))
    sc_seed, s_qbeg, l_query, s_len = (
        t.to(i64) for t in (sc_seed, s_qbeg, l_query, s_len))
    s_rbeg, rmax0 = s_rbeg.to(i64), rmax0.to(i64)
    B = lq.shape[0]
    w0v = torch.full((B,), w0, dtype=i64, device=lq.device)
    w1v = w0v * 2
    pc5v = torch.full_like(w0v, pc5)
    pc3v = torch.full_like(w0v, pc3)
    retry_hi = (w0 >> 1) + (w0 >> 2)
    gap = (o_del, e_del, o_ins, e_ins)

    has_l = llq > 0
    sc_a0, qle0, tle0, gtle0, gsc0, mo0 = extend_plain(
        lq, lt, llq, llt, mat, *gap, w0v, pc5v, zdrop, sc_seed, LQ, LT,
        has_l)
    # bwamem.c:1136-1138: retry at double band when max_off is large
    retry_l = has_l & (sc_a0 != -1) & (mo0 >= retry_hi)
    a1 = extend_plain(lq, lt, llq, llt, mat, *gap, w1v, pc5v, zdrop,
                      sc_seed, LQ, LT, retry_l)
    pick = torch.where
    lsc = pick(retry_l, a1[0], sc_a0)
    lqle = pick(retry_l, a1[1], qle0)
    ltle = pick(retry_l, a1[2], tle0)
    lgtle = pick(retry_l, a1[3], gtle0)
    lgsc = pick(retry_l, a1[4], gsc0)
    aw0 = torch.where(has_l, pick(retry_l, w1v, w0v), w0v)

    # left decision (bwamem.c:1140-1148)
    g_ok = (lgsc <= 0) | (lgsc <= lsc - pc5)
    score = torch.where(has_l, lsc, sc_seed)
    truesc = torch.where(has_l, torch.where(g_ok, lsc, lgsc), sc_seed)
    qb = torch.where(has_l & g_ok, s_qbeg - lqle, torch.zeros_like(lqle))
    rb = torch.where(has_l, torch.where(g_ok, s_rbeg - ltle,
                                        s_rbeg - lgtle), s_rbeg)

    has_r = rlq > 0
    sc0 = score
    sc_b0, rqle0, rtle0, rgtle0, rgsc0, rmo0 = extend_plain(
        rq, rt, rlq, rlt, mat, *gap, w0v, pc3v, zdrop, sc0, LQ, LT, has_r)
    retry_r = has_r & (sc_b0 != sc0) & (rmo0 >= retry_hi)
    b1 = extend_plain(rq, rt, rlq, rlt, mat, *gap, w1v, pc3v, zdrop, sc0,
                      LQ, LT, retry_r)
    rsc = pick(retry_r, b1[0], sc_b0)
    rqle = pick(retry_r, b1[1], rqle0)
    rtle = pick(retry_r, b1[2], rtle0)
    rgtle = pick(retry_r, b1[3], rgtle0)
    rgsc = pick(retry_r, b1[4], rgsc0)
    aw1 = torch.where(has_r, pick(retry_r, w1v, w0v), w0v)

    # right decision (bwamem.c:1168-1176)
    re0 = s_rbeg + s_len - rmax0
    g_ok_r = (rgsc <= 0) | (rgsc <= rsc - pc3)
    qe = torch.where(has_r & g_ok_r, l_query - rlq + rqle, l_query)
    re = torch.where(has_r,
                     rmax0 + re0 + torch.where(g_ok_r, rtle, rgtle),
                     s_rbeg + s_len)
    truesc = torch.where(has_r,
                         truesc + torch.where(g_ok_r, rsc, rgsc) - sc0,
                         truesc)
    score = torch.where(has_r, rsc, score)
    i32 = torch.int32
    return (score.to(i32), truesc.to(i32), qb.to(i32), rb, qe.to(i32), re,
            aw0.to(i32), aw1.to(i32))


_EXT_LQ = (128, 256, 512)   # LQ values the kernel is instantiated for


def extend_lr_cuda(lq, lt, llq, llt, rq, rt, rlq, rlt, mat, o_del, e_del,
                   o_ins, e_ins, w0, pc5, pc3, zdrop, sc_seed, s_qbeg,
                   s_rbeg, rmax0, l_query, s_len, LQ: int, LT: int):
    """Launch the fused extension kernel (csrc/extend.cu)."""
    if LQ not in _EXT_LQ:
        raise ValueError(f"the extension kernel is built for LQ in "
                         f"{_EXT_LQ}, got {LQ}")
    B = lq.shape[0]
    for name, t, width in (("lq", lq, LQ), ("rq", rq, LQ),
                           ("lt", lt, LT), ("rt", rt, LT)):
        if t.shape != (B, width // 2) or t.dtype != torch.int8:
            raise ValueError(f"{name} must be packed int8 "
                             f"({B}, {width // 2})")
    _kernels.check_host_lengths("extend_lr", ("query", llq, LQ),
                                ("query", rlq, LQ), ("target", llt, LT),
                                ("target", rlt, LT))
    idx = _kernels.card_of(lq, "extend_lr")
    dev = lq.device
    i32, i64 = torch.int32, torch.int64
    # rmax0 cancels out of the right end (re = rmax0 + (s_rbeg + s_len -
    # rmax0) + tle), so the kernel does not take it
    ins = _kernels.on_card_all(
        idx, (lq, torch.int8), (lt, torch.int8), (llq, i32), (llt, i32),
        (rq, torch.int8), (rt, torch.int8), (rlq, i32), (rlt, i32),
        (mat.reshape(-1), torch.int8), (sc_seed, i32), (s_qbeg, i32),
        (s_rbeg, i64), (l_query, i32), (s_len, i32))
    outs = [torch.empty(B, dtype=dt, device=dev)
            for dt in (i32, i32, i32, i64, i32, i64, i32, i32)]
    if B:
        _kernels.EXTEND.launch(
            idx, LQ, LT, B, *(t.data_ptr() for t in ins[:9]), o_del, e_del,
            o_ins, e_ins, w0, pc5, pc3, zdrop,
            *(t.data_ptr() for t in ins[9:]),
            *(t.data_ptr() for t in outs), bucket=f"LQ{LQ}")
    return tuple(outs)


def ksw_extend_lr_batched(lq, lt, llq, llt, rq, rt, rlq, rlt, mat,
                          o_del: int, e_del: int, o_ins: int, e_ins: int,
                          w0: int, pc5: int, pc3: int, zdrop: int,
                          sc_seed, s_qbeg, s_rbeg, rmax0, l_query, s_len,
                          LQ: int, LT: int):
    """Every seed's left+right extension with the band-doubling retries
    (bwamem_tpu/ops/ksw.py ksw_extend_lr_batched, packed=True).  lq/rq
    are 4-bit-packed [B, LQ/2] query rows, lt/rt [B, LT/2] target rows
    (left ones pre-reversed).  Returns (score, truesc, qb, rb, qe, re,
    aw0, aw1); rb/re int64, the rest int32.  The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    fn = extend_lr_cuda if lq.is_cuda else extend_lr_plain
    return fn(lq, lt, llq, llt, rq, rt, rlq, rlt, mat, o_del, e_del,
              o_ins, e_ins, w0, pc5, pc3, zdrop, sc_seed, s_qbeg, s_rbeg,
              rmax0, l_query, s_len, LQ, LT)


def extend2_plain(query, target, qlen, tlen, mat, o_del: int, e_del: int,
                  o_ins: int, e_ins: int, w, end_bonus, zdrop: int, h0,
                  LQ: int, LT: int):
    """Plain version of ksw_extend2_batched over packed rows."""
    out = extend_plain(unpack4(query, LQ), unpack4(target, LT), qlen, tlen,
                       mat, o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop,
                       h0, LQ, LT)
    return tuple(t.to(torch.int32) for t in out)


def _check_rows(LQ: int, LT: int, q, t, qlen, tlen, what: str) -> int:
    """The packed rows' shapes and dtypes, and the lengths where the
    caller holds them on the host.  Returns the card's index."""
    B = q.shape[0]
    for name, x, width in (("query", q, LQ), ("target", t, LT)):
        if x.shape != (B, width // 2) or x.dtype != torch.int8:
            raise ValueError(f"{what}: {name} must be packed int8 "
                             f"({B}, {width // 2})")
    _kernels.check_host_lengths(what, ("query", qlen, LQ),
                                ("target", tlen, LT))
    return _kernels.card_of(q, what)


def extend2_cuda(query, target, qlen, tlen, mat, o_del: int, e_del: int,
                 o_ins: int, e_ins: int, w, end_bonus, zdrop: int, h0,
                 LQ: int, LT: int):
    """Launch the bare extension kernel (csrc/extend.cu bm_extend2)."""
    if LQ not in _EXT_LQ:
        raise ValueError(f"the extension kernel is built for LQ in "
                         f"{_EXT_LQ}, got {LQ}")
    idx = _check_rows(LQ, LT, query, target, qlen, tlen, "extend2")
    B = query.shape[0]
    i32 = torch.int32
    q, t, ql, tl, m, wv, eb, hv = _kernels.on_card_all(
        idx, (query, torch.int8), (target, torch.int8), (qlen, i32),
        (tlen, i32), (mat.reshape(-1), torch.int8), (w, i32),
        (end_bonus, i32), (h0, i32))
    outs = [torch.empty(B, dtype=i32, device=query.device)
            for _ in range(6)]
    if B:
        _kernels.EXTEND2.launch(
            idx, LQ, LT, B, q.data_ptr(), t.data_ptr(), ql.data_ptr(),
            tl.data_ptr(), m.data_ptr(), o_del, e_del, o_ins, e_ins,
            wv.data_ptr(), eb.data_ptr(), zdrop, hv.data_ptr(),
            *(o.data_ptr() for o in outs), bucket=f"LQ{LQ}")
    return tuple(outs)


def ksw_extend2_batched(query, target, qlen, tlen, mat, o_del: int,
                        e_del: int, o_ins: int, e_ins: int, w, end_bonus,
                        zdrop: int, h0, LQ: int, LT: int):
    """One ksw_extend2 per lane (bwamem_tpu/ops/ksw.py ksw_extend2_batched,
    packed=True): query [B, LQ/2] / target [B, LT/2] packed rows, per-lane
    qlen, tlen, band w, end_bonus and h0.  Returns (best, qle, tle, gtle,
    gscore, max_off), int32[B].  The kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = extend2_cuda if query.is_cuda else extend2_plain
    return fn(query, target, qlen, tlen, mat, o_del, e_del, o_ins, e_ins, w,
              end_bonus, zdrop, h0, LQ, LT)


def global_plain(query, target, qlen, tlen, mat, o_del: int, e_del: int,
                 o_ins: int, e_ins: int, w_in, LQ: int, LT: int):
    """Plain ksw_global2_batched over packed rows: the XLA row loop of
    bwamem_tpu/ops/ksw.py:369-490, then the traceback vectorized over
    lanes, one step per iteration."""
    B = query.shape[0]
    dev = query.device
    i64 = torch.int64
    query, target = unpack4(query, LQ), unpack4(target, LT)
    qlen, tlen, w = qlen.to(i64), tlen.to(i64), w_in.to(i64)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    mat = mat.to(i64).reshape(-1)
    jv = torch.arange(LQ + 1, device=dev).unsqueeze(0)
    jq = torch.arange(LQ, device=dev).unsqueeze(0)
    col = lambda v: v.unsqueeze(1)  # noqa: E731
    neg = torch.full((), NEG, dtype=i64, device=dev)

    # init (ksw.c:520-526)
    eh_h = torch.where((jv >= 1) & (jv <= col(torch.minimum(qlen, w))),
                       -(o_ins + e_ins * jv), neg)
    eh_h[:, 0] = 0
    eh_e = torch.full((B, LQ + 1), NEG, dtype=i64, device=dev)
    z = torch.zeros(B, LT, LQ, dtype=torch.uint8, device=dev)
    n_rows = int(tlen.max()) if B else 0
    for i in range(min(n_rows, LT)):
        run = i < tlen
        beg = (i - w).clamp(min=0)
        end = torch.minimum(i + w + 1, qlen)
        h1 = torch.where(beg == 0, -(o_del + e_del * (i + 1)), neg)
        degen = end <= beg
        do = run & ~degen
        qp = mat[col(target[:, i]) * 5 + query]                  # [B, LQ]
        band = (jq >= col(beg)) & (jq < col(end))
        e = eh_e[:, :LQ]
        mm = torch.where(band, eh_h[:, :LQ] + qp, neg)
        a_vec = torch.where(band, mm + jq * e_ins, NEG2)
        cm = a_vec.cummax(1).values
        cm_prev = torch.cat([torch.full((B, 1), NEG2, dtype=i64, device=dev),
                             cm[:, :-1]], dim=1)
        # the decayed band-edge term decides the direction flags
        f = torch.maximum(cm_prev - oe_ins - (jq - 1) * e_ins,
                          NEG - (jq - col(beg)) * e_ins)
        f = torch.where(jq == col(beg), neg, f)
        d = torch.where(mm >= e, 0, 1)
        h = torch.maximum(mm, e)
        d = torch.where(h >= f, d, 2)
        h = torch.maximum(h, f)
        e2 = e - e_del
        t_ = mm - oe_del
        d = d | torch.where(e2 > t_, 1 << 2, 0)
        new_e = torch.maximum(e2, t_)
        d = d | torch.where(f - e_ins > mm - oe_ins, 2 << 4, 0)
        z[:, i, :] = torch.where(band & col(do), d, 0).to(torch.uint8)

        at_end = jv == col(end)
        eh_e_new = torch.cat([torch.where(band, new_e, e), eh_e[:, LQ:]], 1)
        eh_e_new = torch.where(at_end, neg, eh_e_new)
        h_shift = torch.cat([torch.zeros(B, 1, dtype=i64, device=dev), h], 1)
        store = (jv >= col(beg) + 1) & (jv <= col(end))
        eh_h_new = torch.where(store, h_shift, eh_h)
        eh_h_new = torch.where(jv == col(beg), col(h1), eh_h_new)
        # degenerate rows only store eh_h[end] = h1, eh_e[end] = NEG
        eh_h_deg = torch.where(at_end, col(h1), eh_h)
        eh_e_deg = torch.where(at_end, neg, eh_e)
        deg = col(run & degen)
        eh_h = torch.where(col(do), eh_h_new,
                           torch.where(deg, eh_h_deg, eh_h))
        eh_e = torch.where(col(do), eh_e_new,
                           torch.where(deg, eh_e_deg, eh_e))
    score = eh_h.gather(1, col(qlen))[:, 0]

    # traceback (ksw.c:570-584)
    MAXOPS = LT + LQ
    ops = torch.zeros(B, MAXOPS + 1, dtype=torch.uint8, device=dev)
    i = tlen - 1
    k = torch.minimum(i + w + 1, qlen) - 1
    which = torch.zeros_like(i)
    n = torch.zeros_like(i)
    done = (i < 0) | (k < 0)
    lanes = torch.arange(B, device=dev)
    while not bool(done.all()):
        act = ~done
        dcode = z[lanes, i.clamp(0, LT - 1), k.clamp(0, LQ - 1)].to(i64)
        which_new = (dcode >> (which << 1)) & 3
        op = torch.where(which_new == 0, 0, torch.where(which_new == 1, 2, 1))
        ops[lanes, torch.where(act, n, MAXOPS)] = op.to(torch.uint8)
        i = torch.where(act, i - (which_new != 2).to(i64), i)
        k = torch.where(act, k - (which_new != 1).to(i64), k)
        which = torch.where(act, which_new, which)
        n = n + act.to(i64)
        done = done | (i < 0) | (k < 0)
    i32 = torch.int32
    return (score.to(i32), ops[:, :MAXOPS].contiguous(), n.to(i32),
            i.to(i32), k.to(i32))


_GLO_LQ = (128,)   # LQ values the global kernel is instantiated for


def global_cuda(query, target, qlen, tlen, mat, o_del: int, e_del: int,
                o_ins: int, e_ins: int, w, LQ: int, LT: int):
    """Launch the global-alignment kernel (csrc/global.cu bm_global2): one
    warp per lane, its direction bytes in shared memory."""
    if LQ not in _GLO_LQ:
        raise ValueError(f"the global kernel is built for LQ in {_GLO_LQ}, "
                         f"got {LQ}")
    idx = _check_rows(LQ, LT, query, target, qlen, tlen, "global2")
    B = query.shape[0]
    dev = query.device
    i32 = torch.int32
    q, t, ql, tl, wv, m = _kernels.on_card_all(
        idx, (query, torch.int8), (target, torch.int8), (qlen, i32),
        (tlen, i32), (w, i32), (mat.reshape(-1), torch.int8))
    score, n_ops, rem_i, rem_k = (torch.empty(B, dtype=i32, device=dev)
                                  for _ in range(4))
    ops = torch.empty(B, LT + LQ, dtype=torch.uint8, device=dev)
    if B:
        _kernels.GLOBAL2.launch(
            idx, LQ, LT, B, q.data_ptr(), t.data_ptr(), ql.data_ptr(),
            tl.data_ptr(), wv.data_ptr(), m.data_ptr(), o_del, e_del, o_ins,
            e_ins, score.data_ptr(), ops.data_ptr(), n_ops.data_ptr(),
            rem_i.data_ptr(), rem_k.data_ptr())
    return score, ops, n_ops, rem_i, rem_k


def ksw_global2_batched(query, target, qlen, tlen, mat, o_del: int,
                        e_del: int, o_ins: int, e_ins: int, w, LQ: int,
                        LT: int):
    """Banded global alignment with the traceback on the device
    (bwamem_tpu/ops/ksw.py ksw_global2_batched, packed=True): query
    [B, LQ/2] / target [B, LT/2] packed rows, per-lane qlen, tlen and band
    w.  Returns (score int32[B], ops uint8[B, LT+LQ] in reverse order
    (0=M 1=I 2=D), n_ops, rem_i, rem_k int32[B]).  The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    fn = global_cuda if query.is_cuda else global_plain
    return fn(query, target, qlen, tlen, mat, o_del, e_del, o_ins, e_ins, w,
              LQ, LT)


def cigar_from_traceback(ops_row, n: int, rem_i: int, rem_k: int) -> list:
    """The BAM cigar of one traceback: append the trailing deletion and
    insertion runs (ksw.c:580-581), reverse, run-length encode
    (bwamem_tpu/ops/ksw.py:33)."""
    seq = list(ops_row[:n])
    if rem_i >= 0:
        seq.extend([2] * (rem_i + 1))
    if rem_k >= 0:
        seq.extend([1] * (rem_k + 1))
    seq.reverse()
    cigar = []
    for op in seq:
        if cigar and (cigar[-1] & 0xF) == op:
            cigar[-1] += 16
        else:
            cigar.append(16 | int(op))
    return cigar


def cigars_from_tracebacks(ops: np.ndarray, n_ops: np.ndarray,
                           rem_i: np.ndarray, rem_k: np.ndarray,
                           rows) -> list:
    """cigar_from_traceback over a whole wave, as one run-length pass over
    every lane's op sequence with sentinels between lanes
    (bwamem_tpu/ops/ksw.py:52)."""
    segs = []
    bounds = [0]
    for bi in rows:
        n = int(n_ops[bi])
        ri, rk = int(rem_i[bi]), int(rem_k[bi])
        parts = [ops[bi, :n]]
        if ri >= 0:
            parts.append(np.full(ri + 1, 2, np.uint8))
        if rk >= 0:
            parts.append(np.full(rk + 1, 1, np.uint8))
        seq = (np.concatenate(parts) if len(parts) > 1 else parts[0])[::-1]
        segs.append(seq)
        bounds.append(bounds[-1] + len(seq) + 1)   # +1: the sentinel
    if not segs:
        return []
    total = bounds[-1]
    flat = np.full(total, 255, np.uint8)    # 255: a sentinel, not an op
    for seq, lo in zip(segs, bounds[:-1]):
        flat[lo:lo + len(seq)] = seq
    brk = np.nonzero(np.diff(flat.astype(np.int16)))[0]
    starts = np.concatenate([[0], brk + 1])
    lens = np.diff(np.concatenate([starts, [total]]))
    vals = flat[starts]
    keep = vals != 255
    starts, lens, vals = starts[keep], lens[keep], vals[keep]
    lane_of = np.searchsorted(np.asarray(bounds), starts, side="right") - 1
    packed = (lens.astype(np.int64) << 4) | vals
    out = [[] for _ in segs]
    for ln, pk in zip(lane_of, packed):
        out[ln].append(int(pk))
    return out
