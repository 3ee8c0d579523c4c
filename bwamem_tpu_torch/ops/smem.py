"""Batched SMEM search in PyTorch: the superstep, one iterator step, the
stream compaction and key expansion, and the fused superstep + SA walk.

Port of bwamem_tpu/ops/smem.py.  ``superstep`` runs the whole per-read
SMEM iterator (rounds of bwt_smem1 pass 1, the re-seeding pass 2, the
ordered merge and the stream append, software/bwamem.c:110-241);
``smem_iter_step`` runs one round of it (pass 1, the re-seeding test,
pass 2) for the round-per-launch route, and leaves the merge to the
host.  On a CUDA tensor each launches its kernel (csrc/smem.cu, a group
of eight threads per read), on a CPU tensor each runs its plain version
below, a lock-step translation of the JAX package's XLA path in which
Python ``while`` loops over all lanes take the place of
``lax.while_loop``.  Queries of up to 512 bp (the L=128, 256 and 512
buckets) go through the same code; outputs are int32/int64 at every L.  The compaction and the key expansion are plain
tensor code on either device; the SA walk is ``fm.sa_lookup`` (the
SA-walk kernel on CUDA).  The index is a ``fm.DeviceFmIndex`` or, with
its tables split over the cards of a mesh (``mem --shard-tables``), a
``fm.SplitFmIndex``: the plain versions read rows through ``fm.take``
and the kernels through their part lookup.
"""

import ctypes

import torch

from . import _kernels
from .fm import (DeviceFmIndex, check_parts, extend, kernel_parts,
                 sa_lookup)
from .ksw import unpack4

_BIG = 2 ** 30


def sel_col(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vals[..., idx] per lane; 0 where idx is out of range."""
    jj = torch.arange(vals.shape[-1], device=vals.device)
    hit = jj == idx.unsqueeze(-1)
    return torch.where(hit, vals, torch.zeros_like(vals)).sum(-1)


def set_col(vals: torch.Tensor, idx: torch.Tensor, new: torch.Tensor):
    """vals with vals[..., idx] = new per lane (idx == size drops)."""
    jj = torch.arange(vals.shape[-1], device=vals.device)
    return torch.where(jj == idx.unsqueeze(-1), new.unsqueeze(-1), vals)


def permute_cols(vals, src, valid=None):
    """out[..., j] = vals[..., src[..., j]] (0 outside valid)."""
    jj = torch.arange(vals.shape[-1], device=vals.device)
    oh = src.unsqueeze(-1) == jj
    out = torch.where(oh, vals.unsqueeze(-2),
                      torch.zeros((), dtype=vals.dtype,
                                  device=vals.device)).sum(-1)
    if valid is not None:
        out = torch.where(valid, out, torch.zeros_like(out))
    return out


def scatter_cols(vals, tgt):
    """out[..., j] = vals[..., k] where tgt[..., k] == j (tgt == size
    drops; targets unique per lane)."""
    jj = torch.arange(vals.shape[-1], device=vals.device)
    oh = tgt.unsqueeze(-2) == jj.unsqueeze(-1)
    return torch.where(oh, vals.unsqueeze(-2),
                       torch.zeros((), dtype=vals.dtype,
                                   device=vals.device)).sum(-1)


def _prev_valid_value(vals, valid, fill: int):
    """prev[..., j] = vals at the largest j' < j with valid[j'], else
    fill."""
    jj = torch.arange(vals.shape[-1], device=vals.device)
    last = torch.where(valid, jj, torch.full_like(jj, -1)).cummax(-1).values
    prev_idx = torch.cat([torch.full_like(last[..., :1], -1),
                          last[..., :-1]], dim=-1)
    got = torch.gather(vals, -1, prev_idx.clamp(min=0))
    return torch.where(prev_idx >= 0, got, torch.full_like(got, fill))


def smem1_plain(dfm: DeviceFmIndex, q, qlen, x, min_intv, active, M: int):
    """One batched bwt_smem1 pass (bwamem_tpu/ops/smem.py _smem1_impl):
    the SMEMs covering position x per lane of the unpacked queries q
    [B, L].  Returns (ret, n_mem, m0, m1, ms, mqb, mqe, overflow); the m*
    buffers [B, M] are sorted by qb."""
    B, L = q.shape
    dev = q.device
    i64 = torch.int64
    blocks, primary, L2 = dfm.blocks, dfm.primary_int, dfm.L2.to(i64)
    x = x.to(i64)
    qlen = qlen.to(i64)
    jj = torch.arange(M, device=dev).unsqueeze(0)
    zero = torch.zeros(B, dtype=i64, device=dev)

    qx = sel_col(q, x)
    bad = (qx > 3) | ~active
    qx_c = torch.where(bad, zero, qx)
    min_intv = min_intv.to(i64).clamp(min=1)
    ik0 = L2[qx_c] + 1
    ik1 = L2[3 - qx_c] + 1
    iks = L2[qx_c + 1] - L2[qx_c]
    ikend = x + 1

    # forward extension (software/bwt.c:790-801)
    c0, c1, cs, cend = (torch.zeros(B, M, dtype=i64, device=dev)
                        for _ in range(4))
    i = x + 1
    n_curr = zero.clone()
    done = bad.clone()
    while not bool(done.all()):
        at_end = i >= qlen
        ii = torch.minimum(i, qlen - 1).clamp(0, L - 1)
        cb = sel_col(q, ii)
        is_amb = cb > 3
        o0, o1, os_ = extend(blocks, primary, L2, ik0, ik1, iks,
                             is_back=False)
        cc = torch.where(is_amb, zero, 3 - cb).unsqueeze(-1)
        n0 = o0.gather(-1, cc)[:, 0]
        n1 = o1.gather(-1, cc)[:, 0]
        ns = os_.gather(-1, cc)[:, 0]
        changed = ns != iks
        small = ns < min_intv
        push = ~done & (at_end | is_amb | changed)
        stop = ~done & (at_end | is_amb | (changed & small))
        idx = torch.where(push, n_curr, torch.full_like(n_curr, M))
        c0 = set_col(c0, idx, ik0)
        c1 = set_col(c1, idx, ik1)
        cs = set_col(cs, idx, iks)
        cend = set_col(cend, idx, ikend)
        n_curr = n_curr + push.to(i64)
        cont = ~done & ~stop
        ik0 = torch.where(cont, n0, ik0)
        ik1 = torch.where(cont, n1, ik1)
        iks = torch.where(cont, ns, iks)
        ikend = torch.where(cont, i + 1, ikend)
        done = done | stop
        i = i + (~done).to(i64)
    overflow = n_curr > M

    # ret = info of the last pushed interval; bad lanes return x+1
    last = (n_curr - 1).clamp(0, M - 1)
    ret = torch.where(n_curr > 0, sel_col(cend, last), x + 1)
    src = (n_curr.unsqueeze(1) - 1 - jj).clamp(0, M - 1)
    p0, p1, ps, pend = (permute_cols(a, src) for a in (c0, c1, cs, cend))

    # backward extension (software/bwt.c:808-831)
    m0, m1, ms, mqb, mqe = (torch.zeros(B, M, dtype=i64, device=dev)
                            for _ in range(5))
    i = x - 1
    n_prev = n_curr
    n_mem = zero.clone()
    done = bad | (n_curr == 0)
    while not bool(done.all()):
        ii = i.clamp(0, L - 1)
        cb = sel_col(q, ii)
        c = torch.where((i < 0) | (cb > 3), torch.full_like(cb, -1), cb)
        o0, o1, os_ = extend(blocks, primary, L2, p0, p1, ps, is_back=True)
        csel = c.clamp(0, 3).view(B, 1, 1).expand(B, M, 1)
        n0 = o0.gather(-1, csel)[..., 0]
        n1 = o1.gather(-1, csel)[..., 0]
        ns = os_.gather(-1, csel)[..., 0]
        present = (jj < n_prev.unsqueeze(1)) & ~done.unsqueeze(1)
        fail = (c.unsqueeze(1) < 0) | (ns < min_intv.unsqueeze(1))
        nonfail = present & ~fail
        prev_s = _prev_valid_value(ns, nonfail, -1)
        nf_i = nonfail.to(i64)
        nf_before = nf_i.cumsum(1) - nf_i
        first_nf = nonfail & (nf_before == 0)
        keep = nonfail & (first_nf | (ns != prev_s))
        pos = keep.to(i64).cumsum(1) - 1
        tgt = torch.where(keep, pos, torch.full_like(pos, M))
        nc0, nc1, ncs, ncend = (scatter_cols(a, tgt)
                                for a in (n0, n1, ns, pend))
        n_curr_new = keep.sum(1)
        cand = present & fail & (nf_before == 0)
        cd_i = cand.to(i64)
        first_cand = cand & ((cd_i.cumsum(1) - cd_i) == 0)
        has_cand = first_cand.any(1)
        jstar = first_cand.to(i64).argmax(1)
        lastm = (n_mem - 1).clamp(min=0)
        allow = (n_mem == 0) | ((i + 1) < sel_col(mqb, lastm))
        do_mem = ~done & has_cand & allow
        midx = torch.where(do_mem, n_mem, torch.full_like(n_mem, M))
        m0 = set_col(m0, midx, sel_col(p0, jstar))
        m1 = set_col(m1, midx, sel_col(p1, jstar))
        ms = set_col(ms, midx, sel_col(ps, jstar))
        mqb = set_col(mqb, midx, i + 1)
        mqe = set_col(mqe, midx, sel_col(pend, jstar))
        n_mem = n_mem + do_mem.to(i64)
        done = done | (n_curr_new == 0)
        i = i - (~done).to(i64)
        p0, p1, ps, pend, n_prev = nc0, nc1, ncs, ncend, n_curr_new

    # reverse mem to qb-ascending order (software/bwt.c:833)
    src = (n_mem.unsqueeze(1) - 1 - jj).clamp(0, M - 1)
    valid = jj < n_mem.unsqueeze(1)
    m0, m1, ms, mqb, mqe = (permute_cols(a, src, valid)
                            for a in (m0, m1, ms, mqb, mqe))
    return ret, n_mem, m0, m1, ms, mqb, mqe, overflow


def superstep_plain(dfm: DeviceFmIndex, q_pk, qlen, min_intv, active,
                    split_len, split_width, L: int, M: int, OUT_CAP: int):
    """Plain version of the SMEM superstep (bwamem_tpu/ops/smem.py
    smem_superstep, PALLAS=False): every lane's iterator advances round
    by round in lock-step.  Returns (o0, os, oqb, oqe) [B, OUT_CAP] and
    n_out, over [B]; over lanes (a buffer of M entries or OUT_CAP
    exceeded) re-run on the host oracle."""
    q = unpack4(q_pk, L)
    B = q.shape[0]
    dev = q.device
    i64 = torch.int64
    qlen = qlen.to(i64)
    active = active.bool()
    split_len = split_len.to(i64)
    split_width = split_width.to(i64)
    jj = torch.arange(M, device=dev).unsqueeze(0)
    kk2 = torch.arange(2 * M, device=dev).unsqueeze(0)
    cap = torch.arange(OUT_CAP, device=dev).view(1, OUT_CAP, 1)
    KR = L + 1          # qlen - qe lies in [0, L]
    zero = torch.zeros(B, dtype=i64, device=dev)

    x = zero.clone()
    n_out = zero.clone()
    o0, o1, os_, oqb, oqe = (torch.zeros(B, OUT_CAP, dtype=i64, device=dev)
                             for _ in range(5))
    over = torch.zeros(B, dtype=torch.bool, device=dev)
    done = ~active | (x >= qlen)
    while not bool(done.all()):
        act = ~done
        ret, n_mem, m0, m1, ms, mqb, mqe, ov1 = smem1_plain(
            dfm, q, qlen, x, min_intv, act, M)
        ov1 = ov1 | (n_mem > M)
        # re-seeding test (software/bwamem.c:185-204)
        validm = jj < n_mem.unsqueeze(1)
        lens = torch.where(validm, mqe - mqb, torch.full_like(mqe, -1))
        best = lens.argmax(1)
        best_len = sel_col(lens, best)
        bs = sel_col(ms, best)
        bqb = sel_col(mqb, best)
        bqe = sel_col(mqe, best)
        need2 = (act & (n_mem > 0) & (split_len > 0)
                 & (best_len >= split_len) & (bs <= split_width) & ~ov1)
        x2 = (bqb + bqe) >> 1
        _, n2, s0, s1, ss, sqb, sqe, ov2 = smem1_plain(
            dfm, q, qlen, torch.where(need2, x2, zero),
            torch.where(need2, bs + 1, zero + 1), need2, M)
        n2 = torch.where(need2, n2, zero)
        ov2 = need2 & (ov2 | (n2 > M))

        # ordered merge (software/bwamem.c:206-238): qb-major,
        # (qlen-qe)-minor; sub first on key ties
        key_m = mqb * KR + (qlen.unsqueeze(1) - mqe)
        key_s = sqb * KR + (qlen.unsqueeze(1) - sqe)
        valid_m = jj < n_mem.unsqueeze(1)
        keep_s = ((jj < n2.unsqueeze(1))
                  & ((sqe - sqb) >= (best_len.unsqueeze(1) >> 1))
                  & (sqe > x.unsqueeze(1)))
        pos_s = keep_s.to(i64).cumsum(1) - 1
        tgt_s = torch.where(keep_s, pos_s, torch.full_like(pos_s, M))
        cs0, cs1, css, csqb, csqe, ckey_s = (
            scatter_cols(a, tgt_s) for a in (s0, s1, ss, sqb, sqe, key_s))
        ns = keep_s.sum(1)
        valid_s = jj < ns.unsqueeze(1)
        km = torch.where(valid_m, key_m, torch.full_like(key_m, _BIG))
        ks = torch.where(valid_s, ckey_s, torch.full_like(ckey_s, _BIG))
        le = (ks.unsqueeze(2) <= km.unsqueeze(1)) & valid_s.unsqueeze(2)
        rank_m = jj + le.sum(1)
        lt = (km.unsqueeze(2) < ks.unsqueeze(1)) & valid_m.unsqueeze(2)
        rank_s = jj + lt.sum(1)
        rank_m = torch.where(valid_m, rank_m, torch.full_like(rank_m, 2 * M))
        rank_s = torch.where(valid_s, rank_s, torch.full_like(rank_s, 2 * M))
        oh_m = rank_m.unsqueeze(1) == kk2.unsqueeze(2)      # [B, 2M, M]
        oh_s = rank_s.unsqueeze(1) == kk2.unsqueeze(2)

        def take(mv, sv):
            z = torch.zeros((), dtype=i64, device=dev)
            return (torch.where(oh_m, mv.unsqueeze(1), z).sum(2)
                    + torch.where(oh_s, sv.unsqueeze(1), z).sum(2))
        g0, g1, gs, gqb, gqe = (take(a, b) for a, b in (
            (m0, cs0), (m1, cs1), (ms, css), (mqb, csqb), (mqe, csqe)))
        n_mrg = n_mem + ns

        # append to the per-lane stream at cursor n_out
        col = n_out.unsqueeze(1) + kk2                       # [B, 2M]
        in_mrg = kk2 < n_mrg.unsqueeze(1)
        sel = (col.unsqueeze(1) == cap) & in_mrg.unsqueeze(1)
        hit = sel.any(2)

        def put(buf, vals):
            upd = torch.where(sel, vals.unsqueeze(1),
                              torch.zeros((), dtype=i64, device=dev)).sum(2)
            return torch.where(hit, upd, buf)
        o0, o1, os_, oqb, oqe = (put(a, b) for a, b in (
            (o0, g0), (o1, g1), (os_, gs), (oqb, gqb), (oqe, gqe)))
        n_new = n_out + torch.where(act, n_mrg, zero)
        over_now = act & (ov1 | ov2 | (n_new > OUT_CAP))
        over = over | over_now
        n_out = torch.where(act & ~over_now, n_new, n_out)
        x = torch.where(act, ret, x)
        done = done | over_now | (x >= qlen)
    return (o0, os_, oqb.to(torch.int32), oqe.to(torch.int32),
            n_out.to(torch.int32), over)


MAX_L = 512    # the longest query bucket the kernels take


def _check_queries(dfm: DeviceFmIndex, q_pk, qlen, L: int,
                   M: int) -> int:
    """The SMEM kernels' shape, dtype and device checks, and the query
    lengths where the caller holds them on the host.  Returns the card's
    index."""
    if L % 2 or not 0 < L <= MAX_L:
        raise ValueError(f"L must be even and <= {MAX_L}, got {L}")
    if not 1 <= M <= 32:
        raise ValueError(f"M must be in [1, 32], got {M}")
    B = q_pk.shape[0]
    if q_pk.shape != (B, L // 2) or q_pk.dtype != torch.int8:
        raise ValueError(f"q_pk must be int8 ({B}, {L // 2})")
    _kernels.check_host_lengths("smem", ("query", qlen, L))
    idx = _kernels.card_of(q_pk, "smem")
    check_parts(dfm.blocks, idx, "smem")
    return idx


def _lane_args(idx: int, B: int, *pairs):
    """The per-lane arrays as contiguous [B] tensors of their kernel
    dtypes on card idx."""
    out = _kernels.on_card_all(idx, *pairs)
    if any(t.shape != (B,) for t in out):
        raise ValueError(f"the per-lane arrays must have shape ({B},)")
    return out


def _step_pass(dfm, q, qlen, x, min_intv, active, M: int, M_OUT: int):
    """One pass of smem_iter_step on the wire: an overflowing lane is
    flagged and reads as an inactive one (ret x+1, no SMEMs); the
    buffers keep M_OUT columns."""
    i32 = torch.int32
    ret, n, m0, m1, ms, mqb, mqe, over = smem1_plain(
        dfm, q, qlen, x, min_intv, active, M)
    ok = ~over
    ret = torch.where(ok, ret, x.to(ret.dtype) + 1)
    n = torch.where(ok, n, torch.zeros_like(n))
    keep = ok.unsqueeze(1)
    cols = [torch.where(keep, a[:, :M_OUT], torch.zeros_like(a[:, :M_OUT]))
            for a in (m0, m1, ms, mqb, mqe)]
    return (ret.to(i32), n.to(i32), *cols[:3], cols[3].to(i32),
            cols[4].to(i32), over)


def smem_iter_step_plain(dfm: DeviceFmIndex, q_pk, qlen, x, min_intv,
                         active, split_len, split_width, L: int, M: int,
                         M_OUT: int):
    """Plain version of one fused iterator step (bwamem_tpu/ops/smem.py
    smem_iter_step, PALLAS=False): pass 1 from x with min_intv; the
    re-seeding test on the longest SMEM (the first maximum in qb order,
    software/bwamem.c:185-204); pass 2 from its middle with min_intv =
    its size + 1 on the lanes that pass it.  Returns (ret, n_mem, m0, m1,
    ms, mqb, mqe, over1, need2, ret2, n2, s0, s1, ss, sqb, sqe, over2):
    ret/n int32 [B]; x0/x1/s int64 and qb/qe int32 [B, M_OUT], qb
    ascending, zero past n; the flags bool [B].  n counts every SMEM of
    the pass (up to M), so n > M_OUT says the buffers were cut."""
    q = unpack4(q_pk, L)
    i64 = torch.int64
    act = active.bool()
    x = x.to(i64)
    r1 = _step_pass(dfm, q, qlen, x, min_intv, act, M, M)
    _, n1, m0, _, ms, mqb, mqe, over1 = r1
    jj = torch.arange(M, device=q.device).unsqueeze(0)
    lens = torch.where(jj < n1.unsqueeze(1), (mqe - mqb).to(i64),
                       torch.full_like(m0, -1))
    best = lens.argmax(1)
    best_len = sel_col(lens, best)
    bs = sel_col(ms, best)
    need2 = (act & (n1 > 0) & (split_len.to(i64) > 0)
             & (best_len >= split_len.to(i64))
             & (bs <= split_width.to(i64)) & ~over1)
    x2 = (sel_col(mqb.to(i64), best) + sel_col(mqe.to(i64), best)) >> 1
    zero = torch.zeros_like(x2)
    r2 = _step_pass(dfm, q, qlen, torch.where(need2, x2, zero),
                    torch.where(need2, bs + 1, zero + 1), need2, M, M_OUT)
    r1 = r1[:2] + tuple(a[:, :M_OUT] for a in r1[2:7]) + r1[7:]
    return r1 + (need2,) + r2


def smem_iter_step_cuda(dfm: DeviceFmIndex, q_pk, qlen, x, min_intv,
                        active, split_len, split_width, L: int, M: int,
                        M_OUT: int):
    """Launch the iterator-step kernel (csrc/smem.cu bm_smem_iter_step).
    Same outputs as smem_iter_step_plain."""
    idx = _check_queries(dfm, q_pk, qlen, L, M)
    if not 1 <= M_OUT <= M:
        raise ValueError(f"M_OUT must be in [1, M={M}], got {M_OUT}")
    B = q_pk.shape[0]
    dev = q_pk.device
    i32, i64 = torch.int32, torch.int64
    q = _kernels.on_card(q_pk, torch.int8, idx)
    args = _lane_args(idx, B, (qlen, i32), (x, i32), (min_intv, i64),
                      (active, torch.uint8), (split_len, i32),
                      (split_width, i32))

    def pass_out():
        return [torch.empty(B, dtype=i32, device=dev) for _ in range(2)] \
            + [torch.empty(B, M_OUT, dtype=i64, device=dev)
               for _ in range(3)] \
            + [torch.empty(B, M_OUT, dtype=i32, device=dev)
               for _ in range(2)] \
            + [torch.empty(B, dtype=torch.bool, device=dev)]
    o1, o2 = pass_out(), pass_out()
    need2 = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        p1, p2 = ((ctypes.c_void_p * 8)(*(t.data_ptr() for t in o))
                  for o in (o1, o2))
        _kernels.SMEM1.launch(
            idx, *kernel_parts(dfm.blocks), dfm.primary_int,
            dfm.seq_len_int, dfm.L2_host_ptr, q.data_ptr(), L,
            *(a.data_ptr() for a in args), M, M_OUT, B, p1,
            need2.data_ptr(), p2, bucket=f"L{L}")
    return (*o1, need2, *o2)


def smem_iter_step(dfm, q_pk, qlen, x, min_intv, active, split_len,
                   split_width, L: int, M: int, M_OUT: int):
    """One SMEM iterator step: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = smem_iter_step_cuda if q_pk.is_cuda else smem_iter_step_plain
    return fn(dfm, q_pk, qlen, x, min_intv, active, split_len, split_width,
              L, M, M_OUT)


def superstep_cuda(dfm: DeviceFmIndex, q_pk, qlen, min_intv, active,
                   split_len, split_width, L: int, M: int, OUT_CAP: int):
    """Launch the superstep kernel (csrc/smem.cu).  Same outputs as
    superstep_plain on the slots the consumer reads: o0/os/oqb/oqe slots
    [0, n_out) of lanes that did not overflow, n_out and over."""
    idx = _check_queries(dfm, q_pk, qlen, L, M)
    B = q_pk.shape[0]
    dev = q_pk.device
    q = _kernels.on_card(q_pk, torch.int8, idx)
    args = _lane_args(idx, B, (qlen, torch.int32), (min_intv, torch.int64),
                      (active, torch.uint8), (split_len, torch.int32),
                      (split_width, torch.int32))
    o0 = torch.empty(B, OUT_CAP, dtype=torch.int64, device=dev)
    os_ = torch.empty_like(o0)
    oqb = torch.empty(B, OUT_CAP, dtype=torch.int32, device=dev)
    oqe = torch.empty_like(oqb)
    n_out = torch.empty(B, dtype=torch.int32, device=dev)
    over = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        _kernels.SMEM.launch(
            idx, *kernel_parts(dfm.blocks), dfm.primary_int,
            dfm.seq_len_int, dfm.L2_host_ptr, q.data_ptr(), L,
            *(a.data_ptr() for a in args), M, OUT_CAP, B, o0.data_ptr(),
            os_.data_ptr(), oqb.data_ptr(), oqe.data_ptr(), n_out.data_ptr(),
            over.data_ptr(), bucket=f"L{L}")
    return o0, os_, oqb, oqe, n_out, over


def superstep(dfm, q_pk, qlen, min_intv, active, split_len, split_width,
              L: int, M: int, OUT_CAP: int):
    """The SMEM superstep: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = superstep_cuda if q_pk.is_cuda else superstep_plain
    return fn(dfm, q_pk, qlen, min_intv, active, split_len, split_width,
              L, M, OUT_CAP)


def compact_streams(o0, os_, oqb, oqe, n_out, over, GCAP: int):
    """Cross-lane compaction of the per-lane streams into GCAP flat
    slots, lane-major (bwamem_tpu/ops/smem.py _compact_streams).  Lanes
    whose stream would spill past GCAP are flagged over.  Slots past the
    total are zero."""
    B, OUT_CAP = o0.shape
    dev = o0.device
    n_eff = torch.where(over, torch.zeros_like(n_out), n_out).to(torch.int64)
    base = n_eff.cumsum(0) - n_eff
    over = over | (base + n_eff > GCAP)
    n_eff = torch.where(over, torch.zeros_like(n_eff), n_eff)
    base = n_eff.cumsum(0) - n_eff
    jj = torch.arange(OUT_CAP, device=dev).unsqueeze(0)
    valid = jj < n_eff.unsqueeze(1)
    tgt = torch.where(valid, base.unsqueeze(1) + jj,
                      torch.full_like(valid, GCAP, dtype=torch.int64))
    tgt = tgt.reshape(-1)

    def pack(a):
        out = torch.zeros(GCAP + 1, dtype=a.dtype, device=dev)
        out.scatter_(0, tgt, torch.where(valid, a, torch.zeros_like(a))
                     .reshape(-1))
        return out[:GCAP]
    return (pack(o0), pack(os_), pack(oqb), pack(oqe),
            n_eff.to(torch.int32), over)


def ragged_expand(x0, sizes, K: int):
    """keys[g] = x0[i] + (g - excl[i]) for the interval i owning slot g
    (the occurrence keys bwt_sa consumes, software/bwamem.c:420).
    Returns (keys[K] int64, total); slots >= total are zero."""
    sizes = sizes.to(torch.int64)
    cum = sizes.cumsum(0)
    excl = cum - sizes
    total = cum[-1]
    g = torch.arange(K, device=x0.device)
    owner = torch.searchsorted(cum, g, right=True).clamp(max=len(cum) - 1)
    keys = x0.to(torch.int64)[owner] + (g - excl[owner])
    return torch.where(g < total, keys, torch.zeros_like(keys)), total


def smem_superstep_sa(dfm: DeviceFmIndex, q_pk, qlen, min_intv, active,
                      split_len, split_width, min_seed_len: int,
                      max_occ: int, L: int, M: int, OUT_CAP: int,
                      GCAP: int, KEY_CAP: int, SA_STEPS: int):
    """Superstep + compaction + key expansion + SA walk for one lane
    group, without a host round trip (bwamem_tpu/ops/smem.py
    smem_superstep_sa).  Returns (c0, cs, cqb, cqe [GCAP], n_out, over
    [B], sa_vals, sa_over [KEY_CAP], n_keys, key_overflow); when
    key_overflow is set the caller redoes SA the split way."""
    o0, os_, oqb, oqe, n_out, over = superstep(
        dfm, q_pk, qlen, min_intv, active, split_len, split_width, L, M,
        OUT_CAP)
    c0, cs, cqb, cqe, n, over = compact_streams(o0, os_, oqb, oqe, n_out,
                                                over, GCAP)
    total = n.to(torch.int64).sum()
    gk = torch.arange(GCAP, device=c0.device)
    slen = cqe.to(torch.int64) - cqb.to(torch.int64)
    keep = (gk < total) & (slen >= min_seed_len) & (cs <= max_occ)
    sizes = torch.where(keep, cs, torch.zeros_like(cs))
    keys, n_keys = ragged_expand(c0, sizes, KEY_CAP)
    vals, over_sa = sa_lookup(dfm, keys, SA_STEPS)
    cdt = dfm.cdt
    return (c0.to(cdt), cs.to(cdt), cqb, cqe, n, over, vals, over_sa,
            n_keys, n_keys > KEY_CAP)
