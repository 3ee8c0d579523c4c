"""Batched local Smith-Waterman (ksw_align2) in PyTorch.

Port of bwamem_tpu/ops/ksw_align.py.  The reference's ksw_u8/ksw_i16
are SSE2 Farrar-striped kernels (software/ksw.c:110-364); their result
equals standard SW over a virtual query padded to ceil(qlen/p)*p
positions with zero-score pads, with u8 saturation reproduced by
clipping.  ``ksw_align_batched`` runs one such pass per lane: on CUDA
tensors the kernel csrc/align.cu, one thread per lane; on CPU tensors
the plain version below, the JAX package's row loop vectorized over
lanes and the virtual query.

``align2_wave`` serves a wave of mate-rescue ("align2", q, ref, xtra)
requests with it and replays ksw_align2's host-side bookkeeping
(software/ksw.c:330-364) exactly: the second-best score from the rows'
maxima (the b-list run-splitting quirk, ksw.c:180-186), and the start
positions from the reference's reversed-prefix rerun (ksw.c:355-363) as
a second batched pass.
"""

import numpy as np
import torch

from bwamem_tpu_torch.oracle import ksw as oksw

from . import _kernels

NEG = -0x40000000


def align_plain(query, target, qlen, tlen, mat, o_del: int, e_del: int,
                o_ins: int, e_ins: int, endsc, shift: int, size: int,
                LQV: int, LT: int):
    """Plain ksw_align_batched (bwamem_tpu/ops/ksw_align.py:70-139) over
    int8 bases query [B, LQV] / target [B, LT]."""
    B = query.shape[0]
    dev = query.device
    i64 = torch.int64
    query, target = query.to(i64), target.to(i64)
    qlen, tlen, endsc = qlen.to(i64), tlen.to(i64), endsc.to(i64)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    mat = mat.to(i64).reshape(-1)
    sat = 255 - shift
    col = lambda v: v.unsqueeze(1)  # noqa: E731
    jq = torch.arange(LQV, device=dev).unsqueeze(0)
    qvalid = jq < col(qlen)
    p = 16 if size == 1 else 8
    vmask = jq < col((qlen + p - 1) // p * p)

    H = torch.zeros(B, LQV, dtype=i64, device=dev)
    E = torch.zeros_like(H)
    Hmax = torch.zeros_like(H)
    gmax = torch.zeros(B, dtype=i64, device=dev)
    te = torch.full_like(gmax, -1)
    last = torch.full_like(gmax, -1)
    row_max = torch.zeros(B, LT, dtype=i64, device=dev)
    done = tlen <= 0
    saturated = torch.zeros(B, dtype=torch.bool, device=dev)
    zcol = torch.zeros(B, 1, dtype=i64, device=dev)
    negcol = torch.full((B, 1), NEG, dtype=i64, device=dev)
    for i in range(min(int(tlen.max()) if B else 0, LT)):
        run = ~done & (i < tlen)
        if not bool(run.any()):
            break
        qp = torch.where(qvalid, mat[col(target[:, i]) * 5 + query], 0)
        g = torch.cat([zcol, H[:, :-1]], 1) + qp
        if size == 1:
            g = g.clamp(0, sat)
        g = torch.maximum(g, E)
        cm = (g + jq * e_ins).cummax(1).values
        F = (torch.cat([negcol, cm[:, :-1]], 1) - oe_ins
             - (jq - 1) * e_ins).clamp(min=0)
        F[:, 0] = 0
        Hn = torch.where(vmask, torch.maximum(g, F), 0)
        imax = Hn.max(1).values
        En = torch.maximum(E - e_del, (Hn - oe_del).clamp(min=0))
        H = torch.where(col(run), Hn, H)
        E = torch.where(col(run), En, E)
        row_max[:, i] = torch.where(run, imax, row_max[:, i])
        improved = run & (imax > gmax)
        gmax = torch.where(improved, imax, gmax)
        te = torch.where(improved, i, te)
        Hmax = torch.where(col(improved), Hn, Hmax)
        last = torch.where(run, i, last)
        sat_brk = improved & (gmax + shift >= 255) if size == 1 \
            else torch.zeros_like(improved)
        end_brk = improved & (gmax >= endsc)
        done = done | ~run | sat_brk | end_brk
        saturated = saturated | sat_brk
    # qe: the smallest virtual column reaching max(Hmax)
    mx = Hmax.max(1).values
    qe = torch.where(Hmax >= col(mx), jq, LQV).min(1).values
    qe = torch.where(mx > -1, qe, -1)
    i32 = torch.int32
    return (gmax.to(i32), te.to(i32), qe.to(i32), saturated,
            row_max.to(i32), last.to(i32))


_ALN_LQV = (128,)   # LQV values the kernel is instantiated for


def align_cuda(query, target, qlen, tlen, mat, o_del: int, e_del: int,
               o_ins: int, e_ins: int, endsc, shift: int, size: int,
               LQV: int, LT: int):
    """Launch the local-SW kernel (csrc/align.cu bm_align2)."""
    if LQV not in _ALN_LQV or size not in (1, 2):
        raise ValueError(f"the local-SW kernel is built for LQV in "
                         f"{_ALN_LQV} and size 1 or 2, got {LQV}, {size}")
    B = query.shape[0]
    for name, x, width in (("query", query, LQV), ("target", target, LT)):
        if x.shape != (B, width) or x.dtype != torch.int8:
            raise ValueError(f"align2: {name} must be int8 ({B}, {width})")
    if bool(((qlen > LQV) | (tlen > LT)).any()):
        raise ValueError(f"align2: a query exceeds LQV={LQV} or a target "
                         f"LT={LT}")
    dev = query.device
    i32 = torch.int32
    q, t, ql, tl, es, m = (x.to(device=dev, dtype=dt).contiguous()
                           for x, dt in ((query, torch.int8),
                                         (target, torch.int8), (qlen, i32),
                                         (tlen, i32), (endsc, i32),
                                         (mat.reshape(-1), torch.int8)))
    gmax, te, qe, last = (torch.empty(B, dtype=i32, device=dev)
                          for _ in range(4))
    sat = torch.empty(B, dtype=torch.uint8, device=dev)
    row_max = torch.empty(B, LT, dtype=i32, device=dev)
    if B:
        lib = _kernels.library()
        _kernels.ALIGN2.count()
        rc = lib.bm_align2(size, LQV, LT, B, q.data_ptr(), t.data_ptr(),
                           ql.data_ptr(), tl.data_ptr(), es.data_ptr(),
                           m.data_ptr(), o_del, e_del, o_ins, e_ins, shift,
                           gmax.data_ptr(), te.data_ptr(), qe.data_ptr(),
                           sat.data_ptr(), row_max.data_ptr(),
                           last.data_ptr(), _kernels.stream_of(gmax))
        _kernels.check(rc, "align2")
    return gmax, te, qe, sat.bool(), row_max, last


def ksw_align_batched(query, target, qlen, tlen, mat, o_del: int,
                      e_del: int, o_ins: int, e_ins: int, endsc, size: int,
                      LQV: int, LT: int):
    """One ksw_u8 (size=1) / ksw_i16 (size=2) pass per lane
    (bwamem_tpu/ops/ksw_align.py ksw_align_batched): int8 bases query
    [B, LQV] / target [B, LT], per-lane qlen, tlen and endsc (0x10000 when
    unused).  Returns (gmax, te, qe, saturated bool, row_max [B, LT],
    last_row), int32 otherwise.  The kernel for CUDA tensors, the plain
    version for CPU tensors."""
    shift = -int(mat.min()) if size == 1 else 0
    fn = align_cuda if query.is_cuda else align_plain
    return fn(query, target, qlen, tlen, mat, o_del, e_del, o_ins, e_ins,
              endsc, shift, size, LQV, LT)


def align2_wave(opt, reqs, wave_width: int, mat, lq_cap: int = 128,
                lt_cap: int = 544, timed=None, count=None):
    """Serve a wave of ("align2", qs, rs, xtra) requests with batched
    ksw_align_batched passes on mat's device, in groups of at most
    wave_width lanes, and replay ksw_align2's host-side bookkeeping
    exactly.  Oversize lanes, and saturated u8 lanes that need a start
    position, go to the scalar oracle; `count(tag, n)` hears of them.
    `timed(fn)` wraps each group's fetch.  Returns one KswR per
    request."""
    from bwamem_tpu_torch.core.swdrive import serve_host
    from bwamem_tpu_torch.oracle.ksw import KswR

    n = len(reqs)
    outs = [None] * n
    max_sc = int(max(opt.mat))
    dev = mat.device
    count = count or (lambda tag, k: None)
    timed = timed or (lambda fn: fn())

    groups = {1: [], 2: []}
    n_over = 0
    for i, r in enumerate(reqs):
        _, qs, rs, xtra = r
        size = 1 if (xtra & oksw.KSW_XBYTE) else 2
        if 0 < len(qs) <= lq_cap and 0 < len(rs) <= lt_cap:
            groups[size].append(i)
        else:
            outs[i] = serve_host(r, opt)
            n_over += 1
    if n_over:
        count("wave_host_oversize_align2", n_over)

    def run_group(idxs, size, rev_info=None):
        """Batched passes over idxs; rev_info marks the reversed-prefix
        rerun (the sequences cut at the forward result, endsc = its
        score)."""
        res = {}
        pend = []   # launch every group before fetching any
        for lo in range(0, len(idxs), wave_width):
            grp = idxs[lo:lo + wave_width]
            B = len(grp)
            qb = np.full((B, lq_cap), 4, np.int8)
            tb = np.full((B, lt_cap), 4, np.int8)
            qlen = np.zeros(B, np.int32)
            tlen = np.zeros(B, np.int32)
            mins = np.full(B, 0x10000, np.int32)
            ends = np.full(B, 0x10000, np.int32)
            for bi, i in enumerate(grp):
                _, qs, rs, xtra = reqs[i]
                if rev_info is not None:
                    r0 = rev_info[i]
                    qs = qs[:r0.qe + 1][::-1]
                    rs = rs[:r0.te + 1][::-1]
                    ends[bi] = r0.score
                else:
                    if xtra & oksw.KSW_XSUBO:
                        mins[bi] = xtra & 0xFFFF
                    if xtra & oksw.KSW_XSTOP:
                        ends[bi] = xtra & 0xFFFF
                qb[bi, :len(qs)] = qs
                tb[bi, :len(rs)] = rs
                qlen[bi], tlen[bi] = len(qs), len(rs)
            t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            out = ksw_align_batched(
                t(qb), t(tb), t(qlen), t(tlen), mat, opt.o_del, opt.e_del,
                opt.o_ins, opt.e_ins, t(ends), size=size, LQV=lq_cap,
                LT=lt_cap)
            pend.append((grp, out, mins))
        for grp, out, mins in pend:
            gmax, te, qe, satu, row_max, last = timed(
                lambda out=out: [x.cpu().numpy() for x in out])
            for bi, i in enumerate(grp):
                res[i] = (int(gmax[bi]), int(te[bi]), int(qe[bi]),
                          bool(satu[bi]), row_max[bi], int(last[bi]),
                          int(mins[bi]))
        return res

    fwd = {}
    for size in (1, 2):
        if groups[size]:
            fwd.update(run_group(groups[size], size))

    results = {}
    need_rev = {1: [], 2: []}
    n_sat = 0
    for i, vals in fwd.items():
        _, qs, rs, xtra = reqs[i]
        gmax, te, qe, satu, row_max, last, minsc = vals
        size = 1 if (xtra & oksw.KSW_XBYTE) else 2
        r = KswR()
        r.score = 255 if (size == 1 and satu) else gmax
        r.te = te
        if size != 1 or r.score != 255:
            r.qe = qe
            # replay the b-list (software/ksw.c:180-186,335-341)
            b = []
            for row in range(last + 1):
                imax = int(row_max[row])
                if imax >= minsc:
                    if not b or b[-1][1] + 1 != row:
                        b.append((imax, row))
                    elif b[-1][0] < imax:
                        b[-1] = (imax, row)
            if b:
                ii = (r.score + max_sc - 1) // max_sc
                low, high = te - ii, te + ii
                for rm, e_row in b:
                    if (e_row < low or e_row > high) and rm > r.score2:
                        r.score2, r.te2 = rm, e_row
        results[i] = r
        if (xtra & oksw.KSW_XSTART) and not (
                (xtra & oksw.KSW_XSUBO) and r.score < (xtra & 0xFFFF)):
            if size == 1 and r.score == 255:
                # saturated: no start position from the u8 pass
                outs[i] = serve_host(reqs[i], opt)
                results.pop(i)
                n_sat += 1
            else:
                need_rev[size].append(i)
    if n_sat:
        count("wave_host_saturated_align2", n_sat)

    rev = {}
    for size in (1, 2):
        if need_rev[size]:
            rev.update(run_group(need_rev[size], size, rev_info=results))
    for i, vals in rev.items():
        gmax, te, qe, satu = vals[:4]
        r = results[i]
        rr_score = 255 if ((reqs[i][3] & oksw.KSW_XBYTE) and satu) else gmax
        if r.score == rr_score:
            r.tb = r.te - te
            r.qb = r.qe - qe

    for i, r in results.items():
        if outs[i] is None:
            outs[i] = r
    return outs
