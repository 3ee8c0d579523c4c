"""Generator request protocol for the Smith-Waterman stages.

Pipeline stages that need SW are written as generators yielding typed
requests; a driver serves each request and sends the result back.  The
host driver (here) serves them with the scalar oracles — the
CPU-fallback role.  The device driver
(bwamem_tpu.ops.engine.JaxSeedingEngine.drive_waves) advances many
reads' generators in lock-step and serves each wave of same-typed
requests with ONE batched device dispatch — the reference's
batch-dispatch structure (software/bwt.c:558-757) applied to every SW
call site.

Request forms:
  ("extend2", q, rseq, w, end_bonus, h0) -> (score, qle, tle, gtle,
                                             gscore, max_off)
  ("global2", q, rseq, w)                -> (score, cigar)
  ("extend_lr", qs, rs, qrt, rrt, sc_seed, s_qbeg, s_rbeg, rmax0,
   l_query, s_len) -> (score, truesc, qb, rb, qe, re, aw0, aw1)
    — one seed's ENTIRE left+right extension including the x2
    band-doubling retries (software/bwamem.c:1120-1176), fused so a
    batching driver pays one dispatch round trip per seed instead of
    up to four.
"""

import numpy as np

from ..oracle import ksw as oksw

MAX_BAND_TRY = 2  # bwamem.c:38


def extend_seed_lr(opt, serve, qs, rs, qrt, rrt, sc_seed, s_qbeg,
                   s_rbeg, rmax0, l_query, s_len):
    """The C logic around one seed's ksw_extend2 calls
    (software/bwamem.c:1120-1176), with the extension itself abstracted
    behind `serve(q, t, w, end_bonus, h0)` — the host oracle here; the
    device kernel (ops.ksw.ksw_extend_lr_batched) implements the same
    decisions vectorized.  Returns (score, truesc, qb, rb, qe, re,
    aw0, aw1)."""
    score = truesc = -1
    aw0 = aw1 = opt.w
    if len(qs):  # left
        qle = tle = gtle = 0
        gscore = 0
        for i in range(MAX_BAND_TRY):
            prev = score
            aw0 = opt.w << i
            (score, qle, tle, gtle, gscore,
             max_off0) = serve(qs, rs, aw0, opt.pen_clip5, sc_seed)
            if score == prev or max_off0 < (aw0 >> 1) + (aw0 >> 2):
                break
        if gscore <= 0 or gscore <= score - opt.pen_clip5:
            qb, rb, truesc = s_qbeg - qle, s_rbeg - tle, score
        else:
            qb, rb, truesc = 0, s_rbeg - gtle, gscore
    else:
        score = truesc = sc_seed
        qb, rb = 0, s_rbeg
    if len(qrt):  # right
        sc0 = score
        qe0 = l_query - len(qrt)
        qle = tle = gtle = 0
        gscore = 0
        for i in range(MAX_BAND_TRY):
            prev = score
            aw1 = opt.w << i
            (score, qle, tle, gtle, gscore,
             max_off1) = serve(qrt, rrt, aw1, opt.pen_clip3, sc0)
            if score == prev or max_off1 < (aw1 >> 1) + (aw1 >> 2):
                break
        re0 = s_rbeg + s_len - rmax0
        if gscore <= 0 or gscore <= score - opt.pen_clip3:
            qe, re = qe0 + qle, rmax0 + re0 + tle
            truesc += score - sc0
        else:
            qe, re = l_query, rmax0 + re0 + gtle
            truesc += gscore - sc0
    else:
        qe, re = l_query, s_rbeg + s_len
    return score, truesc, qb, rb, qe, re, aw0, aw1


def serve_host(req, opt):
    """Serve one SW request with the scalar host oracle."""
    tag = req[0]
    mat = np.asarray(opt.mat, dtype=np.int64)
    if tag == "extend2":
        _, qs, rs, w, pen, h0 = req
        return oksw.ksw_extend2(qs, rs, mat, opt.o_del, opt.e_del,
                                opt.o_ins, opt.e_ins, w, pen,
                                opt.zdrop, h0)
    if tag == "extend_lr":
        (_, qs, rs, qrt, rrt, sc_seed, s_qbeg, s_rbeg, rmax0,
         l_query, s_len) = req

        def serve(q, t, w, pen, h0):
            return oksw.ksw_extend2(q, t, mat, opt.o_del, opt.e_del,
                                    opt.o_ins, opt.e_ins, w, pen,
                                    opt.zdrop, h0)
        return extend_seed_lr(opt, serve, qs, rs, qrt, rrt, sc_seed,
                              s_qbeg, s_rbeg, rmax0, l_query, s_len)
    if tag == "global2":
        _, qs, rs, w = req
        return oksw.ksw_global2(qs, rs, mat, opt.o_del, opt.e_del,
                                opt.o_ins, opt.e_ins, w)
    if tag == "align2":
        _, qs, rs, xtra = req
        return oksw.ksw_align2(qs, rs, mat, opt.o_del, opt.e_del,
                               opt.o_ins, opt.e_ins, xtra)
    raise ValueError(f"unknown SW request tag {tag!r}")


def drive_host(gen, opt):
    """Run a generator to completion serving every request on the host;
    returns the generator's return value."""
    try:
        req = next(gen)
        while True:
            req = gen.send(serve_host(req, opt))
    except StopIteration as e:
        return e.value
