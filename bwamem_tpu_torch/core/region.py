"""Alignment regions: chain extension, dedup, primary marking, MAPQ.

Transcribed from software/bwamem.c:
  mem_chain2aln_short  whole-chain local-SW fast path     (:805-852)
  mem_chain2aln        seed-sorted left/right extension   (:1040-1188)
  mem_sort_and_dedup   overlap dedup                      (:705-746)
  mem_test_and_remove_exact                               (:748-753)
  mem_mark_primary_se  secondary marking                  (:755-785)
  mem_approx_mapq_se   approximate single-end MAPQ        (:1333-1356)

All floating point goes through Python floats (C doubles) to keep MAPQ
and filter decisions bit-identical.
"""

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from ..index.bntseq import get_seq
from ..oracle import ksw
from ..utils.hashing import hash_64
from ..utils.ksort import ks_introsort

MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
MAX_BAND_TRY = 2


@dataclass
class AlnReg:
    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    score: int = 0
    truesc: int = 0
    sub: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    hash: int = 0


def cal_max_gap(opt, qlen: int) -> int:
    l_del = int(float(qlen * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = int(float(qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    l = max(l_del, l_ins, 1)
    return min(l, opt.w * 2)


def chain2aln_short(opt, l_pac: int, pac, query: np.ndarray, c,
                    trace=None) -> object:
    """mem_chain2aln_short.  Returns an AlnReg on success, 1 if the
    general path must run, -1 on empty chain (C's return codes).
    `trace` collects the bwa_verbose>=4 lines (software/bwamem.c:850)."""
    if c.n == 0:
        return -1
    l_query = len(query)
    qb, qe = l_query, 0
    rb, re = l_pac << 1, 0
    seedcov = 0
    for s_rbeg, s_qbeg, s_len in c.seeds:
        qb = min(qb, s_qbeg)
        qe = max(qe, s_qbeg + s_len)
        rb = min(rb, s_rbeg)
        re = max(re, s_rbeg + s_len)
        seedcov += s_len
    qb -= MEM_SHORT_EXT
    qe += MEM_SHORT_EXT
    if qb <= 10 or qe >= l_query - 10:
        return 1
    rb -= MEM_SHORT_EXT
    re += MEM_SHORT_EXT
    rb = max(rb, 0)
    re = min(re, l_pac << 1)
    if rb < l_pac < re:
        if c.seeds[0][0] < l_pac:
            re = l_pac
        else:
            rb = l_pac
    if ((re - rb) - (qe - qb) > MEM_SHORT_EXT
            or (qe - qb) - (re - rb) > MEM_SHORT_EXT):
        return 1
    if qe - qb >= opt.w * 4 or re - rb >= opt.w * 4:
        return 1
    if qe - qb >= MEM_SHORT_LEN or re - rb >= MEM_SHORT_LEN:
        return 1

    rseq = get_seq(l_pac, pac, rb, re)
    assert len(rseq) == re - rb
    xtra = (ksw.KSW_XSUBO | ksw.KSW_XSTART
            | (ksw.KSW_XBYTE if (qe - qb) * opt.a < 250 else 0)
            | (opt.min_seed_len * opt.a))
    mat = np.asarray(opt.mat, dtype=np.int64)
    x = ksw.ksw_align2(query[qb:qe], rseq, mat, opt.o_del, opt.e_del,
                       opt.o_ins, opt.e_ins, xtra)
    if x.tb < MEM_SHORT_EXT >> 1 or x.te > re - rb - (MEM_SHORT_EXT >> 1):
        return 1
    a = AlnReg()
    a.seedcov = seedcov
    a.rb = rb + x.tb
    a.re = rb + x.te + 1
    a.qb = qb + x.qb
    a.qe = qb + x.qe + 1
    a.score = x.score
    a.csub = x.score2
    if trace is not None:
        trace.append("** Added alignment region via mem_chain2aln_short():"
                     " [%d,%d) <=> [%d,%d)\n" % (a.qb, a.qe, a.rb, a.re))
    return a


def chain2aln(opt, l_pac: int, pac, query: np.ndarray, c, av: List[AlnReg]):
    """mem_chain2aln driven by the host-oracle SW (single-read path)."""
    drive_extension_gen(chain2aln_gen(opt, l_pac, pac, query, c, av), opt)


def drive_extension_gen(gen, opt):
    """Serve an extension generator's requests with the scalar host
    oracle (the reference's CPU-fallback role); returns the generator's
    return value."""
    from .swdrive import serve_host
    try:
        req = next(gen)
        while True:
            req = gen.send(serve_host(req, opt))
    except StopIteration as e:
        return e.value


_NT5 = "ACGTN"


def chain_rmax_rseq(opt, l_pac: int, pac, query: np.ndarray, c):
    """The chain's reference window and fetched sequence
    (software/bwamem.c:1052-1066) — shared by chain2aln_gen and the
    speculative extension prefetch (ops.engine); memoized on the chain
    (the prefetch and the serial path would otherwise each pay the
    window scan + pac fetch)."""
    cached = getattr(c, "_rmax_rseq", None)
    if cached is not None:
        return cached
    l_query = len(query)
    rmax0, rmax1 = l_pac << 1, 0
    for t_rbeg, t_qbeg, t_len in c.seeds:
        b = t_rbeg - (t_qbeg + cal_max_gap(opt, t_qbeg))
        e = (t_rbeg + t_len
             + (l_query - t_qbeg - t_len)
             + cal_max_gap(opt, l_query - t_qbeg - t_len))
        rmax0 = min(rmax0, b)
        rmax1 = max(rmax1, e)
    rmax0 = max(rmax0, 0)
    rmax1 = min(rmax1, l_pac << 1)
    if rmax0 < l_pac < rmax1:
        if c.seeds[0][0] < l_pac:
            rmax1 = l_pac
        else:
            rmax0 = l_pac
    rseq = get_seq(l_pac, pac, rmax0, rmax1)
    assert len(rseq) == rmax1 - rmax0
    c._rmax_rseq = (rmax0, rmax1, rseq)
    return c._rmax_rseq


def seed_lr_request(opt, query: np.ndarray, rmax0: int, rseq: np.ndarray,
                    seed):
    """Build the fused ("extend_lr", ...) request for one seed (the
    slicing of software/bwamem.c:1121-1160); MUST stay identical
    between chain2aln_gen and the speculative prefetch."""
    s_rbeg, s_qbeg, s_len = seed
    l_query = len(query)
    if s_qbeg:
        qs = query[s_qbeg - 1::-1].copy()
        tmp = s_rbeg - rmax0
        rs = rseq[tmp - 1::-1].copy() if tmp > 0 else rseq[:0]
    else:
        qs = query[:0]
        rs = rseq[:0]
    if s_qbeg + s_len != l_query:
        qe = s_qbeg + s_len
        re = s_rbeg + s_len - rmax0
        assert re >= 0
        qrt, rrt = query[qe:], rseq[re:]
    else:
        qrt, rrt = query[:0], rseq[:0]
    return ("extend_lr", qs, rs, qrt, rrt, s_len * opt.a, s_qbeg,
            s_rbeg, rmax0, l_query, s_len)


def chain2aln_gen(opt, l_pac: int, pac, query: np.ndarray, c,
                  av: List[AlnReg], trace=None):
    """mem_chain2aln as a generator: extend each seed (longest first)
    unless contained in an existing region (software/bwamem.c:1040-1188).
    Each banded-extension call is yielded as
    ("extend2", query_slice, target_slice, band, end_bonus, h0) and its
    (score, qle, tle, gtle, gscore, max_off) tuple sent back — so a
    batching driver can run one device dispatch per wave of live reads
    (the reference's batch-dispatch idea applied to the SW stage)."""
    if c.n == 0:
        return
    l_query = len(query)
    rmax0, rmax1, rseq = chain_rmax_rseq(opt, l_pac, pac, query, c)

    srt = sorted((c.seeds[i][2] << 32) | i for i in range(c.n))
    srt_alive = list(srt)

    for k in range(c.n - 1, -1, -1):
        s_rbeg, s_qbeg, s_len = c.seeds[srt_alive[k] & 0xFFFFFFFF]

        # skip seeds contained in an existing region (bwamem.c:1079-1112)
        hit = -1
        for i, p in enumerate(av):
            if (s_rbeg < p.rb or s_rbeg + s_len > p.re
                    or s_qbeg < p.qb or s_qbeg + s_len > p.qe):
                continue
            qd, rd = s_qbeg - p.qb, s_rbeg - p.rb
            w = min(cal_max_gap(opt, min(qd, rd)), opt.w)
            if qd - rd < w and rd - qd < w:
                hit = i
                break
            qd = p.qe - (s_qbeg + s_len)
            rd = p.re - (s_rbeg + s_len)
            w = min(cal_max_gap(opt, min(qd, rd)), opt.w)
            if qd - rd < w and rd - qd < w:
                hit = i
                break
        if hit >= 0:
            if trace is not None:
                trace.append(
                    "** Seed(%d) [%d;%d,%d] is almost contained in an "
                    "existing alignment. Confirming whether extension is "
                    "needed...\n" % (k, s_len, s_qbeg, s_rbeg))
            # confirm no overlapping seed would produce a different aln
            i = k + 1
            while i < c.n:
                if srt_alive[i] == 0:
                    i += 1
                    continue
                t_rbeg, t_qbeg, t_len = c.seeds[srt_alive[i] & 0xFFFFFFFF]
                if t_len < s_len * .95:
                    i += 1
                    continue
                if (s_qbeg <= t_qbeg and s_qbeg + s_len - t_qbeg >= s_len >> 2
                        and t_qbeg - s_qbeg != t_rbeg - s_rbeg):
                    break
                if (t_qbeg <= s_qbeg and t_qbeg + t_len - s_qbeg >= s_len >> 2
                        and s_qbeg - t_qbeg != s_rbeg - t_rbeg):
                    break
                i += 1
            if i == c.n:
                srt_alive[k] = 0  # mark extension not performed
                continue
            if trace is not None:
                trace.append(
                    "** Seed(%d) might lead to a different alignment even "
                    "though it is contained. Extension will be performed."
                    "\n" % k)

        a = AlnReg()
        a.w = aw0 = aw1 = opt.w
        a.score = a.truesc = -1
        if trace is not None:  # err_printf (bwamem.c:1119)
            trace.err("** ---> Extending from seed(%d) [%d;%d,%d] <---\n"
                      % (k, s_len, s_qbeg, s_rbeg))

        if trace is None:
            # fused request: the whole left+right extension incl. band
            # -doubling retries in ONE wave (swdrive.extend_seed_lr /
            # ops.ksw.ksw_extend_lr_batched) — 4x fewer dispatch round
            # trips than per-call waves.  The traced path below keeps
            # per-attempt granularity for the -v4 lines.
            (a.score, a.truesc, a.qb, a.rb, a.qe, a.re, aw0,
             aw1) = yield seed_lr_request(
                 opt, query, rmax0, rseq, (s_rbeg, s_qbeg, s_len))
            a.seedcov = 0
            for t_rbeg, t_qbeg, t_len in c.seeds:
                if (t_qbeg >= a.qb and t_qbeg + t_len <= a.qe
                        and t_rbeg >= a.rb and t_rbeg + t_len <= a.re):
                    a.seedcov += t_len
            a.w = max(aw0, aw1)
            av.append(a)
            continue

        gscore = 0
        if s_qbeg:  # left extension
            qs = query[s_qbeg - 1::-1].copy()
            tmp = s_rbeg - rmax0
            rs = rseq[tmp - 1::-1].copy() if tmp > 0 else rseq[:0]
            qle = tle = gtle = 0
            for i in range(MAX_BAND_TRY):
                prev = a.score
                aw0 = opt.w << i
                if trace is not None:
                    trace.append("*** Left ref:   %s\n*** Left query: %s\n"
                                 % ("".join(_NT5[b] for b in rs),
                                    "".join(_NT5[b] for b in qs)))
                (a.score, qle, tle, gtle, gscore,
                 max_off0) = yield ("extend2", qs, rs, aw0,
                                    opt.pen_clip5, s_len * opt.a)
                if trace is not None:
                    trace.append("*** Left extension: prev_score=%d; "
                                 "score=%d; bandwidth=%d; "
                                 "max_off_diagonal_dist=%d\n"
                                 % (prev, a.score, aw0, max_off0))
                if a.score == prev or max_off0 < (aw0 >> 1) + (aw0 >> 2):
                    break
            if gscore <= 0 or gscore <= a.score - opt.pen_clip5:
                a.qb = s_qbeg - qle
                a.rb = s_rbeg - tle
                a.truesc = a.score
            else:
                a.qb = 0
                a.rb = s_rbeg - gtle
                a.truesc = gscore
        else:
            a.score = a.truesc = s_len * opt.a
            a.qb = 0
            a.rb = s_rbeg

        if s_qbeg + s_len != l_query:  # right extension
            sc0 = a.score
            qe = s_qbeg + s_len
            re = s_rbeg + s_len - rmax0
            assert re >= 0
            qle = tle = gtle = 0
            gscore = 0
            for i in range(MAX_BAND_TRY):
                prev = a.score
                aw1 = opt.w << i
                if trace is not None:
                    trace.append("*** Right ref:   %s\n*** Right query: %s\n"
                                 % ("".join(_NT5[b] for b in rseq[re:]),
                                    "".join(_NT5[b] for b in query[qe:])))
                (a.score, qle, tle, gtle, gscore,
                 max_off1) = yield ("extend2", query[qe:], rseq[re:], aw1,
                                    opt.pen_clip3, sc0)
                if trace is not None:
                    trace.append("*** Right extension: prev_score=%d; "
                                 "score=%d; bandwidth=%d; "
                                 "max_off_diagonal_dist=%d\n"
                                 % (prev, a.score, aw1, max_off1))
                if a.score == prev or max_off1 < (aw1 >> 1) + (aw1 >> 2):
                    break
            if gscore <= 0 or gscore <= a.score - opt.pen_clip3:
                a.qe = qe + qle
                a.re = rmax0 + re + tle
                a.truesc += a.score - sc0
            else:
                a.qe = l_query
                a.re = rmax0 + re + gtle
                a.truesc += gscore - sc0
        else:
            a.qe = l_query
            a.re = s_rbeg + s_len

        if trace is not None:
            trace.append("*** Added alignment region: [%d,%d) <=> [%d,%d); "
                         "score=%d; {left,right}_bandwidth={%d,%d}\n"
                         % (a.qb, a.qe, a.rb, a.re, a.score, aw0, aw1))
        a.seedcov = 0
        for t_rbeg, t_qbeg, t_len in c.seeds:
            if (t_qbeg >= a.qb and t_qbeg + t_len <= a.qe
                    and t_rbeg >= a.rb and t_rbeg + t_len <= a.re):
                a.seedcov += t_len
        a.w = max(aw0, aw1)
        av.append(a)


def sort_and_dedup(regs: List[AlnReg], mask_level_redun: float) -> List[AlnReg]:
    """mem_sort_and_dedup (software/bwamem.c:705-746)."""
    n = len(regs)
    if n <= 1:
        return regs
    ks_introsort(regs, lambda a, b: a.re < b.re)  # mem_ars2
    for i in range(1, len(regs)):
        p = regs[i]
        if p.rb >= regs[i - 1].re:
            continue
        j = i - 1
        while j >= 0 and p.rb < regs[j].re:
            q = regs[j]
            j -= 1
            if q.qe == q.qb:
                continue  # already excluded
            o_r = q.re - p.rb
            o_q = (q.qe - p.qb) if q.qb < p.qb else (p.qe - q.qb)
            m_r = min(q.re - q.rb, p.re - p.rb)
            m_q = min(q.qe - q.qb, p.qe - p.qb)
            if o_r > mask_level_redun * m_r and o_q > mask_level_redun * m_q:
                if p.score < q.score:
                    p.qe = p.qb
                    break
                q.qe = q.qb
    regs = [r for r in regs if r.qe > r.qb]
    # mem_ars: score desc, then rb, then qb
    ks_introsort(regs, lambda a, b: (a.score > b.score
                                     or (a.score == b.score
                                         and (a.rb < b.rb
                                              or (a.rb == b.rb and a.qb < b.qb)))))
    for i in range(1, len(regs)):
        if (regs[i].score == regs[i - 1].score
                and regs[i].rb == regs[i - 1].rb
                and regs[i].qb == regs[i - 1].qb):
            regs[i].qe = regs[i].qb
    out = regs[:1]
    out += [r for r in regs[1:] if r.qe > r.qb]
    return out


def test_and_remove_exact(opt, regs: List[AlnReg], qlen: int) -> List[AlnReg]:
    from ..config import MEM_F_NO_EXACT
    if not (opt.flag & MEM_F_NO_EXACT) or not regs \
            or regs[0].truesc != qlen * opt.a:
        return regs
    return regs[1:]


def mark_primary(opt, regs: List[AlnReg], rid: int) -> None:
    """mem_mark_primary_se; `rid` is the deterministic global read ordinal
    used for hash tie-breaks (software/bwamem.c:755-785)."""
    if not regs:
        return
    for i, r in enumerate(regs):
        r.sub = 0
        r.secondary = -1
        r.hash = hash_64((rid + i) & ((1 << 64) - 1))
    ks_introsort(regs, lambda a, b: (a.score > b.score
                                     or (a.score == b.score and a.hash < b.hash)))
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z = [0]
    for i in range(1, len(regs)):
        k = 0
        while k < len(z):
            j = z[k]
            b_max = max(regs[j].qb, regs[i].qb)
            e_min = min(regs[j].qe, regs[i].qe)
            if e_min > b_max:  # overlap
                min_l = min(regs[i].qe - regs[i].qb, regs[j].qe - regs[j].qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if regs[j].sub == 0:
                        regs[j].sub = regs[i].score
                    if regs[j].score - regs[i].score <= tmp:
                        regs[j].sub_n += 1
                    break
            k += 1
        if k == len(z):
            z.append(i)
        else:
            regs[i].secondary = z[k]


def approx_mapq_se(opt, a: AlnReg) -> int:
    """mem_approx_mapq_se (software/bwamem.c:1333-1356)."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(a.csub, sub)
    if sub >= a.score:
        return 0
    length = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - float(length * opt.a - a.score) / (opt.a + opt.b) / length
    if a.score == 0:
        mapq = 0
    elif opt.mapQ_coef_len > 0:
        tmp = 1.0 if length < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(length)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + .499)
    else:
        mapq = int(30.0 * (1.0 - float(sub) / a.score) * math.log(a.seedcov) + .499)
        if identity < 0.95:
            mapq = int(mapq * identity * identity + .499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + .499)
    if mapq > 60:
        mapq = 60
    if mapq < 0:
        mapq = 0
    return mapq
