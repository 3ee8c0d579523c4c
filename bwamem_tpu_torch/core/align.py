"""Final alignment: CIGAR + NM/MD generation and region -> mem_aln_t.

Transcribed from:
  infer_bw        software/bwamem.c:1194-1201
  bwa_gen_cigar2  software/bwa.c:96-179 (global realign + NM/MD; the
                  reverse-strand double reversal places indels leftmost)
  bwa_fix_xref2   software/bwa.c:186-229 (clamp a region crossing a
                  contig boundary)
  mem_reg2aln     software/bwamem.c:1481-1553
"""

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..index.bntseq import get_seq
from ..oracle.ksw import ksw_global2
from .region import AlnReg, approx_mapq_se

INT2BASE_F = "ACGTN"
INT2BASE_R = "TGCAN"


@dataclass
class MemAln:
    """mem_aln_t (software/bwamem.h:84-93)."""
    pos: int = 0
    rid: int = -1
    flag: int = 0
    is_rev: int = 0
    mapq: int = 0
    NM: int = 0
    cigar: List[int] = field(default_factory=list)  # len<<4|op, MIDSH=01234
    MD: str = ""
    score: int = 0
    sub: int = 0


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    if l1 == l2 and l1 * a - score < (q + r - a) * 2:
        return 0
    w = int(float((min(l1, l2)) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def gen_cigar(mat, o_del, e_del, o_ins, e_ins, w_, l_pac, pac,
              query: np.ndarray, rb: int, re: int
              ) -> Tuple[Optional[List[int]], str, int, int]:
    """bwa_gen_cigar2 driven by the host-oracle global SW."""
    return drive_cigar_gen(gen_cigar_gen(
        mat, o_del, e_del, o_ins, e_ins, w_, l_pac, pac, query, rb, re),
        mat, o_del, e_del, o_ins, e_ins)


def drive_cigar_gen(gen, mat, o_del, e_del, o_ins, e_ins):
    """Serve ('global2', q, rseq, w) requests with the scalar oracle;
    returns the generator's return value."""
    try:
        req = next(gen)
        while True:
            _tag, q, rseq, w = req
            out = ksw_global2(q, rseq, np.asarray(mat, dtype=np.int64),
                              o_del, e_del, o_ins, e_ins, w)
            req = gen.send(out)
    except StopIteration as e:
        return e.value


def gen_cigar_gen(mat, o_del, e_del, o_ins, e_ins, w_, l_pac, pac,
                  query: np.ndarray, rb: int, re: int, trace=None):
    """bwa_gen_cigar2 as a generator (software/bwa.c:96-179): the banded
    global alignment is yielded as ('global2', q, rseq, w) and
    (score, cigar) sent back, so a batching driver can run one device
    dispatch per wave.  query is the nt4 slice being aligned (NOT
    modified; reversal on copies).  Returns (cigar, MD, score, NM);
    cigar None when rejected.  `trace` collects the bwa_verbose>=4
    lines (software/bwa.c:134-138)."""
    l_query = len(query)
    if l_query <= 0 or rb >= re or (rb < l_pac < re):
        return None, "", 0, -1
    rseq = get_seq(l_pac, pac, rb, re)
    if re - rb != len(rseq):
        return None, "", 0, -1
    q = query
    if rb >= l_pac:  # reverse both for leftmost indel placement
        q = query[::-1].copy()
        rseq = rseq[::-1].copy()
    if l_query == re - rb and w_ == 0:
        cigar = [l_query << 4 | 0]
        mat_a = np.asarray(mat, dtype=np.int64)
        score = int(mat_a[rseq.astype(np.int64) * 5
                          + q.astype(np.int64)].sum())
    else:
        max_ins = int(float(((l_query + 1) >> 1) * mat[0] - o_ins) / e_ins + 1.0)
        max_del = int(float(((l_query + 1) >> 1) * mat[0] - o_del) / e_del + 1.0)
        max_gap = max(max_ins, max_del, 1)
        w = (max_gap + abs((re - rb) - l_query) + 1) >> 1
        w = min(w, w_)
        min_w = abs((re - rb) - l_query) + 3
        w = max(w, min_w)
        if trace is not None:
            trace.append("* Global bandwidth: %d\n" % w)
            trace.append("* Global ref:   %s\n"
                         % "".join(INT2BASE_F[b] for b in rseq))
            trace.append("* Global query: %s\n"
                         % "".join(INT2BASE_F[b] for b in q))
        score, cigar = yield ("global2", q, rseq, w)
    # NM and MD (mismatch positions found vectorized per match run —
    # the per-base Python walk dominated finalize time at ~100
    # iterations per read)
    base_tab = INT2BASE_F if rb < l_pac else INT2BASE_R
    md = []
    x = y = u = n_mm = n_gap = 0
    n_cigar = len(cigar)
    for k_i, cg in enumerate(cigar):
        op, ln = cg & 0xF, cg >> 4
        if op == 0:  # match
            mis = np.nonzero(q[x:x + ln] != rseq[y:y + ln])[0]
            prev = -1
            for i in mis:
                md.append(str(u + int(i) - prev - 1))
                md.append(base_tab[rseq[y + int(i)]])
                u = 0
                prev = int(i)
            u += ln - 1 - prev
            n_mm += len(mis)
            x += ln
            y += ln
        elif op == 2:  # deletion
            if 0 < k_i < n_cigar - 1:
                md.append(str(u))
                md.append("^")
                for i in range(ln):
                    md.append(base_tab[rseq[y + i]])
                u = 0
                n_gap += ln
            y += ln
        elif op == 1:  # insertion
            x += ln
            n_gap += ln
    md.append(str(u))
    return cigar, "".join(md), score, n_mm + n_gap


def fix_xref_gen(opt, bns, pac, query: np.ndarray, qb: int, qe: int,
                 rb: int, re: int, trace=None):
    """bwa_fix_xref2 as a generator: returns (status, qb, qe, rb, re)."""
    if rb < bns.l_pac < re:
        return -1, -1, -1, -1, -1
    fm_pos, is_rev = bns.depos((rb + re) >> 1)
    ra = bns.anns[bns.pos2rid(fm_pos)]
    cb = ((bns.l_pac << 1) - (ra.offset + ra.length)) if is_rev else ra.offset
    ce = cb + ra.length
    if cb > rb or ce < re:
        cb = max(cb, rb)
        ce = min(ce, re)
        cigar, _md, _sc, _nm = yield from gen_cigar_gen(
            opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w,
            bns.l_pac, pac, query[qb:qe], rb, re, trace)
        x, y = rb, qb
        for cg in cigar or []:
            op, ln = cg & 0xF, cg >> 4
            if op == 0:
                if x <= cb < x + ln:
                    qb = y + (cb - x)
                    rb = cb
                if x < ce <= x + ln:
                    qe = y + (ce - x)
                    re = ce
                    break
                x += ln
                y += ln
            elif op == 1:
                y += ln
            elif op == 2:
                if x <= cb < x + ln:
                    qb = y
                    rb = x + ln
                if x < ce <= x + ln:
                    qe = y
                    re = x
                    break
                x += ln
            else:
                raise AssertionError("unexpected cigar op in fix_xref")
    status = -2 if (qb == qe or rb == re) else 0
    return status, qb, qe, rb, re


def reg2aln(opt, bns, pac, l_query: int, query_nt4: np.ndarray,
            ar: Optional[AlnReg]) -> MemAln:
    """mem_reg2aln driven by the host-oracle global SW."""
    return drive_cigar_gen(
        reg2aln_gen(opt, bns, pac, l_query, query_nt4, ar),
        opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)


def reg2aln_gen(opt, bns, pac, l_query: int, query_nt4: np.ndarray,
                ar: Optional[AlnReg], trace=None):
    """mem_reg2aln (software/bwamem.c:1481-1553) as a generator.
    `trace` collects the bwa_verbose>=4 lines (:1507,:1514)."""
    a = MemAln()
    if ar is None or ar.rb < 0 or ar.re < 0:
        a.rid = -1
        a.pos = -1
        a.flag |= 0x4
        return a
    qb, qe = ar.qb, ar.qe
    rb, re = ar.rb, ar.re
    query = query_nt4
    a.mapq = approx_mapq_se(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    st, qb, qe, rb, re = yield from fix_xref_gen(opt, bns, pac, query,
                                                 qb, qe, rb, re, trace)
    if st < 0:
        raise RuntimeError("mem_reg2aln: unfixable cross-contig alignment")
    tmp = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del)
    w2 = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins)
    w2 = max(w2, tmp)
    if trace is not None:
        trace.append("* Band width: inferred=%d, cmd_opt=%d, alnreg=%d\n"
                     % (w2, opt.w, ar.w))
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    i = 0
    last_sc = -(1 << 30)
    cigar: List[int] = []
    md = ""
    NM = -1
    while True:
        cigar, md, score, NM = yield from gen_cigar_gen(
            opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w2,
            bns.l_pac, pac, query[qb:qe], rb, re, trace)
        if trace is not None:
            trace.append("* Final alignment: w2=%d, global_sc=%d, "
                         "local_sc=%d\n" % (w2, score, ar.truesc))
        if score == last_sc:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if not (i < 3 and score < ar.truesc - opt.a):
            break
    a.NM = NM
    pos, is_rev = bns.depos(rb if rb < bns.l_pac else re - 1)
    a.is_rev = int(is_rev)
    cigar = list(cigar or [])
    if len(cigar) > 0:  # squeeze out leading/trailing deletions
        if (cigar[0] & 0xF) == 2:
            pos += cigar[0] >> 4
            cigar = cigar[1:]
        elif (cigar[-1] & 0xF) == 2:
            cigar = cigar[:-1]
    if qb != 0 or qe != l_query:  # soft clipping
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            cigar = [clip5 << 4 | 3] + cigar
        if clip3:
            cigar = cigar + [clip3 << 4 | 3]
    a.cigar = cigar
    a.MD = md
    a.rid = bns.pos2rid(pos)
    a.pos = pos - bns.anns[a.rid].offset
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    return a


def get_rlen(cigar: List[int]) -> int:
    l = 0
    for cg in cigar:
        op = cg & 0xF
        if op == 0 or op == 2:
            l += cg >> 4
    return l
