"""Paired-end resolution (software/bwamem_pair.c, whole file).

  mem_pestat  insert-size distribution per FF/FR/RF/RR orientation via
              percentile fences                         (:46-107)
  mem_matesw  rescue a mate by local SW inside the insert window (:109-175)
  mem_pair    best proper pair by sorted-position scan  (:177-236)
  mem_sam_pe  pair finalization: rescue, pairing-vs-unpaired score,
              q_pe/q_se MAPQ reconciliation, 0x40/0x80 flags (:240-332)

The pairing score uses erfc/log in C doubles — Python floats match.
"""

import math
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..config import MEM_F_NO_RESCUE, MEM_F_NOPAIRING
from ..index.bntseq import get_seq
from ..oracle import ksw
from ..utils.hashing import hash_64
from .region import AlnReg, sort_and_dedup, mark_primary, approx_mapq_se
from .align import reg2aln_gen
from .sam import aln2sam

MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0
M_SQRT1_2 = 0.7071067811865476  # 1/sqrt(2)


@dataclass
class PeStat:
    low: int = 0
    high: int = 0
    failed: int = 0
    avg: float = 0.0
    std: float = 0.0


def infer_dir(l_pac: int, b1: int, b2: int):
    """mem_infer_dir: orientation in {0:FF,1:FR,2:RF,3:RR} and distance."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist


def _cal_sub(opt, r: List[AlnReg]) -> int:
    for j in range(1, len(r)):
        b_max = max(r[j].qb, r[0].qb)
        e_min = min(r[j].qe, r[0].qe)
        if e_min > b_max:
            min_l = min(r[j].qe - r[j].qb, r[0].qe - r[0].qb)
            if e_min - b_max >= min_l * opt.mask_level:
                return r[j].score
    return opt.min_seed_len * opt.a


def pestat(opt, l_pac: int, regs: List[List[AlnReg]],
           verbose: int = 3) -> List[PeStat]:
    """mem_pestat over a whole chunk of interleaved pairs."""
    pes = [PeStat() for _ in range(4)]
    isize = [[], [], [], []]
    n = len(regs)
    for i in range(n >> 1):
        r0, r1 = regs[i << 1], regs[i << 1 | 1]
        if not r0 or not r1:
            continue
        if _cal_sub(opt, r0) > MIN_RATIO * r0[0].score:
            continue
        if _cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        d, dist = infer_dir(l_pac, r0[0].rb, r1[0].rb)
        if dist and dist <= opt.max_ins:
            isize[d].append(dist)
    if verbose >= 3:
        print("[M::mem_pestat] # candidate unique pairs for (FF, FR, RF, RR):"
              " (%d, %d, %d, %d)" % tuple(len(x) for x in isize),
              file=sys.stderr)
    for d in range(4):
        r = pes[d]
        q = sorted(isize[d])
        ori = "FR"[(d >> 1) & 1] + "FR"[d & 1]
        if len(q) < MIN_DIR_CNT:
            print("[M::mem_pestat] skip orientation %s as there are not enough"
                  " pairs" % ori, file=sys.stderr)
            r.failed = 1
            continue
        print("[M::mem_pestat] analyzing insert size distribution for "
              "orientation %s..." % ori, file=sys.stderr)
        p25 = q[int(.25 * len(q) + .499)]
        p50 = q[int(.50 * len(q) + .499)]
        p75 = q[int(.75 * len(q) + .499)]
        r.low = int(p25 - OUTLIER_BOUND * (p75 - p25) + .499)
        if r.low < 1:
            r.low = 1
        r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + .499)
        print("[M::mem_pestat] (25, 50, 75) percentile: (%d, %d, %d)"
              % (p25, p50, p75), file=sys.stderr)
        print("[M::mem_pestat] low and high boundaries for computing mean and "
              "std.dev: (%d, %d)" % (r.low, r.high), file=sys.stderr)
        x = 0
        r.avg = 0.0
        for v in q:
            if r.low <= v <= r.high:
                r.avg += v
                x += 1
        r.avg /= x
        r.std = 0.0
        for v in q:
            if r.low <= v <= r.high:
                r.std += (v - r.avg) * (v - r.avg)
        r.std = math.sqrt(r.std / x)
        print("[M::mem_pestat] mean and std.dev: (%.2f, %.2f)"
              % (r.avg, r.std), file=sys.stderr)
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + .499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + .499)
        if r.low > r.avg - MAX_STDDEV * r.std:
            r.low = int(r.avg - MAX_STDDEV * r.std + .499)
        if r.high < r.avg - MAX_STDDEV * r.std:
            r.high = int(r.avg + MAX_STDDEV * r.std + .499)
        if r.low < 1:
            r.low = 1
        print("[M::mem_pestat] low and high boundaries for proper pairs: "
              "(%d, %d)" % (r.low, r.high), file=sys.stderr)
    mx = max(len(x) for x in isize)
    for d in range(4):
        if pes[d].failed == 0 and len(isize[d]) < mx * MIN_DIR_RATIO:
            pes[d].failed = 1
            print("[M::mem_pestat] skip orientation %s"
                  % ("FR"[(d >> 1) & 1] + "FR"[d & 1]), file=sys.stderr)
    return pes


def matesw_gen(opt, l_pac: int, pac, pes: List[PeStat], a: AlnReg,
               mate_seq: np.ndarray, ma: List[AlnReg]):
    """mem_matesw as a generator: SW the mate within each plausible
    insert window; local-SW calls yielded as ('align2', seq, ref, xtra)
    requests."""
    l_ms = len(mate_seq)
    skip = [1 if pes[r].failed else 0 for r in range(4)]
    for reg in ma:
        r, dist = infer_dir(l_pac, a.rb, reg.rb)
        if pes[r].low <= dist <= pes[r].high:
            skip[r] = 1
    if sum(skip) == 4:
        return 0
    n = 0
    mat = np.asarray(opt.mat, dtype=np.int64)
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if is_rev:
            seq = np.array([3 - b if b < 4 else 4 for b in mate_seq[::-1]],
                           dtype=np.uint8)
        else:
            seq = mate_seq
        if not is_rev:
            rb = a.rb + pes[r].low if is_larger else a.rb - pes[r].high
            re = (a.rb + pes[r].high if is_larger else a.rb - pes[r].low) + l_ms
        else:
            rb = (a.rb + pes[r].low if is_larger else a.rb - pes[r].high) - l_ms
            re = a.rb + pes[r].high if is_larger else a.rb - pes[r].low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        ref = get_seq(l_pac, pac, rb, re)
        if len(ref) == re - rb:  # no funny things happening
            xtra = (ksw.KSW_XSUBO | ksw.KSW_XSTART
                    | (ksw.KSW_XBYTE if l_ms * opt.a < 250 else 0)
                    | (opt.min_seed_len * opt.a))
            aln = yield ("align2", seq, ref, xtra)
            if aln.score >= opt.min_seed_len and aln.qb >= 0:
                b = AlnReg()
                b.qb = l_ms - (aln.qe + 1) if is_rev else aln.qb
                b.qe = l_ms - aln.qb if is_rev else aln.qe + 1
                b.rb = ((l_pac << 1) - (rb + aln.te + 1)) if is_rev else rb + aln.tb
                b.re = ((l_pac << 1) - (rb + aln.tb)) if is_rev else rb + aln.te + 1
                b.score = aln.score
                b.csub = aln.score2
                b.secondary = -1
                b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
                # insert keeping ma sorted by score (bwamem_pair.c:160-166)
                ma.append(b)
                ins = 0
                while ins < len(ma) - 1 and ma[ins].score >= b.score:
                    ins += 1
                for i in range(len(ma) - 1, ins, -1):
                    ma[i] = ma[i - 1]
                ma[ins] = b
            n += 1
        if n:
            new = sort_and_dedup(ma, opt.mask_level_redun)
            ma[:] = new
    return n


def mem_pair(opt, l_pac: int, pes: List[PeStat], a0: List[AlnReg],
             a1: List[AlnReg], pair_id: int):
    """mem_pair: returns (score, sub, n_sub, z[2]) with z the chosen
    region indices, or score 0 when no proper pair."""
    v = []
    for r, regs in ((0, a0), (1, a1)):
        for i, e in enumerate(regs):
            key_x = e.rb if e.rb < l_pac else (l_pac << 1) - 1 - e.rb
            key_y = (e.score << 32) | (i << 2) | ((e.rb >= l_pac) << 1) | r
            v.append((key_x, key_y))
    v.sort()
    u = []
    y = [-1, -1, -1, -1]
    for i in range(len(v)):
        for r in range(2):
            dr = (r << 1) | ((v[i][1] >> 1) & 1)
            if pes[dr].failed:
                continue
            which = (r << 1) | ((v[i][1] & 1) ^ 1)
            if y[which] < 0:
                continue
            for k in range(y[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[dr].high:
                    break
                if dist < pes[dr].low:
                    continue
                ns = (dist - pes[dr].avg) / pes[dr].std
                ef = 2.0 * math.erfc(abs(ns) * M_SQRT1_2)
                if ef > 0.0:
                    q = int((v[i][1] >> 32) + (v[k][1] >> 32)
                            + .721 * math.log(ef) * opt.a + .499)
                else:  # erfc underflow: C's log(0) = -inf clamps to 0
                    q = 0
                if q < 0:
                    q = 0
                uy = (k << 32) | i
                ux = (q << 32) | (hash_64((uy ^ (pair_id << 8))
                                          & ((1 << 64) - 1)) & 0xFFFFFFFF)
                u.append((ux, uy))
        y[v[i][1] & 3] = i
    z = [-1, -1]
    if u:
        tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
        u.sort()
        i = u[-1][1] >> 32
        k = u[-1][1] & 0xFFFFFFFF
        # y<<32>>34 on uint64 == (y & 0xFFFFFFFF) >> 2: the region index
        z[v[i][1] & 1] = (v[i][1] & 0xFFFFFFFF) >> 2
        z[v[k][1] & 1] = (v[k][1] & 0xFFFFFFFF) >> 2
        ret = u[-1][0] >> 32
        sub = (u[-2][0] >> 32) if len(u) > 1 else 0
        n_sub = 0
        for i in range(len(u) - 2, -1, -1):
            if sub - (u[i][0] >> 32) <= tmp:
                n_sub += 1
        return ret, sub, n_sub, z
    return 0, 0, 0, z


def raw_mapq(diff: int, a: int) -> int:
    return int(6.02 * diff / a + .499)


def sam_pe(opt, bns, pac, pes: List[PeStat], pair_id: int, reads, regs,
           rg_id: str) -> int:
    """mem_sam_pe driven by the host-oracle SW."""
    from .swdrive import drive_host
    return drive_host(sam_pe_gen(opt, bns, pac, pes, pair_id, reads, regs,
                                 rg_id), opt)


def sam_pe_gen(opt, bns, pac, pes: List[PeStat], pair_id: int, reads, regs,
               rg_id: str, trace=None):
    """mem_sam_pe as a generator: finalize one read pair into SAM
    lines, yielding every SW request for batched wave dispatch.
    `trace` collects the bwa_verbose>=4 lines of the reg2aln calls."""
    s0, s1 = reads
    a = [regs[0], regs[1]]
    n = 0
    extra_flag = 1
    if not (opt.flag & MEM_F_NO_RESCUE):
        # snapshot rescue candidates for BOTH ends before any rescue runs,
        # as region copies (the reference copies mem_alnreg_t values into
        # b[] first, bwamem_pair.c:253-258)
        import copy as _copy_mod
        b = [[], []]
        for i in range(2):
            for reg in a[i]:
                if reg.score >= a[i][0].score - opt.pen_unpaired:
                    b[i].append(_copy_mod.copy(reg))
        for i in range(2):
            for j, reg in enumerate(b[i]):
                if j >= opt.max_matesw:
                    break
                n += yield from matesw_gen(opt, bns.l_pac, pac, pes, reg,
                                           reads[1 - i].seq_nt4, a[1 - i])
    mark_primary(opt, a[0], (pair_id << 1) | 0)
    mark_primary(opt, a[1], (pair_id << 1) | 1)
    if not (opt.flag & MEM_F_NOPAIRING):
        o = subo = n_sub = 0
        z = [-1, -1]
        if a[0] and a[1]:
            o, subo, n_sub, z = mem_pair(opt, bns.l_pac, pes, a[0], a[1],
                                         pair_id)
        if o > 0:
            # multiple primary hits on either end -> no pairing
            is_multi = [False, False]
            for i in range(2):
                for j in range(1, len(a[i])):
                    if a[i][j].secondary < 0 and a[i][j].score >= opt.T:
                        is_multi[i] = True
                        break
            if not (is_multi[0] or is_multi[1]):
                score_un = a[0][0].score + a[1][0].score - opt.pen_unpaired
                subo = max(subo, score_un)
                q_pe = raw_mapq(o - subo, opt.a)
                if n_sub > 0:
                    q_pe -= int(4.343 * math.log(n_sub + 1) + .499)
                q_pe = max(0, min(60, q_pe))
                if o > score_un:  # paired alignment preferred
                    c = [a[0][z[0]], a[1][z[1]]]
                    q_se = [0, 0]
                    for i in range(2):
                        if c[i].secondary >= 0:
                            c[i].sub = a[i][c[i].secondary].score
                            c[i].secondary = -2
                        q_se[i] = approx_mapq_se(opt, c[i])
                    for i in range(2):
                        if q_se[i] <= q_pe:
                            q_se[i] = q_pe if q_pe < q_se[i] + 40 else q_se[i] + 40
                    extra_flag |= 2
                    q_se[0] = min(q_se[0], raw_mapq(c[0].score - c[0].csub, opt.a))
                    q_se[1] = min(q_se[1], raw_mapq(c[1].score - c[1].csub, opt.a))
                else:
                    z = [0, 0]
                    q_se = [approx_mapq_se(opt, a[0][0]),
                            approx_mapq_se(opt, a[1][0])]
                h0 = yield from reg2aln_gen(opt, bns, pac, s0.l_seq,
                                            s0.seq_nt4, a[0][z[0]], trace)
                h0.mapq = q_se[0]
                h0.flag |= 0x40 | extra_flag
                h1 = yield from reg2aln_gen(opt, bns, pac, s1.l_seq,
                                            s1.seq_nt4, a[1][z[1]], trace)
                h1.mapq = q_se[1]
                h1.flag |= 0x80 | extra_flag
                out0, out1 = [], []
                aln2sam(bns, s0, 1, [h0], 0, h1, rg_id, out0)
                aln2sam(bns, s1, 1, [h1], 0, h0, rg_id, out1)
                s0.sam = "".join(out0)
                s1.sam = "".join(out1)
                if s0.name != s1.name:
                    raise RuntimeError("paired reads have different names")
                return n
    # no_pairing path
    h = [None, None]
    for i, (s, ai) in enumerate(((s0, a[0]), (s1, a[1]))):
        if ai and ai[0].score >= opt.T:
            h[i] = yield from reg2aln_gen(opt, bns, pac, s.l_seq,
                                          s.seq_nt4, ai[0], trace)
        else:
            h[i] = yield from reg2aln_gen(opt, bns, pac, s.l_seq,
                                          s.seq_nt4, None, trace)
    if (not (opt.flag & MEM_F_NOPAIRING) and h[0].rid == h[1].rid
            and h[0].rid >= 0):
        d, dist = infer_dir(bns.l_pac, a[0][0].rb, a[1][0].rb)
        if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
            extra_flag |= 2
    from .pipeline import reg2sam_se_gen
    yield from reg2sam_se_gen(opt, bns, pac, s0, a[0], 0x41 | extra_flag,
                              h[1], rg_id, trace)
    yield from reg2sam_se_gen(opt, bns, pac, s1, a[1], 0x81 | extra_flag,
                              h[0], rg_id, trace)
    if s0.name != s1.name:
        raise RuntimeError("paired reads have different names")
    return n
