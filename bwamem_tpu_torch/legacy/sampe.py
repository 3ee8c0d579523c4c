"""bwa sampe: paired .sai -> SAM (software/bwape.c, whole file).

Insert-size inference, proper-pair selection over the sorted position
list, and Smith-Waterman mate rescue, reproducing the reference's exact
arithmetic (uint64 pair keys, hash_64 tie-breaks, erfc-based penalties,
glibc drand48 hit sampling)."""

import math
import struct
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..index.bntseq import get_seq
from ..oracle import ksw as oksw
from ..utils.hashing import hash_64
from ..utils.rand48 import Rand48
from .aln import Aln1, GapOpt, SAI_MAGIC, cal_maxdiff, BWA_AVG_ERR
from .samse import (AlnState, Multi1, aln2seq_core, approx_mapQ, sa2pos,
                    refine_gapped, print_sam1, read_sai_header,
                    read_sai_records, G_LOG_N, cig_op, cig_len, cig_make,
                    BWA_TYPE_NO_MATCH, BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT,
                    BWA_TYPE_MATESW, FROM_M, FROM_I, FROM_D, FROM_S)
from .seqio import LegacyRead, read_seqs

SAM_FPD = 1
SAM_FPP = 2
SAM_FR1 = 64
SAM_FR2 = 128

OUTLIER_BOUND = 2.0
MIN_HASH_WIDTH = 1000
SW_MIN_MATCH_LEN = 20
SW_MIN_MAPQ = 17
M_SQRT1_2 = 0.7071067811865476
M_SQRT2 = 1.4142135623730951
U64 = (1 << 64) - 1


@dataclass
class PeOpt:
    max_isize: int = 500
    force_isize: int = 0
    max_occ: int = 100000
    n_multi: int = 3
    N_multi: int = 10
    type: int = 1  # BWA_PET_STD
    is_sw: int = 1
    is_preload: int = 0
    ap_prior: float = 1e-5


@dataclass
class IsizeInfo:
    avg: float = -1.0
    std: float = -1.0
    ap_prior: float = 0.0
    low: int = 0
    high: int = 0
    high_bayesian: int = 0


def infer_isize(reads0, reads1, states0, states1, ap_prior: float,
                L: int) -> Optional[IsizeInfo]:
    """infer_isize (software/bwape.c:82-155)."""
    ii = IsizeInfo()
    isizes = []
    max_len = 1
    for p0, p1, s0, s1 in zip(reads0, reads1, states0, states1):
        if s0.mapQ >= 20 and s1.mapQ >= 20:
            a0 = s0.pos & U64
            a1 = s1.pos & U64
            if a0 < a1:
                x = (a1 + p1.len - a0) & U64
            else:
                x = (a0 + p0.len - a1) & U64
            if x < 100000:
                isizes.append(x)
        max_len = max(max_len, p0.len, p1.len)
    tot = len(isizes)
    if tot < 20:
        sys.stderr.write("[infer_isize] fail to infer insert size: "
                         "too few good pairs\n")
        return ii
    isizes.sort()
    p25 = isizes[int(tot * 0.25 + 0.5)]
    p50 = isizes[int(tot * 0.50 + 0.5)]
    p75 = isizes[int(tot * 0.75 + 0.5)]
    tmp = int(p25 - OUTLIER_BOUND * (p75 - p25) + .499)
    ii.low = tmp if tmp > max_len else max_len
    ii.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + .499)
    if ii.low > ii.high:
        sys.stderr.write("[infer_isize] fail to infer insert size: upper "
                         "bound is smaller than read length\n")
        ii.low = ii.high = ii.high_bayesian = 0
        ii.avg = ii.std = -1.0
        return ii
    n = 0
    x = 0
    for v in isizes:
        if ii.low <= v <= ii.high:
            n += 1
            x += v
    ii.avg = x / n
    std = skewness = kurtosis = 0.0
    for v in isizes:
        if ii.low <= v <= ii.high:
            t = (v - ii.avg) * (v - ii.avg)
            std += t
            skewness += t * (v - ii.avg)
            kurtosis += t * t
    kurtosis = kurtosis / n / (std / n * std / n) - 3
    ii.std = math.sqrt(std / n)
    skewness = skewness / n / (ii.std ** 3)
    y = 1.0
    while y < 10.0:
        if .5 * math.erfc(y / M_SQRT2) < ap_prior / L * (y * ii.std + ii.avg):
            break
        y += 0.01
    ii.high_bayesian = int(y * ii.std + ii.avg + .499)
    n_ap = sum(1 for v in isizes if v > ii.high_bayesian)
    ii.ap_prior = .01 * (n_ap + .01) / tot
    if ii.ap_prior < ap_prior:
        ii.ap_prior = ap_prior
    sys.stderr.write("[infer_isize] (25, 50, 75) percentile: (%d, %d, %d)\n"
                     % (p25, p50, p75))
    if math.isnan(ii.std) or p75 > 100000:
        ii.low = ii.high = ii.high_bayesian = 0
        ii.avg = ii.std = -1.0
        sys.stderr.write("[infer_isize] fail to infer insert size: weird "
                         "pairing\n")
        return ii
    y = 1.0
    while y < 10.0:
        if .5 * math.erfc(y / M_SQRT2) < ap_prior / L * (y * ii.std + ii.avg):
            break
        y += 0.01
    ii.high_bayesian = int(y * ii.std + ii.avg + .499)
    sys.stderr.write("[infer_isize] low and high boundaries: %ld and %ld"
                     " for estimating avg and std\n" % (ii.low, ii.high))
    sys.stderr.write("[infer_isize] inferred external isize from %d pairs: "
                     "%.3f +/- %.3f\n" % (n, ii.avg, ii.std))
    sys.stderr.write("[infer_isize] skewness: %.3f; kurtosis: %.3f; "
                     "ap_prior: %.2e\n" % (skewness, kurtosis, ii.ap_prior))
    sys.stderr.write("[infer_isize] inferred maximum insert size: %ld "
                     "(%.2f sigma)\n" % (ii.high_bayesian, y))
    return ii


def pairing(p, s, alns, arr, opt: PeOpt, s_mm: int, ii: IsizeInfo) -> int:
    """pairing (software/bwape.c:157-255).  p/s: per-end read/state;
    alns: per-end Aln1 list; arr: list of (x, y) uint64 pairs."""
    cnt_chg = 0
    max_len = max(p[0].full_len, p[1].full_len)

    o_score = subo_score = U64
    o_n = subo_n = 0
    o_pos = [U64, U64]  # packed (x, y) per end; U64 = unset
    o_xy = [None, None]
    arr.sort()
    last_pos = [[None, None], [None, None]]

    def aux(u, v):
        nonlocal o_score, subo_score, o_n, subo_n
        if u is None:
            return
        ux, uy = u
        vx, vy = v
        l = (vx + p[vy & 1].len - ux) & U64
        if ux != U64 and vx > ux and l >= max_len \
                and ((ii.high and l <= ii.high_bayesian)
                     or (ii.high == 0 and l <= opt.max_isize)):
            s_ = (alns[vy & 1][vy >> 2].score
                  + alns[uy & 1][uy >> 2].score)
            s_ *= 10
            if ii.high:
                ef = .5 * math.erfc(M_SQRT1_2 * abs(l - ii.avg) / ii.std)
                s_ += int(-4.343 * math.log(ef) + .499) if ef > 0.0 \
                    else int(float("inf")) if False else _log0_add()
            s_ = ((s_ << 32) | (hash_64((ux << 32 | vx) & U64)
                                & 0xFFFFFFFF)) & U64
            if (s_ >> 32) == (o_score >> 32):
                o_n += 1
            elif (s_ >> 32) < (o_score >> 32):
                subo_n += o_n
                o_n = 1
            else:
                subo_n += 1
            if s_ < o_score:
                subo_score = o_score
                o_score = s_
                o_xy[uy & 1] = (ux, uy)
                o_xy[vy & 1] = (vx, vy)
            elif s_ < subo_score:
                subo_score = s_

    for xy in arr:
        x, y = xy
        strand = (y >> 1) & 1
        if strand == 1:
            m = 1 - (y & 1)
            aux(last_pos[m][1], xy)
            aux(last_pos[m][0], xy)
        else:
            e = y & 1
            last_pos[e][0] = last_pos[e][1]
            last_pos[e][1] = xy
    if o_score != U64:
        mapQ_p = 0
        if o_n == 1:
            if subo_score == U64:
                mapQ_p = 29
            elif (subo_score >> 32) - (o_score >> 32) > s_mm * 10:
                mapQ_p = 23
            else:
                n = 255 if subo_n > 255 else subo_n
                mapQ_p = ((subo_score >> 32) - (o_score >> 32)) // 2 \
                    - G_LOG_N[n]
                if mapQ_p < 0:
                    mapQ_p = 0
        p0_same = (s[0].pos & U64) == o_xy[0][0] \
            and s[0].strand == ((o_xy[0][1] >> 1) & 1)
        p1_same = (s[1].pos & U64) == o_xy[1][0] \
            and s[1].strand == ((o_xy[1][1] >> 1) & 1)
        if p0_same and p1_same:
            if s[0].mapQ > 0 and s[1].mapQ > 0:
                mq = min(s[0].mapQ + s[1].mapQ, 60)
                s[0].mapQ = s[1].mapQ = mq
            else:
                if s[0].mapQ == 0:
                    s[0].mapQ = min(mapQ_p + 7, s[1].mapQ)
                if s[1].mapQ == 0:
                    s[1].mapQ = min(mapQ_p + 7, s[0].mapQ)
        elif p0_same:  # [1] moved
            s[1].seQ = 0
            s[1].mapQ = min(s[0].mapQ, mapQ_p)
        elif p1_same:  # [0] moved
            s[0].seQ = 0
            s[0].mapQ = min(s[1].mapQ, mapQ_p)
        else:
            s[0].seQ = s[1].seQ = 0
            mapQ_p = max(mapQ_p - 20, 0)
            s[0].mapQ = s[1].mapQ = mapQ_p
        for e in range(2):
            wx, wy = o_xy[e]
            r = alns[wy & 1][wy >> 2]
            s[e].extra_flag_pp = True
            if (s[e].pos & U64) != wx or s[e].strand != ((wy >> 1) & 1):
                s[e].n_mm, s[e].n_gapo, s[e].n_gape = \
                    r.n_mm, r.n_gapo, r.n_gape
                s[e].strand = (wy >> 1) & 1
                s[e].score = r.score
                s[e].pos = wx
                if s[e].mapQ > 0:
                    cnt_chg += 1
    return cnt_chg


def _log0_add() -> int:
    """C computes (int)(-4.343*log(0) + .499) on erfc underflow: -inf
    cast to int is UB but glibc/x86 gives INT_MIN; adding it makes the
    score huge-negative -> the pair never wins.  Reproduce via INT_MIN."""
    return -0x80000000


def sw_core(l_pac: int, pac, length: int, seq: np.ndarray, beg: int,
            reglen: int):
    """bwa_sw_core (software/bwape.c:408-498): returns
    (cigar, new_beg, cnt) or (None, beg, 0)."""
    from ..config import fill_scmat
    mat = np.asarray(fill_scmat(1, 3), dtype=np.int64)
    if reglen < SW_MIN_MATCH_LEN or l_pac - beg < length:
        return None, beg, 0
    nN = int(np.sum(seq[:length] >= 4))
    if nN / length >= 0.25 or length - nN < SW_MIN_MATCH_LEN:
        return None, beg, 0
    # reference subsequence [beg, beg+reglen) clamped at l_pac
    end = min(beg + reglen, l_pac)
    ref = get_seq(l_pac, pac, beg, end)
    l = len(ref)
    xtra = oksw.KSW_XSUBO | oksw.KSW_XSTART \
        | (oksw.KSW_XBYTE if length < 250 else 0)
    r = oksw.ksw_align2(seq[:length], ref, mat, 5, 1, 5, 1, xtra)
    gscore, cigar32 = oksw.ksw_global2(
        seq[r.qb:r.qe + 1], ref[r.tb:r.te + 1], mat, 5, 1, 5, 1, 50)
    cigar = [cig_make(c & 0xF, c >> 4) for c in cigar32]
    if r.score < SW_MIN_MATCH_LEN or r.score2 == r.score \
            or gscore != r.score:
        return None, beg, 0
    x = y = 0
    for c in cigar:
        if cig_op(c) == FROM_M:
            x += cig_len(c)
            y += cig_len(c)
        elif cig_op(c) == FROM_D:
            x += cig_len(c)
        else:
            y += cig_len(c)
    if x < SW_MIN_MATCH_LEN or y < SW_MIN_MATCH_LEN:
        return None, beg, 0
    start, endq = r.qb, r.qe + 1
    new_beg = beg + r.tb
    if start:
        cigar = [cig_make(3, start)] + cigar
    if endq < length:
        cigar = cigar + [cig_make(3, length - endq)]
    n_mm = n_gapo = n_gape = 0
    x, y = r.tb, r.qb
    for c in cigar:
        if cig_op(c) == FROM_M:
            for k in range(cig_len(c)):
                if ref[x + k] < 4 and seq[y + k] < 4 \
                        and ref[x + k] != seq[y + k]:
                    n_mm += 1
            x += cig_len(c)
            y += cig_len(c)
        elif cig_op(c) == FROM_D:
            x += cig_len(c)
            n_gapo += 1
            n_gape += cig_len(c) - 1
        elif cig_op(c) == FROM_I:
            y += cig_len(c)
            n_gapo += 1
            n_gape += cig_len(c) - 1
    cnt = (n_mm << 16) | (n_gapo << 8) | n_gape
    return cigar, new_beg, cnt


def paired_sw(bns, reads, states, popt: PeOpt, ii: IsizeInfo) -> None:
    """bwa_paired_sw (software/bwape.c:500-...)."""
    pac = bns.pac
    if not popt.is_sw or ii.avg < 0.0:
        return
    n_tot = [0, 0]
    n_mapped = [0, 0]
    for p0, p1, s0, s1 in zip(reads[0], reads[1], states[0], states[1]):
        p = [p0, p1]
        s = [s0, s1]
        if (s0.mapQ >= SW_MIN_MAPQ or s1.mapQ >= SW_MIN_MAPQ) \
                and not getattr(s0, "extra_flag_pp", False):
            is_singleton = 1 if (s0.type == BWA_TYPE_NO_MATCH
                                 or s1.type == BWA_TYPE_NO_MATCH) else 0
            n_tot[is_singleton] += 1
            cigar = [None, None]
            beg = [0, 0]
            cnt = [0, 0]
            mq_adjust = [255, 255]
            for k in range(2):
                ref = s[1 - k]
                if ref.type == BWA_TYPE_NO_MATCH:
                    continue
                if ref.strand == 0:  # mate on reverse, larger coord
                    a = int(ref.pos + ii.avg - 3 * ii.std
                            - p[k].len * 1.5)
                    b = int(a + 6 * ii.std + 2 * p[k].len)
                    if a < ref.pos + p[1 - k].len:
                        a = ref.pos + p[1 - k].len
                    if b > bns.l_pac:
                        b = bns.l_pac
                    seq = p[k].rseq
                else:  # mate on forward, smaller coord
                    a = int(ref.pos + p[1 - k].len - ii.avg - 3 * ii.std
                            - p[k].len * 0.5)
                    b = int(a + 6 * ii.std + 2 * p[k].len)
                    if a < 0:
                        a = 0
                    if b > ref.pos:
                        b = ref.pos
                    seq = p[k].seq_fwd
                cg, nb, cn = sw_core(bns.l_pac, pac, p[k].len, seq, a,
                                     b - a)
                beg[k], cnt[k] = nb, cn
                cigar[k] = cg
                if cg and s[k].type != BWA_TYPE_NO_MATCH:
                    clip = 0
                    if cig_op(cg[0]) == 3:
                        clip += cig_len(cg[0])
                    if cig_op(cg[-1]) == 3:
                        clip += cig_len(cg[-1])
                    s_old = int((s[k].n_mm * 9 + s[k].n_gapo * 13
                                 + s[k].n_gape * 2) / 3. * 8. + .499)
                    s_new = int(((cn >> 16) * 9 + ((cn >> 8) & 0xFF) * 13
                                 + (cn & 0xFF) * 2 + clip * 3) / 3. * 8.
                                + .499)
                    s_old += int(-4.343 * math.log(ii.ap_prior
                                                   / bns.l_pac))
                    s_new += int(-4.343 * math.log(
                        .5 * math.erfc(M_SQRT1_2 * 1.5) + .499))
                    if s_old < s_new:  # reject SW alignment
                        mq_adjust[k] = s_new - s_old
                        cigar[k] = None
                    else:
                        mq_adjust[k] = s_old - s_new
            k = -1
            mapQ = 0
            if cigar[0] and cigar[1]:
                k = 0 if s[0].mapQ < s[1].mapQ else 1
                mapQ = abs(s[1].mapQ - s[0].mapQ)
            elif cigar[0]:
                k = 0
                mapQ = s[1].mapQ
            elif cigar[1]:
                k = 1
                mapQ = s[0].mapQ
            if k >= 0 and s[k].pos != beg[k]:
                n_mapped[is_singleton] += 1
                tmp = s[1 - k].mapQ - s[k].mapQ // 2 - 8
                if tmp <= 0:
                    tmp = 1
                if mapQ > tmp:
                    mapQ = tmp
                s[k].mapQ = s[1 - k].mapQ = mapQ
                s[k].seQ = s[1 - k].seQ = min(s[1 - k].seQ, mapQ)
                if s[k].mapQ > mq_adjust[k]:
                    s[k].mapQ = mq_adjust[k]
                if s[k].seQ > mq_adjust[k]:
                    s[k].seQ = mq_adjust[k]
                s[k].cigar = cigar[k]
                s[k].type = BWA_TYPE_MATESW
                s[k].pos = beg[k]
                s[k].seQ = s[1 - k].seQ
                s[k].strand = 1 - s[1 - k].strand
                s[k].n_mm = cnt[k] >> 16
                s[k].n_gapo = (cnt[k] >> 8) & 0xFF
                s[k].n_gape = cnt[k] & 0xFF
                s[k].extra_flag_pp = True
                s[1 - k].extra_flag_pp = True
    sys.stderr.write("[bwa_paired_sw] %d out of %d Q%d singletons are "
                     "mated.\n" % (n_mapped[1], n_tot[1], SW_MIN_MAPQ))
    sys.stderr.write("[bwa_paired_sw] %d out of %d Q%d discordant pairs "
                     "are fixed.\n" % (n_mapped[0], n_tot[0], SW_MIN_MAPQ))


def cal_pac_pos_pe(bns, fm, reads, states, fps, ii_out: IsizeInfo,
                   popt: PeOpt, gopt: GapOpt, last_ii: IsizeInfo,
                   rng: Rand48) -> int:
    """bwa_cal_pac_pos_pe (software/bwape.c:261-402)."""
    n = len(reads[0])
    bufs = [[], []]
    cnt_chg = 0
    # SE step
    for i in range(n):
        for j in range(2):
            p = reads[j][i]
            s = states[j][i]
            p.extra_flag |= SAM_FPD | (SAM_FR1 if j == 0 else SAM_FR2)
            alns = read_sai_records(fps[j])
            bufs[j].append(alns)
            aln2seq_core(alns, s, True, 0, rng)
            if s.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT):
                max_diff = cal_maxdiff(p.len, BWA_AVG_ERR, gopt.fnr) \
                    if gopt.fnr > 0.0 else gopt.max_diff
                s.seQ = s.mapQ = approx_mapQ(s, max_diff)
                s.pos, s.strand = sa2pos(bns, fm, s.sa,
                                         p.len + s.ref_shift)
    # infer isize
    ii = infer_isize(reads[0], reads[1], states[0], states[1],
                     popt.ap_prior, fm.seq_len // 2)
    if ii.avg < 0.0 and last_ii.avg > 0.0:
        ii = last_ii
    if popt.force_isize:
        sys.stderr.write("[bwa_cal_pac_pos_pe] discard insert size "
                         "estimate as user's request.\n")
        ii.low = ii.high = 0
        ii.avg = ii.std = -1.0
    ii_out.__dict__.update(ii.__dict__)

    # PE step
    for i in range(n):
        p = [reads[0][i], reads[1][i]]
        s = [states[0][i], states[1][i]]
        alns = [bufs[0][i], bufs[1][i]]
        both = all(x.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT)
                   for x in s)
        if both:
            n_occ = [sum(a.l - a.k + 1 for a in alns[j])
                     for j in range(2)]
            if not (n_occ[0] > popt.max_occ or n_occ[1] > popt.max_occ):
                arr = []
                for j in range(2):
                    for k, r in enumerate(alns[j]):
                        for l in range(r.k, r.l + 1):
                            pos, strand = sa2pos(bns, fm, l,
                                                 p[j].len + (r.n_del
                                                             - r.n_ins))
                            arr.append((pos & U64,
                                        (k << 2) | (strand << 1) | j))
                cnt_chg += pairing(p, s, alns, arr, popt, gopt.s_mm, ii)
        if popt.N_multi or popt.n_multi:
            for j in range(2):
                if s[j].type != BWA_TYPE_NO_MATCH:
                    if not getattr(s[j], "extra_flag_pp", False) \
                            and s[1 - j].type != BWA_TYPE_NO_MATCH:
                        nm = popt.n_multi \
                            if s[j].c1 + s[j].c2 - 1 > popt.N_multi \
                            else popt.N_multi
                        aln2seq_core(alns[j], s[j], False, nm, rng)
                    else:
                        aln2seq_core(alns[j], s[j], False, popt.n_multi,
                                     rng)
                    kept = []
                    for q in s[j].multi:
                        q.pos, q.strand = sa2pos(bns, fm, q.pos,
                                                 p[j].len + q.ref_shift)
                        if q.pos != s[j].pos:
                            kept.append(q)
                    s[j].multi = kept
                    s[j].n_multi = len(kept)
    return cnt_chg


def main_sampe(argv) -> int:
    import getopt as _getopt
    from ..index.bntseq import bns_restore
    from ..index.fmindex import FmIndex
    from ..core.sam import sam_header
    popt = PeOpt()
    rg_line = rg_id = None
    out_path = None
    try:
        opts, args = _getopt.getopt(argv, "a:o:sPn:N:c:f:Ar:")
    except _getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n")
        return 1
    for c, v in opts:
        if c == "-r":
            from ..cli import set_rg
            rg_line, rg_id = set_rg(v)
            if rg_line is None:
                return 1
        elif c == "-a":
            popt.max_isize = int(v)
        elif c == "-o":
            popt.max_occ = int(v)
        elif c == "-s":
            popt.is_sw = 0
        elif c == "-P":
            popt.is_preload = 1
        elif c == "-n":
            popt.n_multi = int(v)
        elif c == "-N":
            popt.N_multi = int(v)
        elif c == "-c":
            popt.ap_prior = float(v)
        elif c == "-f":
            out_path = v
        elif c == "-A":
            popt.force_isize = 1
    if len(args) < 5:
        sys.stderr.write("Usage: bwa sampe [options] <prefix> <in1.sai> "
                         "<in2.sai> <in1.fq> <in2.fq>\n")
        return 1
    prefix = args[0]
    bns = bns_restore(prefix, load_pac_file=True)
    rng = Rand48(bns.seed)
    fm = FmIndex.restore(prefix + ".bwt", prefix + ".sa")
    fps = [open(args[1], "rb"), open(args[2], "rb")]
    opt0 = read_sai_header(fps[0])
    opt1 = read_sai_header(fps[1])
    out = open(out_path, "w") if out_path else sys.stdout
    out.write(sam_header(bns, rg_line, None))
    from .seqio import open_reads
    readers = [open_reads(args[3], opt0.mode),
               open_reads(args[4], opt1.mode)]
    last_ii = IsizeInfo()
    tot = 0
    while True:
        reads0 = readers[0](0x40000, opt0.trim_qual)
        if not reads0:
            break
        reads1 = readers[1](0x40000, opt1.trim_qual)
        tot += len(reads0)
        reads = [reads0, reads1]
        states = [[AlnState() for _ in reads0],
                  [AlnState() for _ in reads1]]
        sys.stderr.write("[bwa_sai2sam_pe_core] convert to sequence "
                         "coordinate... \n")
        ii = IsizeInfo()
        cnt_chg = cal_pac_pos_pe(bns, fm, reads, states, fps, ii, popt,
                                 opt1, last_ii, rng)
        sys.stderr.write("[bwa_sai2sam_pe_core] time elapses: 0.00 sec\n")
        sys.stderr.write("[bwa_sai2sam_pe_core] changing coordinates of "
                         "%d alignments.\n" % cnt_chg)
        sys.stderr.write("[bwa_sai2sam_pe_core] align unmapped mate...\n")
        paired_sw(bns, reads, states, popt, ii)
        sys.stderr.write("[bwa_sai2sam_pe_core] time elapses: 0.00 sec\n")
        sys.stderr.write("[bwa_sai2sam_pe_core] refine gapped "
                         "alignments... ")
        for j in range(2):
            refine_gapped(bns, fm, reads[j], states[j])
        sys.stderr.write("0.00 sec\n")
        sys.stderr.write("[bwa_sai2sam_pe_core] print alignments... ")
        for i in range(len(reads0)):
            p0, p1 = reads0[i], reads1[i]
            s0, s1 = states[0][i], states[1][i]
            if p0.bc or p1.bc:
                p0.bc = p0.bc + p1.bc
                p1.bc = p0.bc
            if getattr(s0, "extra_flag_pp", False):
                p0.extra_flag |= SAM_FPP
            if getattr(s1, "extra_flag_pp", False):
                p1.extra_flag |= SAM_FPP
            print_sam1(bns, p0, s0, s1, p1.len, opt1.mode,
                       opt1.max_top2, rg_id or "", out)
            print_sam1(bns, p1, s1, s0, p0.len, opt1.mode,
                       opt1.max_top2, rg_id or "", out)
            if p0.name != p1.name:
                raise RuntimeError("paired reads have different names")
        sys.stderr.write("0.00 sec\n")
        sys.stderr.write("[bwa_sai2sam_pe_core] %d sequences have been "
                         "processed.\n" % tot)
        last_ii = ii
    for f in fps:
        f.close()
    if out_path:
        out.close()
    return 0
