"""pemerge: merge overlapping read pairs (software/pemerge.c, whole
file).  Read 2 is reverse-complemented and locally aligned against read
1 (ksw_align with XSTART|XSUBO); a chain of consistency tests rejects
non-overlap alignments, gapped overlaps, tandem repeats, and noisy
overlaps before the pair is fused into one read with reconciled
qualities."""

import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..config import fill_scmat
from ..index.bntseq import NT4_TABLE
from ..oracle import ksw

MAX_SCORE_RATIO = 0.9
MAX_ERR = 8

ERR_MSG = [
    "successful merges",
    "low-scoring pairs",
    "pairs where the best SW alignment is not an overlap (long left end)",
    "pairs where the best SW alignment is not an overlap (long right end)",
    "pairs with large 2nd best SW score",
    "pairs with gapped overlap",
    "pairs where the end-to-end alignment is inconsistent with SW",
    "pairs potentially with tandem overlaps",
    "pairs with high sum of errors",
]


@dataclass
class PemOptions:
    a: int = 5
    b: int = 4
    q: int = 2
    r: int = 17
    w: int = 20
    q_def: int = 20
    q_thres: int = 70
    T: int = 50          # a * min_ovlp
    chunk_size: int = 10000000
    n_threads: int = 1
    flag: int = 3        # bit 1: print merged; 2: print unmerged
    mat: List[int] = field(default_factory=lambda: fill_scmat(5, 4))


def pemerge_pair(opt: PemOptions, x0, x1) -> int:
    """bwa_pemerge for one pair: on success (return 0) x0 is replaced by
    the merged read and x1.seq emptied; negative codes match the C error
    numbering (software/pemerge.c:59-147)."""
    mat = np.asarray(opt.mat, dtype=np.int64)
    l0, l1 = x0.l_seq, x1.l_seq
    s0 = NT4_TABLE[np.frombuffer(x0.seq.encode("latin1"), np.uint8)].copy()
    q0 = (np.frombuffer(x0.qual.encode("latin1"), np.uint8) - 33
          if x0.qual else np.full(l0, opt.q_def, np.uint8)).astype(np.int32)
    rev = NT4_TABLE[np.frombuffer(x1.seq.encode("latin1"), np.uint8)][::-1]
    s1 = np.where(rev < 4, 3 - rev, 4).astype(np.uint8)
    q1 = (np.frombuffer(x1.qual.encode("latin1"), np.uint8) - 33
          if x1.qual else np.full(l1, opt.q_def, np.uint8)
          ).astype(np.int32)[::-1].copy()

    xtra = ksw.KSW_XSTART | ksw.KSW_XSUBO
    r = ksw.ksw_align2(s1, s0, mat, opt.q, opt.r, opt.q, opt.r, xtra)
    qe, te = r.qe + 1, r.te + 1  # half-open

    if r.score < opt.T:
        return -1  # poor alignment
    if r.tb < r.qb:
        return -2  # not enough space for the left end
    if l0 - te > l1 - qe:
        return -3  # not enough space for the right end
    if float(r.score2) / r.score >= MAX_SCORE_RATIO:
        return -4  # second best score too large
    if qe - r.qb != te - r.tb:
        return -5  # gapped overlap

    # tandem-match test (software/pemerge.c:89-106)
    min_l = min(l0, l1)
    mat55 = mat.reshape(5, 5)
    max_m = max_m2 = 0
    max_l = max_l2 = 0
    for l in range(1, min_l):
        o = l0 - l
        m = int(mat55[s1[:l], s0[o:o + l]].sum())
        if m > max_m:
            max_m2, max_m = max_m, m
            max_l2, max_l = max_l, l
        elif m > max_m2:
            max_m2, max_l2 = m, l
    if max_m < opt.T or max_l != l0 - (r.tb - r.qb):
        return -6  # end-to-end inconsistent with SW
    if (max_l2 < max_l and max_m2 >= opt.T
            and float(max_m2 + (max_l - max_l2) * opt.a) / max_m
            >= MAX_SCORE_RATIO):
        return -7  # potential tandem overlap
    if max_l2 > max_l and float(max_m2) / max_m >= MAX_SCORE_RATIO:
        return -7

    l = l0 - (r.tb - r.qb)  # overlap length
    l_seq = l0 + l1 - l
    seq = np.concatenate([s0, s1[l:]]).astype(np.int32)
    qual = np.concatenate([q0, q1[l:]])
    sum_q = 0
    for i in range(l):
        k = l0 - l + i
        if s0[k] == 4:
            seq[k] = s1[i]
            qual[k] = q1[i]
        elif s1[i] == 4:
            pass
        elif s0[k] == s1[i]:
            qual[k] = max(qual[k], q1[i])
        else:
            qq = min(int(q0[k]), int(q1[i]))
            sum_q += (qq << 1) if qq >= 3 else 1
            seq[k] = s0[k] if q0[k] > q1[i] else s1[i]
            qual[k] = abs(int(q0[k]) - int(q1[i]))
    if (sum_q >> 1) > opt.q_thres:
        return -8  # too many mismatches

    x0.seq = "".join("ACGTN"[c] for c in seq[:l_seq])
    x0.qual = "".join(chr(int(c) + 33) for c in qual[:l_seq])
    x1.seq = ""
    x1.qual = None
    return 0


def print_bseq(s, rn: int, out) -> None:
    out.write("@" if s.qual else ">")
    out.write(s.name)
    if rn in (1, 2):
        out.write("/%d\n" % rn)
    else:
        out.write(" merged\n")
    out.write(s.seq + "\n")
    if s.qual:
        out.write("+\n" + s.qual + "\n")


def process_chunk(opt: PemOptions, reads, cnt: List[int], out) -> None:
    n = (len(reads) >> 1) << 1
    for i in range(n >> 1):
        ret = pemerge_pair(opt, reads[i << 1], reads[i << 1 | 1])
        cnt[-ret] += 1
    for i in range(n >> 1):
        if reads[i << 1 | 1].l_seq != 0:
            if opt.flag & 2:
                print_bseq(reads[i << 1], 1, out)
                print_bseq(reads[i << 1 | 1], 2, out)
        elif opt.flag & 1:
            print_bseq(reads[i << 1], 0, out)


def main_pemerge(argv) -> int:
    import getopt as _getopt
    from ..io.native import make_chunk_reader
    opt = PemOptions()
    flag = 0
    min_ovlp = 10
    try:
        opts, args = _getopt.getopt(argv, "muQ:t:T:")
    except _getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n")
        return 1
    for c, v in opts:
        if c == "-m":
            flag |= 1
        elif c == "-u":
            flag |= 2
        elif c == "-Q":
            opt.q_thres = int(v)
        elif c == "-t":
            opt.n_threads = int(v)
        elif c == "-T":
            min_ovlp = int(v)
    opt.flag = flag if flag else 3
    opt.T = opt.a * min_ovlp
    if not args:
        sys.stderr.write(
            "\nUsage:   bwa pemerge [-mu] <read1.fq> [read2.fq]\n\n"
            "Options: -m       output merged reads only\n"
            "         -u       output unmerged reads only\n"
            "         -t INT   number of threads [%d]\n"
            "         -T INT   minimum end overlap [%d]\n"
            "         -Q INT   max sum of errors [%d]\n\n"
            % (opt.n_threads, min_ovlp, opt.q_thres))
        return 1
    reader = make_chunk_reader(args[0], args[1] if len(args) > 1 else None)
    cnt = [0] * (MAX_ERR + 1)
    while True:
        reads = reader.read_chunk(opt.n_threads * opt.chunk_size)
        if not reads:
            break
        process_chunk(opt, reads, cnt, sys.stdout)
    for i in range(MAX_ERR + 1):
        sys.stderr.write("%12d %s\n" % (cnt[i], ERR_MSG[i]))
    return 0
