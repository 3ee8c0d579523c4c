"""bwa-aln: the 2008 backtracking aligner's search stage.

Transcribed from the reference:
  gap_init_opt / bwa_cal_maxdiff   software/bwtaln.c:24-54
  bwt_cal_width                    software/bwtaln.c:57-81
  bwa_cal_sa_reg_gap               software/bwtaln.c:83-128
  bwt_match_gap (priority-stack
  branch-and-bound over the FM
  index with gap states)           software/bwtgap.c:110-264
  .sai on-disk format              software/bwtaln.c:177-180,219-224

The search runs per read on the host (the reference keeps bwa-aln
CPU-only too — SURVEY.md §2.2 "Legacy"); the FM-index occ queries go
through the same host oracle verified against the device kernels.
"""

import math
import struct
import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

BWA_AVG_ERR = 0.02
BWA_MIN_RDLEN = 35

BWA_MODE_GAPE = 0x01
BWA_MODE_COMPREAD = 0x02
BWA_MODE_LOGGAP = 0x04
BWA_MODE_CFY = 0x08
BWA_MODE_NONSTOP = 0x10
BWA_MODE_BAM = 0x20
BWA_MODE_BAM_SE = 0x40
BWA_MODE_BAM_READ1 = 0x80
BWA_MODE_BAM_READ2 = 0x100
BWA_MODE_IL13 = 0x200

STATE_M, STATE_I, STATE_D = 0, 1, 2

SAI_MAGIC = b"SAI\x01"


@dataclass
class GapOpt:
    s_mm: int = 3
    s_gapo: int = 11
    s_gape: int = 4
    mode: int = BWA_MODE_GAPE | BWA_MODE_COMPREAD
    indel_end_skip: int = 5
    max_del_occ: int = 10
    max_entries: int = 2000000
    fnr: float = 0.04
    max_diff: int = -1
    max_gapo: int = 1
    max_gape: int = 6
    max_seed_diff: int = 2
    seed_len: int = 32
    n_threads: int = 1
    max_top2: int = 30
    trim_qual: int = 0

    def pack(self) -> bytes:
        """gap_opt_t raw struct bytes as written into .sai
        (software/bwtaln.c:178)."""
        return struct.pack(
            "<iiiiiiifiiiiiiii",
            self.s_mm, self.s_gapo, self.s_gape, self.mode,
            self.indel_end_skip, self.max_del_occ, self.max_entries,
            self.fnr, self.max_diff, self.max_gapo, self.max_gape,
            self.max_seed_diff, self.seed_len, self.n_threads,
            self.max_top2, self.trim_qual)

    @classmethod
    def unpack(cls, raw: bytes) -> "GapOpt":
        v = struct.unpack("<iiiiiiifiiiiiiii", raw)
        o = cls()
        (o.s_mm, o.s_gapo, o.s_gape, o.mode, o.indel_end_skip,
         o.max_del_occ, o.max_entries, o.fnr, o.max_diff, o.max_gapo,
         o.max_gape, o.max_seed_diff, o.seed_len, o.n_threads,
         o.max_top2, o.trim_qual) = v
        return o


@dataclass
class Aln1:
    """bwt_aln1_t (software/bwtaln.h:43-46)."""
    n_mm: int = 0
    n_gapo: int = 0
    n_gape: int = 0
    score: int = 0
    n_ins: int = 0
    n_del: int = 0
    k: int = 0
    l: int = 0

    def pack(self) -> bytes:
        word = (self.n_mm | (self.n_gapo << 8) | (self.n_gape << 16)
                | (self.score << 24) | (self.n_ins << 44)
                | (self.n_del << 54))
        return struct.pack("<QQQ", word, self.k, self.l)

    @classmethod
    def unpack(cls, raw: bytes) -> "Aln1":
        word, k, l = struct.unpack("<QQQ", raw)
        return cls(n_mm=word & 0xFF, n_gapo=(word >> 8) & 0xFF,
                   n_gape=(word >> 16) & 0xFF,
                   score=(word >> 24) & 0xFFFFF,
                   n_ins=(word >> 44) & 0x3FF, n_del=(word >> 54) & 0x3FF,
                   k=k, l=l)


def cal_maxdiff(length: int, err: float, thres: float) -> int:
    """bwa_cal_maxdiff (software/bwtaln.c:42-54)."""
    elambda = math.exp(-length * err)
    y, x = 1.0, 1
    total = elambda
    for k in range(1, 1000):
        y *= length * err
        x *= k
        total += elambda * y / x
        if 1.0 - total < thres:
            return k
    return 2


def bwt_2occ(fm, k: int, l: int, c: int) -> Tuple[int, int]:
    """bwt_2occ (software/bwt.c:150-181): occ(k,c), occ(l,c)."""
    return fm.occ(k, c), fm.occ(l, c)


def cal_width(fm, length: int, seq: np.ndarray) -> List[Tuple[int, int]]:
    """bwt_cal_width (software/bwtaln.c:57-81): per-position (w, bid)
    lower bounds, plus the sentinel at index `length`."""
    width = [(0, 0)] * (length + 1)
    bid = 0
    k, l = 0, fm.seq_len
    for i in range(length):
        c = int(seq[i])
        if c < 4:
            ok, ol = bwt_2occ(fm, k - 1, l, c)
            k = int(fm.L2[c]) + ok + 1
            l = int(fm.L2[c]) + ol
        if k > l or c > 3:
            k, l = 0, fm.seq_len
            bid += 1
        width[i] = (l - k + 1, bid)
    width[length] = (0, bid + 1)
    return width


def match_exact_alt(fm, length: int, seq: np.ndarray, k: int, l: int
                    ) -> Tuple[bool, int, int]:
    """bwt_match_exact_alt (software/bwt.c:262-280)."""
    for i in range(length - 1, -1, -1):
        c = int(seq[i])
        if c > 3:
            return False, k, l
        ok, ol = bwt_2occ(fm, k - 1, l, c)
        k = int(fm.L2[c]) + ok + 1
        l = int(fm.L2[c]) + ol
        if k > l:
            return False, k, l
    return True, k, l


class GapStack:
    """Priority stack over alignment scores (software/bwtgap.c:17-89):
    pop returns the most recently pushed entry of the lowest score."""

    def __init__(self, n_scores: int):
        self.stacks: List[list] = [[] for _ in range(n_scores)]
        self.n_stacks = n_scores
        self.best = n_scores
        self.n_entries = 0

    def push(self, entry, score: int) -> None:
        self.stacks[score].append(entry)
        self.n_entries += 1
        if self.best > score:
            self.best = score

    def pop(self):
        q = self.stacks[self.best]
        e = q.pop()
        self.n_entries -= 1
        if not q and self.n_entries:
            i = self.best + 1
            while i < self.n_stacks and not self.stacks[i]:
                i += 1
            self.best = i
        elif self.n_entries == 0:
            self.best = self.n_stacks
        return e


def _int_log2(v: int) -> int:
    c = 0
    if v & 0xFFFF0000:
        v >>= 16
        c |= 16
    if v & 0xFF00:
        v >>= 8
        c |= 8
    if v & 0xF0:
        v >>= 4
        c |= 4
    if v & 0xC:
        v >>= 2
        c |= 2
    if v & 0x2:
        c |= 1
    return c


def _gap_shadow(x: int, max_: int, last_diff_pos: int, width) -> None:
    """gap_shadow (software/bwtgap.c:91-102): shrink the width lower
    bounds after a hit is recorded."""
    j = 0
    for i in range(last_diff_pos):
        w, bid = width[i]
        if w > x:
            width[i] = (w - x, bid)
        elif w == x:
            j += 1
            width[i] = (max_ - j, 1)


def match_gap(fm, length: int, seq: np.ndarray, width,
              seed_width, opt: GapOpt, stack_scores: int) -> List[Aln1]:
    """bwt_match_gap (software/bwtgap.c:110-264).  `seq` is the reverse
    complement of the read; `width`/`seed_width` are mutable lists."""
    def aln_score(m, o, e):
        return m * opt.s_mm + o * opt.s_gapo + e * opt.s_gape

    best_score = aln_score(opt.max_diff + 1, opt.max_gapo + 1,
                           opt.max_gape + 1)
    best_diff = opt.max_diff + 1
    max_diff = opt.max_diff
    best_cnt = 0
    aln: List[Aln1] = []

    if int(np.sum(seq > 3)) > max_diff:
        return aln

    stack = GapStack(stack_scores)
    # entry: (info, k, l, n_mm, n_gapo, n_gape, n_ins, n_del, state,
    #         last_diff_pos)
    stack.push((length, 0, fm.seq_len, 0, 0, 0, 0, 0, STATE_M, 0), 0)

    while stack.n_entries:
        if stack.n_entries > opt.max_entries:
            break
        score = stack.best
        (i, k, l, n_mm, n_gapo, n_gape, n_ins, n_del, state,
         last_diff_pos) = stack.pop()
        if not (opt.mode & BWA_MODE_NONSTOP) \
                and score > best_score + opt.s_mm:
            break

        m = max_diff - (n_mm + n_gapo)
        if opt.mode & BWA_MODE_GAPE:
            m -= n_gape
        if m < 0:
            continue
        if seed_width is not None:
            m_seed = opt.max_seed_diff - (n_mm + n_gapo)
            if opt.mode & BWA_MODE_GAPE:
                m_seed -= n_gape
        if i > 0 and m < width[i - 1][1]:
            continue

        hit_found = False
        if i == 0:
            hit_found = True
        elif m == 0 and (state == STATE_M or (opt.mode & BWA_MODE_GAPE)
                         or n_gape == opt.max_gape):
            ok_, k2, l2 = match_exact_alt(fm, i, seq, k, l)
            if ok_:
                k, l = k2, l2
                hit_found = True
            else:
                continue

        if hit_found:
            sc = aln_score(n_mm, n_gapo, n_gape)
            do_add = True
            if not aln:
                best_score = sc
                best_diff = n_mm + n_gapo
                if opt.mode & BWA_MODE_GAPE:
                    best_diff += n_gape
                if not (opt.mode & BWA_MODE_NONSTOP):
                    max_diff = (opt.max_diff
                                if best_diff + 1 > opt.max_diff
                                else best_diff + 1)
            if sc == best_score:
                best_cnt += l - k + 1
            elif best_cnt > opt.max_top2:
                break
            if n_gapo:  # gap in a tandem repeat may rediscover a hit
                if any(a.k == k and a.l == l for a in aln):
                    do_add = False
            if do_add:
                _gap_shadow(l - k + 1, fm.seq_len, last_diff_pos, width)
                aln.append(Aln1(n_mm=n_mm, n_gapo=n_gapo, n_gape=n_gape,
                                n_ins=n_ins, n_del=n_del, k=k, l=l,
                                score=sc))
            continue

        i -= 1
        cnt_k = fm.occ4(k - 1)
        cnt_l = fm.occ4(l)
        occ = l - k + 1

        allow_diff = allow_M = True
        if i > 0:
            ii = i - (length - opt.seed_len)
            if width[i - 1][1] > m - 1:
                allow_diff = False
            elif (width[i - 1][1] == m - 1 and width[i][1] == m - 1
                    and width[i - 1][0] == width[i][0]):
                allow_M = False
            if seed_width is not None and ii > 0:
                if seed_width[ii - 1][1] > m_seed - 1:
                    allow_diff = False
                elif (seed_width[ii - 1][1] == m_seed - 1
                        and seed_width[ii][1] == m_seed - 1
                        and seed_width[ii - 1][0] == seed_width[ii][0]):
                    allow_M = False

        # indels (software/bwtgap.c:215-245)
        tmp = (_int_log2(n_gape + n_gapo) // 2 + 1
               if (opt.mode & BWA_MODE_LOGGAP) else n_gapo + n_gape)
        if (allow_diff and i >= opt.indel_end_skip + tmp
                and length - i >= opt.indel_end_skip + tmp):
            if state == STATE_M:
                if n_gapo < opt.max_gapo:
                    # insertion
                    sc = aln_score(n_mm, n_gapo + 1, n_gape)
                    stack.push((i, k, l, n_mm, n_gapo + 1, n_gape,
                                n_ins + 1, n_del, STATE_I, i), sc)
                    # deletion
                    for j in range(4):
                        dk = int(fm.L2[j]) + int(cnt_k[j]) + 1
                        dl = int(fm.L2[j]) + int(cnt_l[j])
                        if dk <= dl:
                            stack.push((i + 1, dk, dl, n_mm, n_gapo + 1,
                                        n_gape, n_ins, n_del + 1, STATE_D,
                                        i + 1), sc)
            elif state == STATE_I:
                if n_gape < opt.max_gape:
                    sc = aln_score(n_mm, n_gapo, n_gape + 1)
                    stack.push((i, k, l, n_mm, n_gapo, n_gape + 1,
                                n_ins + 1, n_del, STATE_I, i), sc)
            elif state == STATE_D:
                if n_gape < opt.max_gape:
                    if n_gape + n_gapo < max_diff or occ < opt.max_del_occ:
                        sc = aln_score(n_mm, n_gapo, n_gape + 1)
                        for j in range(4):
                            dk = int(fm.L2[j]) + int(cnt_k[j]) + 1
                            dl = int(fm.L2[j]) + int(cnt_l[j])
                            if dk <= dl:
                                stack.push((i + 1, dk, dl, n_mm, n_gapo,
                                            n_gape + 1, n_ins, n_del + 1,
                                            STATE_D, i + 1), sc)

        # mismatches / matches (software/bwtgap.c:247-263)
        if allow_diff and allow_M:
            for j in range(1, 5):
                c = (int(seq[i]) + j) & 3
                is_mm = (j != 4 or int(seq[i]) > 3)
                dk = int(fm.L2[c]) + int(cnt_k[c]) + 1
                dl = int(fm.L2[c]) + int(cnt_l[c])
                if dk <= dl:
                    sc = aln_score(n_mm + is_mm, n_gapo, n_gape)
                    stack.push((i, dk, dl, n_mm + int(is_mm), n_gapo,
                                n_gape, n_ins, n_del, STATE_M,
                                i if is_mm else 0), sc)
        elif int(seq[i]) < 4:
            c = int(seq[i]) & 3
            dk = int(fm.L2[c]) + int(cnt_k[c]) + 1
            dl = int(fm.L2[c]) + int(cnt_l[c])
            if dk <= dl:
                sc = aln_score(n_mm, n_gapo, n_gape)
                stack.push((i, dk, dl, n_mm, n_gapo, n_gape, n_ins,
                            n_del, STATE_M, 0), sc)
    return aln


def cal_sa_reg_gap(fm, reads, opt: GapOpt) -> List[List[Aln1]]:
    """bwa_cal_sa_reg_gap (software/bwtaln.c:83-128) over prepared
    LegacyRead records (seq field = reversed read)."""
    local = GapOpt(**{f: getattr(opt, f) for f in opt.__dataclass_fields__})
    max_len = max((r.len for r in reads), default=0)
    if opt.fnr > 0.0:
        local.max_diff = cal_maxdiff(max_len, BWA_AVG_ERR, opt.fnr)
    if local.max_diff < local.max_gapo:
        local.max_gapo = local.max_diff

    def aln_score(m, o, e):
        return m * local.s_mm + o * local.s_gapo + e * local.s_gape

    stack_scores = aln_score(local.max_diff + 1, local.max_gapo + 1,
                             local.max_gape + 1)
    out = []
    for p in reads:
        rev = p.seq_rev
        w = cal_width(fm, p.len, rev)
        if opt.fnr > 0.0:
            local.max_diff = cal_maxdiff(p.len, BWA_AVG_ERR, opt.fnr)
        local.seed_len = opt.seed_len if opt.seed_len < p.len else 0x7FFFFFFF
        seed_w = None
        if p.len > opt.seed_len:
            seed_w = cal_width(fm, opt.seed_len,
                               rev[p.len - opt.seed_len:])
        # the search string is the complement of the reversed read,
        # i.e. the reverse complement (software/bwtaln.c:117-118)
        rc = np.where(rev > 3, 4, 3 - rev).astype(np.uint8)
        out.append(match_gap(fm, p.len, rc, w, seed_w, local,
                             stack_scores))
    return out
