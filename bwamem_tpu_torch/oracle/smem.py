"""SMEM search — scalar host oracle.

This is the executable specification of the seeding kernel the reference
accelerates in hardware: bwt_smem1's bidirectional forward/backward
search (software/bwt.c:776-835; the FPGA PE implements the same loop,
hardware/afu_core.v:4371-5402, and the batched CPU fallback is
software/bwt.c:299-414), plus the smem_next2 iterator with the
long-unique-SMEM re-seeding pass and ordered merge
(software/bwamem.c:244-305).

Intervals are (x0, x1, s, info) tuples:
  x0 = SA interval start on the forward index,
  x1 = start on the reverse index (bi-interval),
  s  = interval size (number of occurrences),
  info = packed (start<<32 | end) query coordinates.

The batched TPU implementation (bwamem_tpu.ops.smem) is verified to
produce identical interval lists.
"""

import os
from typing import List, Optional, Tuple

Intv = Tuple[int, int, int, int]

# kill switch consistent with the other native-path toggles
_NATIVE = os.environ.get("BWAMEM_TPU_NATIVE_ORACLE", "1") != "0"


def smem1(fm, q, x: int, min_intv: int) -> Tuple[int, List[Intv]]:
    """Collect SMEMs covering position x; return (next_start, mems).

    Dispatches to the C twin (native/hostsmem.cpp) when available —
    the reference's CPU fallback is C too (software/bwt.c:299-414);
    the Python body below remains the executable spec and parity
    oracle."""
    if _NATIVE:
        from . import nsmem
        r = nsmem.smem1_native(fm, q, x, min_intv) \
            if nsmem.available() else None
        if r is not None:
            return r
    return _smem1_py(fm, q, x, min_intv)


def _smem1_py(fm, q, x: int, min_intv: int) -> Tuple[int, List[Intv]]:
    mem: List[Intv] = []
    if q[x] > 3:
        return x + 1, mem
    if min_intv < 1:
        min_intv = 1
    length = len(q)

    ik = fm.set_intv(q[x])
    ik = (ik[0], ik[1], ik[2], x + 1)

    curr: List[Intv] = []
    i = x + 1
    while i < length:  # forward extension
        if q[i] < 4:
            c = 3 - q[i]
            ok = fm.extend(ik, is_back=0)
            if ok[c][2] != ik[2]:  # interval size changed
                curr.append(ik)
                if ok[c][2] < min_intv:
                    break
            ik = (ok[c][0], ok[c][1], ok[c][2], i + 1)
        else:
            curr.append(ik)
            break
        i += 1
    if i == length:
        curr.append(ik)
    curr.reverse()  # longest matches (smallest intervals) first
    ret = curr[0][3]
    prev, curr = curr, []

    i = x - 1
    while i >= -1:  # backward extension
        c = -1 if i < 0 or q[i] > 3 else q[i]
        curr = []
        for p in prev:
            ok = fm.extend(p, is_back=1)
            if c < 0 or ok[c][2] < min_intv:
                if not curr:
                    if not mem or i + 1 < (mem[-1][3] >> 32):
                        mem.append((p[0], p[1], p[2],
                                    (p[3] | ((i + 1) << 32))))
            elif not curr or ok[c][2] != curr[-1][2]:
                curr.append((ok[c][0], ok[c][1], ok[c][2], p[3]))
        if not curr:
            break
        prev = curr
        i -= 1
    mem.reverse()  # sorted by start coordinate
    return ret, mem


class SmemIterator:
    """smem_i equivalent: repeated smem_next2 over one query
    (software/bwamem.c:81-310)."""

    def __init__(self, fm, query):
        self.fm = fm
        self.query = query
        self.start = 0
        self.len = len(query)

    def next(self, split_len: int, split_width: int,
             start_width: int = 1) -> Optional[List[Intv]]:
        fm, q = self.fm, self.query
        if self.start >= self.len or self.start < 0:
            return None
        while self.start < self.len and q[self.start] > 3:
            self.start += 1  # skip ambiguous bases
        if self.start == self.len:
            return None
        ori_start = self.start
        self.start, matches = smem1(fm, q, ori_start, start_width)
        if not matches:
            return matches  # "in theory, we should never come here"

        # longest match
        max_len, max_i = 0, 0
        for i, p in enumerate(matches):
            ln = (p[3] & 0xFFFFFFFF) - (p[3] >> 32)
            if max_len < ln:
                max_len, max_i = ln, i

        if split_len > 0 and max_len >= split_len and matches[max_i][2] <= split_width:
            # re-seed from the middle of the long unique SMEM with
            # min_intv = occ+1
            p = matches[max_i]
            mid = ((p[3] & 0xFFFFFFFF) + (p[3] >> 32)) >> 1
            _, sub = smem1(fm, q, mid, p[2] + 1)
            # ordered merge keeping sub-matches that are >= half the max
            # length and end after the original start
            merged: List[Intv] = []
            i = j = 0
            while i < len(matches) and j < len(sub):
                pi, pj = matches[i], sub[j]
                xi = (pi[3] >> 32 << 32) | (self.len - (pi[3] & 0xFFFFFFFF))
                xj = (pj[3] >> 32 << 32) | (self.len - (pj[3] & 0xFFFFFFFF))
                if xi < xj:
                    merged.append(pi)
                    i += 1
                elif ((pj[3] & 0xFFFFFFFF) - (pj[3] >> 32) >= (max_len >> 1)
                        and (pj[3] & 0xFFFFFFFF) > ori_start):
                    merged.append(pj)
                    j += 1
                else:
                    j += 1
            merged.extend(matches[i:])
            for pj in sub[j:]:
                if ((pj[3] & 0xFFFFFFFF) - (pj[3] >> 32) >= (max_len >> 1)
                        and (pj[3] & 0xFFFFFFFF) > ori_start):
                    merged.append(pj)
            matches = merged
        return matches
