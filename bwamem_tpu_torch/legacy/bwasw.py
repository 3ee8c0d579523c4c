"""bwa bwasw (bwtsw2): the long-read aligner.

Transcribed from the reference:
  bwt_lite (BWT of the read)            software/bwt_lite.c
  bsw2_core DAG-vs-prefix-trie DP       software/bwtsw2_core.c
  chain filter                          software/bwtsw2_chain.c
  extension, CIGAR, SAM output          software/bwtsw2_aux.c
  read pairing / mate rescue            software/bwtsw2_pair.c

The dynamic programming aligns the *read's* suffix DAG (via a
lightweight BWT of the read) against the *genome's* prefix trie (the
main FM index), keeping the z best cells per node; narrow SA hits seed
banded extensions.  drand48 (seed 11) drives both N-base substitution
and the random top-hit shuffle, so the glibc LCG stream is reproduced
exactly for byte-identical SAM.
"""

import math
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..index.bntseq import NT4_TABLE, get_seq
from ..oracle import ksw as oksw
from ..utils.ksort import ks_introsort
from ..utils.rand48 import Rand48

MINUS_INF = -0x3FFFFFFF
MASK_LEVEL = 0.90

BSW2_FLAG_MATESW = 0x100
BSW2_FLAG_TANDEM = 0x200
BSW2_FLAG_MOVED = 0x400
BSW2_FLAG_RESCUED = 0x800

NT_COMP = {}
_comp_src = "NNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNN" \
    "NTVGHNNCDNNMNKNNNNYSANBWXRNNNNNN" \
    "ntvghnncdnnmnknnnnysanbwxrnNNNNN"
for _i, _c in enumerate(_comp_src):
    NT_COMP[_i] = _c


def _comp_base(ch: str) -> str:
    o = ord(ch)
    return NT_COMP.get(o, "N") if o < 128 else "N"


@dataclass
class Bsw2Opt:
    skip_sw: int = 0
    cpy_cmt: int = 0
    hard_clip: int = 0
    a: int = 1
    b: int = 3
    q: int = 5
    r: int = 2
    t: int = 30
    qr: int = 7
    bw: int = 50
    max_ins: int = 20000
    max_chain_gap: int = 10000
    z: int = 1
    is_: int = 3
    t_seeds: int = 5
    multi_2nd: int = 0
    mask_level: float = 0.50
    coef: float = 5.5
    n_threads: int = 1
    chunk_size: int = 10000000

    def copy(self):
        import copy as _c
        return _c.copy(self)


@dataclass
class Hit:
    """bsw2hit_t."""
    k: int = 0
    l: int = 0
    flag: int = 0
    n_seeds: int = 0
    is_rev: int = 0
    len: int = 0
    G: int = 0
    G2: int = 0
    beg: int = 0
    end: int = 0

    def copy(self):
        import copy as _c
        return _c.copy(self)


@dataclass
class Aux:
    """bsw2aux_t."""
    flag: int = 0
    nn: int = 0
    chr: int = -1
    pos: int = -1
    qual: int = 0
    mchr: int = -1
    mpos: int = -1
    pqual: int = 0
    isize: int = 0
    nm: int = 0
    cigar: Optional[List[int]] = None  # len<<4|op


class Cell:
    __slots__ = ("qk", "ql", "I", "D", "G", "pj", "qlen", "tlen",
                 "ppos", "upos", "cpos")

    def __init__(self):
        self.qk = 0
        self.ql = 0
        self.I = MINUS_INF
        self.D = MINUS_INF
        self.G = MINUS_INF
        self.pj = 0
        self.qlen = 0
        self.tlen = 0
        self.ppos = -1
        self.upos = -1
        self.cpos = [-1, -1, -1, -1]


class Entry:
    __slots__ = ("tk", "tl", "array")

    def __init__(self, tk=0, tl=0):
        self.tk = tk
        self.tl = tl
        self.array: List[Cell] = []

    @property
    def n(self):
        return len(self.array)


class Bwtl:
    """bwt_lite of the read (software/bwt_lite.c)."""

    def __init__(self, seq: np.ndarray):
        from ..index.suffix_array import suffix_array
        n = len(seq)
        self.seq_len = n
        sa = suffix_array(seq.astype(np.uint8))
        self.sa = sa.astype(np.int64)
        self.primary = int(np.nonzero(sa == 0)[0][0])
        s = np.zeros(n + 1, dtype=np.uint8)
        nz = sa != 0
        s[nz] = seq[sa[nz] - 1]
        s = np.concatenate([s[:self.primary], s[self.primary + 1:]])
        self.bwt_str = s[:n]
        # occ checkpoints every 16 bases + L2
        self.occ16 = np.zeros(((n + 15) // 16, 4), dtype=np.int64)
        c = np.zeros(4, dtype=np.int64)
        for i in range(n):
            if i % 16 == 0:
                self.occ16[i // 16] = c
            c[self.bwt_str[i]] += 1
        self.L2 = np.zeros(5, dtype=np.int64)
        self.L2[1:] = np.cumsum(c)

    def occ4(self, k: int) -> np.ndarray:
        """bwtl_occ4 (software/bwt_lite.c:75-89)."""
        if k == -1:
            return np.zeros(4, dtype=np.int64)
        if k >= self.primary:
            k -= 1
        cnt = self.occ16[k >> 4].copy()
        for i in range((k >> 4) << 4, k + 1):
            cnt[self.bwt_str[i]] += 1
        return cnt

    def occ2_4(self, k, l):
        return self.occ4(k), self.occ4(l)


def _hitG_key(a: Hit, b: Hit) -> bool:
    """__hitG_lt: (G + n_seeds*4) descending."""
    return (a.G + (a.n_seeds << 2)) > (b.G + (b.n_seeds << 2))


def connectivity(bwtl: Bwtl) -> dict:
    """bsw2_connectivity: in-degree count of every interval node."""
    h = {}
    stack = [(0, bwtl.seq_len)]  # root: the full interval
    while stack:
        k, l = stack.pop()
        cntk, cntl = bwtl.occ2_4(k - 1, l)
        for j in range(4):
            nk = int(bwtl.L2[j]) + int(cntk[j]) + 1
            nl = int(bwtl.L2[j]) + int(cntl[j])
            if nk > nl:
                continue
            key = (nk, nl)
            if key not in h:
                h[key] = [1, 0]  # [cnt, pending_pos]
                stack.append(key)
            else:
                h[key][0] += 1
    return h


def cut_tail(u: Entry, T: int) -> None:
    """cut_tail (software/bwtsw2_core.c:131-155)."""
    if u.n <= T:
        return
    a = [-p.G for p in u.array if p.ql and p.G > 0]
    if len(a) <= T:
        return
    x = -sorted(a)[T]
    n = 0
    for p in u.array:
        if p.G == x:
            n += 1
        if p.G < x or (p.G == x and n >= T):
            p.qk = p.ql = 0
            p.G = 0
            if p.ppos >= 0:
                u.array[p.ppos].cpos[p.pj] = -1


def remove_duplicate(u: Entry) -> None:
    """remove_duplicate (software/bwtsw2_core.c:157-180)."""
    h = {}
    for i, p in enumerate(u.array):
        if p.ql == 0:
            continue
        key = (p.qk, p.ql)
        j = -1
        if key in h:
            vi, vg = h[key]
            if vg >= p.G:
                j = i
            else:
                j = vi
                h[key] = (i, p.G)
        else:
            h[key] = (i, p.G)
        if j >= 0:
            q = u.array[j]
            q.qk = q.ql = 0
            q.G = 0
            if q.ppos >= 0:
                u.array[q.ppos].cpos[q.pj] = -3
    return


def merge_entry(u: Entry, v: Entry) -> None:
    off = u.n
    for p in v.array:
        if p.ppos >= 0:
            p.ppos += off
        for j in range(4):
            if p.cpos[j] >= 0:
                p.cpos[j] += off
    u.array.extend(v.array)


def save_hits(bwtl: Bwtl, thres: int, hits: List[Hit], u: Entry) -> None:
    for p in u.array:
        if p.G < thres:
            continue
        for k in range(u.tk, u.tl + 1):
            beg = int(bwtl.sa[k])
            end = beg + p.tlen
            q = None
            if p.G > hits[beg * 2].G:
                hits[beg * 2 + 1] = hits[beg * 2]
                q = hits[beg * 2] = Hit()
            elif p.G > hits[beg * 2 + 1].G:
                q = hits[beg * 2 + 1] = Hit()
            if q is not None:
                q.k, q.l, q.len, q.G = p.qk, p.ql, p.qlen, p.G
                q.beg, q.end = beg, end
                q.G2 = 0 if q.k == q.l else q.G
                q.flag = q.n_seeds = 0


def save_narrow_hits(bwtl: Bwtl, u: Entry, b1: List[Hit], t: int,
                     IS: int) -> None:
    for p in u.array:
        if p.G >= t and p.ql - p.qk + 1 <= IS:
            q = Hit()
            q.k, q.l = p.qk, p.ql
            q.len = p.qlen
            q.G, q.G2 = p.G, 0
            q.beg = int(bwtl.sa[u.tk])
            q.end = q.beg + p.tlen
            q.flag = 0
            b1.append(q)
            p.qk = p.ql = 0
            p.G = 0
            if p.ppos >= 0:
                u.array[p.ppos].cpos[p.pj] = -3


def resolve_duphits(bns, fm, hits: List[Hit], IS: int) -> List[Hit]:
    """bsw2_resolve_duphits (software/bwtsw2_core.c:252-322)."""
    if not hits:
        return []
    if fm is not None and bns is not None:
        new = []
        for p in hits:
            if p.l - p.k + 1 <= IS:
                if p.G == 0 and p.k == 0 and p.l == 0 and p.len == 0:
                    continue
                for k in range(p.k, p.l + 1):
                    q = p.copy()
                    pos, is_rev = bns.depos(fm.sa_lookup(k))
                    q.k = pos
                    q.l = 0
                    q.is_rev = int(is_rev)
                    if is_rev:
                        q.k -= p.len - 1
                    new.append(q)
            elif p.G > 0:
                q = p.copy()
                pos, is_rev = bns.depos(fm.sa_lookup(p.k))
                q.k = pos
                q.l = 0
                q.flag |= 1
                q.is_rev = int(is_rev)
                if is_rev:
                    q.k -= p.len - 1
                new.append(q)
        hits = new
    hits = [p for p in hits if p.G]
    ks_introsort(hits, _hitG_key)
    for i in range(1, len(hits)):
        p = hits[i]
        for j in range(i):
            q = hits[j]
            compatible = True
            if p.is_rev != q.is_rev:
                continue
            if p.l == 0 and q.l == 0:
                qol = min(p.end, q.end) - max(p.beg, q.beg)
                if qol < 0:
                    qol = 0
                if (qol / (p.end - p.beg) > MASK_LEVEL
                        or qol / (q.end - q.beg) > MASK_LEVEL):
                    tol = (min(p.k + p.len, q.k + q.len)
                           - max(p.k, q.k))
                    if (tol / p.len > MASK_LEVEL
                            or tol / q.len > MASK_LEVEL):
                        compatible = False
            if not compatible:
                p.G = 0
                if q.G2 < p.G2:
                    q.G2 = p.G2
                break
    return [p for p in hits if p.G]


def resolve_query_overlaps(hits: List[Hit], mask_level: float,
                           rng: Rand48) -> List[Hit]:
    """bsw2_resolve_query_overlaps (software/bwtsw2_core.c:324-372)."""
    if not hits:
        return []
    ks_introsort(hits, _hitG_key)
    G0 = hits[0].G
    i = 1
    while i < len(hits) and hits[i].G == G0:
        i += 1
    j = int(i * rng.drand48())
    if j:
        hits[0], hits[j] = hits[j], hits[0]
    n = len(hits)
    stop = n
    for i in range(1, len(hits)):
        p = hits[i]
        all_compatible = True
        if p.G == 0:
            stop = i
            break
        for j in range(i):
            q = hits[j]
            if q.G == 0:
                continue
            tol = 0
            qol = min(p.end, q.end) - max(p.beg, q.beg)
            if qol < 0:
                qol = 0
            if p.l == 0 and q.l == 0:
                tol = (min(p.k + p.len, q.k + q.len)
                       - max(p.k, q.k))
                if tol < 0:
                    tol = 0
            fol = qol / min(p.end - p.beg, q.end - q.beg)
            compatible = (fol < mask_level
                          or (tol > 0 and qol < p.end - p.beg
                              and qol < q.end - q.beg))
            if not compatible:
                if q.G2 < p.G:
                    q.G2 = p.G
                all_compatible = False
        if not all_compatible:
            p.G = 0
    return [p for p in hits[:stop] if p.G]


def fill_cell(opt: Bsw2Opt, match_score: int, c) -> int:
    """fill_cell (software/bwtsw2_core.c:398-411); c = [curr, I, D, G]."""
    G = c[3].G + match_score if c[3] is not None else MINUS_INF
    if c[1] is not None:
        c[0].I = (c[1].I - opt.r if c[1].I > c[1].G - opt.q
                  else c[1].G - opt.qr)
        if c[0].I > G:
            G = c[0].I
    else:
        c[0].I = MINUS_INF
    if c[2] is not None:
        c[0].D = (c[2].D - opt.r if c[2].D > c[2].G - opt.q
                  else c[2].G - opt.qr)
        if c[0].D > G:
            G = c[0].D
    else:
        c[0].D = MINUS_INF
    c[0].G = G
    return G


def bsw2_core(bns, opt: Bsw2Opt, target: Bwtl, fm):
    """bsw2_core (software/bwtsw2_core.c:434-...): target = read BWT,
    fm = genome FM index.  Returns (all_hits, narrow_hits)."""
    import heapq

    chash = connectivity(target)
    score_mat = [[opt.a if i == j else -opt.b for j in range(4)]
                 for i in range(4)]
    stack0: List[Entry] = []
    pending: List[Optional[Entry]] = []
    n_pending = 0

    root = Entry(0, target.seq_len)
    x = Cell()
    x.G = 0
    x.qk = 0
    x.ql = fm.seq_len
    root.array.append(x)
    stack0.append(root)

    b_hits = [Hit() for _ in range(target.seq_len * 2)]
    b1: List[Hit] = []

    while stack0:
        v = stack0.pop()
        old_n = v.n
        for p in v.array:
            if p.ql == 0:
                continue
            if p.tlen - p.qlen > opt.bw or p.qlen - p.tlen > opt.bw:
                p.qk = p.ql = 0
                if p.ppos >= 0:
                    v.array[p.ppos].cpos[p.pj] = -5
        tcntk, tcntl = target.occ2_4(v.tk - 1, v.tl)
        for tj in range(4):
            k = int(target.L2[tj]) + int(tcntk[tj]) + 1
            l = int(target.L2[tj]) + int(tcntl[tj])
            if k > l:
                continue
            ent = chash[(k, l)]
            ent[0] -= 1
            u = Entry(k, l)
            curr_mat = score_mat[tj]
            # min-heap over kept scores; z entries initialized to 0
            heap = [0] * opt.z
            i = 0
            while i < v.n:
                p = v.array[i]
                if p.ql == 0:
                    i += 1
                    continue
                x = Cell()
                c1 = c2 = c3 = None
                is_added = False
                p.upos = -1
                if p.ppos >= 0:
                    par = v.array[p.ppos]
                    c1 = u.array[par.upos] if par.upos >= 0 else None
                    c3 = par
                    c2 = p
                    if fill_cell(opt, curr_mat[p.pj], [x, c1, c2, c3]) > 0:
                        x.ppos = par.upos
                        p.upos = u.n
                        u.array.append(x)
                        if x.ppos >= 0:
                            u.array[x.ppos].cpos[p.pj] = p.upos
                        is_added = True
                else:
                    x.D = (p.D - opt.r if p.D > p.G - opt.q
                           else p.G - opt.qr)
                    if x.D > 0:
                        x.G = x.D
                        x.I = MINUS_INF
                        x.ppos = -1
                        p.upos = u.n
                        u.array.append(x)
                        is_added = True
                if is_added:
                    x.cpos = [-1, -1, -1, -1]
                    x.pj = p.pj
                    x.qk = p.qk
                    x.ql = p.ql
                    x.qlen = p.qlen
                    x.tlen = p.tlen + 1
                    if x.G > heap[0]:
                        heapq.heapreplace(heap, x.G)
                if (x.G > opt.qr and x.G >= heap[0]) or i < old_n:
                    if -1 in p.cpos:
                        qcntk = fm.occ4(p.qk - 1)
                        qcntl = fm.occ4(p.ql)
                        for qj in range(4):
                            if p.cpos[qj] != -1:
                                continue
                            nk = int(fm.L2[qj]) + int(qcntk[qj]) + 1
                            nl = int(fm.L2[qj]) + int(qcntl[qj])
                            if nk > nl:
                                p.cpos[qj] = -2
                                continue
                            y = Cell()
                            y.qk = nk
                            y.ql = nl
                            y.pj = qj
                            y.qlen = p.qlen + 1
                            y.ppos = i
                            y.tlen = p.tlen
                            p.cpos[qj] = v.n
                            v.array.append(y)
                i += 1
            if u.n:
                save_hits(target, opt.t, b_hits, u)
            cnt, pos = ent
            if pos:
                w = pending[pos - 1]
                if u.n:
                    if w.n < u.n:
                        pending[pos - 1] = u
                        w, u = u, w
                        w = pending[pos - 1]
                    merge_entry(w, u)
                if cnt == 0:
                    remove_duplicate(w)
                    save_narrow_hits(target, w, b1, opt.t, opt.is_)
                    cut_tail(w, opt.z)
                    stack0.append(w)
                    pending[pos - 1] = None
                    n_pending -= 1
            elif cnt:
                if u.n:
                    n_pending += 1
                    pending.append(u)
                    ent[1] = len(pending)
            else:
                save_narrow_hits(target, u, b1, opt.t, opt.is_)
                cut_tail(u, opt.z)
                stack0.append(u)
    for p in b_hits:
        p.n_seeds = 0
    for p in b1:
        p.n_seeds = 0
    all_hits = resolve_duphits(bns, fm, b_hits, opt.is_)
    narrow = resolve_duphits(bns, fm, b1, opt.is_)
    return all_hits, narrow


# ---------------------------------------------------------------------------
# chain filter (software/bwtsw2_chain.c)
# ---------------------------------------------------------------------------

class _Hsaip:
    __slots__ = ("tbeg", "tend", "qbeg", "qend", "flag", "idx", "chain")

    def __init__(self):
        self.tbeg = self.tend = 0
        self.qbeg = self.qend = 0
        self.flag = 0
        self.idx = 0
        self.chain = -1


def _chaining(opt: Bsw2Opt, shift: int, z: List[_Hsaip],
              chain: List[_Hsaip]) -> int:
    ks_introsort(z, lambda a, b: a.qbeg < b.qbeg)
    m = 0
    for p in z:
        k = m - 1
        while k >= 0:
            q = chain[k]
            x = p.qbeg - q.qbeg
            y = p.tbeg - q.tbeg
            if (y > 0 and x < opt.max_chain_gap and y < opt.max_chain_gap
                    and x - y <= opt.bw and y - x <= opt.bw):
                if p.qend > q.qend:
                    q.qend = p.qend
                if p.tend > q.tend:
                    q.tend = p.tend
                q.chain += 1
                p.chain = shift + k
                break
            elif q.chain > opt.t_seeds * 2:
                k = 0
            k -= 1
        if k < 0:
            c = _Hsaip()
            c.tbeg, c.tend = p.tbeg, p.tend
            c.qbeg, c.qend = p.qbeg, p.qend
            c.flag = p.flag
            c.chain = 1
            c.idx = p.chain = shift + m
            chain.append(c)
            m += 1
    return m


def chain_filter(opt: Bsw2Opt, length: int, b: List[List[Hit]]) -> None:
    """bsw2_chain_filter (software/bwtsw2_chain.c:52-...)."""
    thres = opt.t_seeds * 2
    z = [[], []]
    for k in range(2):
        for i, p in enumerate(b[k]):
            q = _Hsaip()
            q.flag = k
            q.idx = i
            q.tbeg, q.tend = p.k, p.k + p.len
            q.qbeg, q.qend = p.beg, p.end
            z[k].append(q)
    chain0: List[_Hsaip] = []
    m0 = _chaining(opt, 0, z[0], chain0)
    chain1: List[_Hsaip] = []
    m1 = _chaining(opt, m0, z[1], chain1)
    for p in chain1:
        tmp = p.qbeg
        p.qbeg = length - p.qend
        p.qend = length - tmp
    allchain = chain0 + chain1
    flag = [0] * (m0 + m1)
    ks_introsort(allchain, lambda a, b: a.qbeg < b.qbeg)
    for k in range(1, len(allchain)):
        p = allchain[k]
        for j in range(k):
            q = allchain[j]
            if flag[q.idx]:
                continue
            if (q.qend >= p.qend and q.chain > p.chain * thres
                    and p.chain < thres):
                flag[p.idx] = 1
                break
    for k in range(2):
        for p in z[k]:
            if flag[p.chain]:
                b[p.flag][p.idx].G = 0
    for k in range(2):
        b[k][:] = [p for p in b[k] if p.G]


# ---------------------------------------------------------------------------
# extension + CIGAR (software/bwtsw2_aux.c)
# ---------------------------------------------------------------------------

def _ksw_extend(query, target, mat, q_gap, r_gap, w, h0):
    """ksw_extend (software/ksw.c:478-481): extend2 with symmetric gap
    penalties, no end bonus, no z-drop; returns (score, qle, tle)."""
    sc, qle, tle, _gt, _gs, _mo = oksw.ksw_extend2(
        query, target, mat, q_gap, r_gap, q_gap, r_gap, w, 0, -1, h0)
    return sc, qle, tle


def extend_left(opt: Bsw2Opt, hits: List[Hit], query_fwd: np.ndarray,
                lq: int, bns, mat) -> None:
    """bsw2_extend_left (software/bwtsw2_aux.c:103-141)."""
    pac = bns.pac
    ks_introsort(hits, lambda a, b: a.end > b.end)
    rquery = query_fwd[::-1].copy()
    for i, p in enumerate(hits):
        p.n_seeds = 1
        if p.l or p.k == 0:
            continue
        score = 0
        for j in range(i):
            q = hits[j]
            if (q.beg <= p.beg and q.k <= p.k
                    and q.k + q.len >= p.k + p.len):
                if q.n_seeds < (1 << 13) - 2:
                    q.n_seeds += 1
                score += 1
        if score:
            continue
        lt = ((p.beg + 1) // 2 * opt.a + opt.r) // opt.r + lq
        if lt > p.k:
            lt = p.k
        # target = reversed reference upstream of p.k (k=0 not included)
        lo = p.k - lt
        seg = get_seq(bns.l_pac, pac, max(lo, 1), p.k)
        target = seg[::-1].copy()
        lt = len(target)
        sc, qle, tle = _ksw_extend(rquery[lq - p.beg:], target, mat,
                                   opt.q, opt.r, opt.bw, p.G)
        if sc > p.G:
            p.G = sc
            p.k -= tle
            p.len += tle
            p.beg -= qle


def extend_rght(opt: Bsw2Opt, hits: List[Hit], query_fwd: np.ndarray,
                lq: int, bns, mat) -> None:
    """bsw2_extend_rght (software/bwtsw2_aux.c:143-169)."""
    pac = bns.pac
    for p in hits:
        if p.l:
            continue
        lt = ((lq - p.beg + 1) // 2 * opt.a + opt.r) // opt.r + lq
        hi = min(p.k + lt, bns.l_pac)
        target = get_seq(bns.l_pac, pac, p.k, hi)
        sc, qle, tle = _ksw_extend(query_fwd[p.beg:], target, mat,
                                   opt.q, opt.r, opt.bw, 1)
        sc -= 1
        if sc >= p.G:
            p.G = sc
            p.len = tle
            p.end = p.beg + qle


def merge_hits2(b: List[List[Hit]], l: int, is_reverse: bool) -> List[Hit]:
    """merge_hits (software/bwtsw2_aux.c:232-252): b[1] into b[0]."""
    for p in b[1]:
        if is_reverse:
            x = p.beg
            p.beg = l - p.end
            p.end = l - x
            p.flag |= 0x10
        b[0].append(p)
    b[1] = []
    return b[0]


def aln1_core(opt: Bsw2Opt, bns, fm, l: int, seq_fwd: np.ndarray,
              seq_rc: np.ndarray, rng: Rand48, mat) -> List[Hit]:
    """bsw2_aln1_core (software/bwtsw2_aux.c:254-295)."""
    query = Bwtl(seq_fwd)
    all_hits, narrow = bsw2_core(bns, opt, query, fm)
    # split by strand: bb[is_rev][k]
    bb = [[[], []], [[], []]]
    for k, hits in enumerate((all_hits, narrow)):
        for h in hits:
            q = h.copy()
            if h.is_rev:
                x = q.beg
                q.beg = l - q.end
                q.end = l - x
            bb[h.is_rev][k].append(q)
    b = [bb[0][1], bb[1][1]]  # narrow SA hits per strand
    chain_filter(opt, l, b)
    bb[0][1], bb[1][1] = b[0], b[1]
    out = [None, None]
    for k in range(2):
        sk = seq_fwd if k == 0 else seq_rc
        extend_left(opt, bb[k][1], sk, l, bns, mat)
        merged = merge_hits2([bb[k][0], bb[k][1]], l, False)
        merged = resolve_duphits(None, None, merged, 0)
        extend_rght(opt, merged, sk, l, bns, mat)
        merged = resolve_duphits(None, None, merged, 0)
        out[k] = merged
    hits = merge_hits2([out[0], out[1]], l, True)
    hits = resolve_query_overlaps(hits, opt.mask_level, rng)
    return hits


def flag_fr(b: List[List[Hit]]) -> None:
    for p in b[0]:
        p.flag |= 0x10000
    for p in b[1]:
        p.flag |= 0x20000
    for p in b[0]:
        for q in b[1]:
            if (q.beg == p.beg and q.end == p.end and q.k == p.k
                    and q.len == p.len and q.G == p.G):
                q.flag |= 0x30000
                p.flag |= 0x30000
                break


def fix_cigar(bns, p: Hit, cigar: List[int]) -> List[int]:
    """fix_cigar (software/bwtsw2_aux.c:327-389): split an alignment
    crossing a contig boundary, keeping the longer part."""
    seqid = bns.pos2rid(p.k)
    coor = p.k - bns.anns[seqid].offset
    refl = bns.anns[seqid].length
    x, y = coor, 0
    for c in cigar:
        op, ln = c & 0xF, c >> 4
        if op in (1, 4, 5):
            y += ln
        elif op == 2:
            x += ln
        else:
            x += ln
            y += ln
    lq = y
    if x <= refl:
        return cigar
    nc = 0
    mq = [0, 0]
    nlen = [0, 0]
    cn: List[int] = []
    kk = 0
    x, y = coor, 0
    for c in cigar:
        op, ln = c & 0xF, c >> 4
        if op in (4, 5, 1):
            y += ln
            cn.append(c)
        elif op == 2:
            if x + ln >= refl and nc == 0:
                cn.append((lq - y) << 4 | 4)
                nc = len(cn)
                cn.append(y << 4 | 4)
                kk = p.k + (x + ln - refl)
                nlen[0] = x - coor
                nlen[1] = p.len - nlen[0] - ln
            else:
                cn.append(c)
            x += ln
        elif op == 0:
            if x + ln >= refl and nc == 0:
                cn.append((refl - x) << 4 | 0)
                cn.append((lq - y - (refl - x)) << 4 | 4)
                nc = len(cn)
                mq[0] += refl - x
                cn.append((y + (refl - x)) << 4 | 4)
                if x + ln - refl:
                    cn.append((x + ln - refl) << 4 | 0)
                mq[1] += x + ln - refl
                kk = bns.anns[seqid].offset + refl
                nlen[0] = refl - coor
                nlen[1] = p.len - nlen[0]
            else:
                cn.append(c)
                mq[1 if nc else 0] += ln
            x += ln
            y += ln
    if mq[0] > mq[1]:
        p.len = nlen[0]
        return cn[:nc]
    p.k = kk
    p.len = nlen[1]
    return cn[nc:]


def gen_cigar_all(opt: Bsw2Opt, lq: int, seqs, bns, hits: List[Hit],
                  auxs: List[Aux]) -> None:
    """gen_cigar (software/bwtsw2_aux.c:172-214)."""
    from ..config import fill_scmat
    from ..core.align import gen_cigar as core_gen_cigar
    mat = fill_scmat(opt.a, opt.b)
    for p, q in zip(hits, auxs):
        if p.l:
            continue
        beg = lq - p.end if (p.flag & 0x10) else p.beg
        end = lq - p.beg if (p.flag & 0x10) else p.end
        query = seqs[1 if (p.flag & 0x10) else 0][beg:end]
        cigar, _md, _sc, nm = core_gen_cigar(
            mat, opt.q, opt.r, opt.q, opt.r, opt.bw, bns.l_pac, bns.pac,
            query, p.k, p.k + p.len)
        q.nm = nm
        q.cigar = list(cigar) if cigar else None
        if q.cigar and (beg != 0 or end < lq):
            if beg != 0:
                q.cigar = [beg << 4 | 4] + q.cigar
            if end < lq:
                q.cigar = q.cigar + [(lq - end) << 4 | 4]


def write_aux(opt: Bsw2Opt, bns, qlen: int, seqs, hits: List[Hit],
              name: str) -> List[Aux]:
    """write_aux (software/bwtsw2_aux.c:391-427)."""
    auxs = [Aux() for _ in hits]
    gen_cigar_all(opt, qlen, seqs, bns, hits, auxs)
    for p, q in zip(hits, auxs):
        q.flag = p.flag & 0xFE
        q.isize = 0
        if p.l == 0:
            c = 1.0
            if q.cigar:
                q.cigar = fix_cigar(bns, p, q.cigar)
            subo = p.G2 if p.G2 > opt.t else opt.t
            if (p.flag >> 16) in (1, 2):
                c *= .5
            if p.n_seeds < 2:
                c *= .2
            q.qual = int(c * (p.G - subo)
                         * (250.0 / p.G + 0.03 / opt.a) + .499)
            q.qual = max(0, min(250, q.qual))
            if p.flag & 1:
                q.qual = 0  # random hit
            q.pqual = q.qual
            q.chr = bns.pos2rid(p.k)
            q.nn = bns.cnt_ambi(p.k, p.len)
            q.pos = p.k - bns.anns[q.chr].offset
        else:
            q.qual = 0
            q.cigar = None
            q.chr = q.pos = -1
            q.nn = 0
    return auxs


def update_mate_aux(hits, auxs, mhits, mauxs) -> None:
    """update_mate_aux (software/bwtsw2_aux.c:429-466)."""
    if mhits is None:
        return
    for i, q in enumerate(auxs):
        q.flag |= 1
        if len(mhits) == 0:
            q.flag |= 8
        if len(mhits) == 1:
            q.mchr = mauxs[0].chr
            q.mpos = mauxs[0].pos
            if mauxs[0].flag & 0x10:
                q.flag |= 0x20
            if q.chr == q.mchr:
                if q.mpos + mhits[0].len > q.pos:
                    q.isize = q.mpos + mhits[0].len - q.pos
                else:
                    q.isize = q.mpos - q.pos - hits[0].len
            else:
                q.isize = 0
        else:
            q.mchr = q.mpos = -1
    if len(hits) == 1 and len(mhits) == 1:
        p = hits[0]
        if p.flag & BSW2_FLAG_MATESW:
            if not (p.flag & BSW2_FLAG_TANDEM) and auxs[0].pqual < 20:
                auxs[0].pqual = 20
            if auxs[0].pqual >= mauxs[0].qual:
                auxs[0].pqual = mauxs[0].qual
        elif (p.flag & 2) and not (mhits[0].flag & BSW2_FLAG_MATESW):
            if not (p.flag & BSW2_FLAG_TANDEM):
                auxs[0].pqual += 20
                if auxs[0].pqual > mauxs[0].qual:
                    auxs[0].pqual = mauxs[0].qual
                if auxs[0].pqual < auxs[0].qual:
                    auxs[0].pqual = auxs[0].qual


def print_hits(bns, opt: Bsw2Opt, read, hits, auxs, is_pe: bool) -> str:
    """print_hits (software/bwtsw2_aux.c:469-541)."""
    out = []
    name = read.name
    seq = read.seq
    qual = read.qual
    l = len(seq)
    if hits is None or len(hits) == 0:
        line = "%s\t4\t*\t0\t0\t*\t*\t0\t0\t%s" % (name, seq)
        line += "\t%s" % qual if qual else "\t*"
        out.append(line + "\n")
    for i, (p, q) in enumerate(zip(hits or [], auxs or [])):
        if q.cigar is None:
            q.flag |= 0x4
        s = "%s\t%d" % (name, q.flag | (0x100 if (opt.multi_2nd and i)
                                        else 0))
        s += "\t%s\t%d" % (bns.anns[q.chr].name if q.chr >= 0 else "*",
                           q.pos + 1)
        if p.l == 0 and q.cigar:
            s += "\t%d\t" % q.pqual
            ops = "MIDNHHP" if opt.hard_clip else "MIDNSHP"
            for c in q.cigar:
                s += "%d%c" % (c >> 4, ops[c & 0xF])
        else:
            s += "\t0\t*"
        if not is_pe:
            s += "\t*\t0\t0\t"
        else:
            s += "\t%s\t%d\t%d\t" % (
                "=" if q.mchr == q.chr
                else ("*" if q.mchr < 0 else bns.anns[q.mchr].name),
                q.mpos + 1, q.isize)
        beg, end = 0, l
        if opt.hard_clip and q.cigar:
            if (q.cigar[0] & 0xF) == 4:
                beg += q.cigar[0] >> 4
            if (q.cigar[-1] & 0xF) == 4:
                end -= q.cigar[-1] >> 4
        if p.flag & 0x10:
            s += "".join(_comp_base(seq[l - 1 - j]) for j in range(beg, end))
        else:
            s += seq[beg:end]
        if qual:
            s += "\t"
            if p.flag & 0x10:
                s += "".join(qual[l - 1 - j] for j in range(beg, end))
            else:
                s += qual[beg:end]
        else:
            s += "\t*"
        s += "\tAS:i:%d\tXS:i:%d\tXF:i:%d\tXE:i:%d\tNM:i:%d" % (
            p.G, p.G2, p.flag >> 16, p.n_seeds, q.nm)
        if q.nn:
            s += "\tXN:i:%d" % q.nn
        if p.l:
            s += "\tXI:i:%d" % (p.l - p.k + 1)
        type_ = 0
        if p.flag & BSW2_FLAG_MATESW:
            type_ |= 1
        if p.flag & BSW2_FLAG_TANDEM:
            type_ |= 2
        if type_:
            s += "\tXT:i:%d" % type_
        if opt.cpy_cmt and read.comment:
            c = read.comment
            if len(c) >= 6 and c[2] == ":" and c[4] == ":":
                s += "\t" + c
        out.append(s + "\n")
    return "".join(out)


def update_opt(src: Bsw2Opt, qlen: int) -> Bsw2Opt:
    """update_opt (software/bwtsw2_aux.c:545-557)."""
    dst = src.copy()
    ll = math.log(qlen)
    if dst.t < ll * dst.coef:
        dst.t = int(ll * dst.coef + .499)
    k = (qlen * dst.a - 2 * dst.q) // (2 * dst.r + dst.a)
    i = (qlen * dst.a - dst.a - dst.t) // dst.r
    if k > i:
        k = i
    if k < 1:
        k = 1
    dst.bw = src.bw if src.bw < k else k
    return dst


# ---------------------------------------------------------------------------
# pairing (software/bwtsw2_pair.c)
# ---------------------------------------------------------------------------

@dataclass
class PeStat2:
    low: int = 0
    high: int = 0
    failed: int = 0
    avg: float = 0.0
    std: float = 0.0


MAX_STDDEV = 4.0
EXT_STDDEV = 4.0


def bsw2_stat(bufs, max_ins: int) -> PeStat2:
    """bsw2_stat (software/bwtsw2_pair.c:26-92); bufs = per-read hit
    lists (pairs interleaved)."""
    r = PeStat2()
    isize = []
    max_len = 0
    for i in range(0, len(bufs), 2):
        if bufs[i] is None or len(bufs[i]) != 1 or len(bufs[i + 1]) != 1:
            continue
        t0, t1 = bufs[i][0], bufs[i + 1][0]
        if t0.G2 > 0.8 * t0.G or t1.G2 > 0.8 * t1.G:
            continue
        l = (t0.k - t1.k + t1.len if t0.k > t1.k
             else t1.k - t0.k + t0.len)
        if l >= max_ins:
            continue
        max_len = max(max_len, t0.end - t0.beg, t1.end - t1.beg)
        isize.append(l)
    k = len(isize)
    isize.sort()
    sys.stderr.write("[bsw2_stat] infer the insert size distribution "
                     "from %d high-quality pairs.\n" % k)
    if k < 8:
        sys.stderr.write("[bsw2_stat] fail to infer the insert size "
                         "distribution: too few good pairs.\n")
        r.failed = 1
        return r
    p25 = isize[int(.25 * k + .499)]
    p50 = isize[int(.50 * k + .499)]
    p75 = isize[int(.75 * k + .499)]
    tmp = int(p25 - 2.0 * (p75 - p25) + .499)
    r.low = tmp if tmp > max_len else max_len
    if r.low < 1:
        r.low = 1
    r.high = int(p75 + 2.0 * (p75 - p25) + .499)
    if r.low > r.high:
        sys.stderr.write("[bsw2_stat] fail to infer the insert size "
                         "distribution: upper bound is smaller than max "
                         "read length.\n")
        r.failed = 1
        return r
    sys.stderr.write("[bsw2_stat] (25, 50, 75) percentile: (%d, %d, %d)\n"
                     % (p25, p50, p75))
    sys.stderr.write("[bsw2_stat] low and high boundaries for computing "
                     "mean and std.dev: (%d, %d)\n" % (r.low, r.high))
    x = 0
    r.avg = 0.0
    for v in isize:
        if r.low <= v <= r.high:
            r.avg += v
            x += 1
    r.avg /= x
    for v in isize:
        if r.low <= v <= r.high:
            r.std += (v - r.avg) * (v - r.avg)
    r.std = math.sqrt(r.std / x)
    sys.stderr.write("[bsw2_stat] mean and std.dev: (%.2f, %.2f)\n"
                     % (r.avg, r.std))
    tmp = int(p25 - 3. * (p75 - p25) + .499)
    r.low = tmp if tmp > max_len else max_len
    if r.low < 1:
        r.low = 1
    r.high = int(p75 + 3. * (p75 - p25) + .499)
    if r.low > r.avg - MAX_STDDEV * r.std:
        r.low = int(r.avg - MAX_STDDEV * r.std + .499)
    r.low = tmp if tmp > max_len else max_len
    if r.high < r.avg - MAX_STDDEV * r.std:
        r.high = int(r.avg + MAX_STDDEV * r.std + .499)
    sys.stderr.write("[bsw2_stat] low and high boundaries for proper "
                     "pairs: (%d, %d)\n" % (r.low, r.high))
    return r


def bsw2_pair1(opt: Bsw2Opt, l_pac: int, pac, st: PeStat2, h: Hit,
               mseq: str, a: Hit, g_mat: np.ndarray) -> None:
    """bsw2_pair1 (software/bwtsw2_pair.c:101-160)."""
    l_mseq = len(mseq)
    a.n_seeds = 1
    a.flag |= BSW2_FLAG_MATESW
    if h.is_rev == 0:
        beg = int(h.k + st.avg - EXT_STDDEV * st.std - l_mseq + .499)
        if beg < h.k:
            beg = h.k
        end = int(h.k + st.avg + EXT_STDDEV * st.std + .499)
        a.is_rev = 1
        a.flag |= 16
    else:
        beg = int(h.k + h.end - h.beg - st.avg - EXT_STDDEV * st.std
                  + .499)
        end = int(h.k + h.end - h.beg - st.avg + EXT_STDDEV * st.std
                  + l_mseq + .499)
        if end > h.k + (h.end - h.beg):
            end = h.k + (h.end - h.beg)
        a.is_rev = 0
    if beg < 1:
        beg = 1
    if end > l_pac:
        end = l_pac
    if end - beg < l_mseq:
        return
    ref = get_seq(l_pac, pac, beg, end)
    nt4 = NT4_TABLE[np.frombuffer(mseq.encode("latin1"), np.uint8)]
    if h.is_rev == 0:
        seq = np.where(nt4 > 3, 4, 3 - nt4).astype(np.uint8)[::-1].copy()
    else:
        seq = nt4.astype(np.uint8)
    flag = (oksw.KSW_XSUBO | oksw.KSW_XSTART
            | (oksw.KSW_XBYTE if l_mseq * int(g_mat[0]) < 250 else 0)
            | opt.t)
    aln = oksw.ksw_align2(seq, ref, g_mat.astype(np.int64), opt.q, opt.r,
                          opt.q, opt.r, flag)
    a.G = aln.score
    a.G2 = aln.score2
    if a.G < opt.t:
        a.G = 0
    if a.G2 < opt.t:
        a.G2 = 0
    if a.G2:
        a.flag |= BSW2_FLAG_TANDEM
    a.k = beg + aln.tb
    a.len = aln.te - aln.tb + 1
    a.beg = aln.qb
    a.end = aln.qe + 1
    if a.is_rev:
        i = a.beg
        a.beg = l_mseq - a.end
        a.end = l_mseq - i


def bsw2_pair(opt: Bsw2Opt, l_pac: int, pac, reads, bufs) -> None:
    """bsw2_pair (software/bwtsw2_pair.c:162-268)."""
    pes = bsw2_stat(bufs, opt.max_ins)
    g_mat = np.zeros(25, dtype=np.int64)
    for i in range(5):
        for j in range(4):
            g_mat[i * 5 + j] = opt.a if i == j else -opt.b
        g_mat[i * 5 + 4] = 0
    n_rescued = n_moved = n_fixed = 0
    for i in range(0, len(bufs), 2):
        a = [Hit(), Hit()]
        a[0].flag = 1 << 6
        a[1].flag = 1 << 7
        for j in range(2):
            if bufs[i + j] is None:
                continue
            for p in bufs[i + j]:
                p.flag |= 1 << (6 + j)
        if pes.failed:
            continue
        if bufs[i] is None or bufs[i + 1] is None:
            continue
        if len(bufs[i]) != 1 and len(bufs[i + 1]) != 1:
            continue
        if len(bufs[i]) > 1 or len(bufs[i + 1]) > 1:
            continue
        if not opt.skip_sw:
            if len(bufs[i]) == 1:
                bsw2_pair1(opt, l_pac, pac, pes, bufs[i][0],
                           reads[i + 1].seq, a[1], g_mat)
            if len(bufs[i + 1]) == 1:
                bsw2_pair1(opt, l_pac, pac, pes, bufs[i + 1][0],
                           reads[i].seq, a[0], g_mat)
        if len(bufs[i]) + len(bufs[i + 1]) == 1:  # one end mapped
            if len(bufs[i]) == 1:
                p0, p1, which = bufs[i], bufs[i + 1], 1
            else:
                p0, p1, which = bufs[i + 1], bufs[i], 0
            if a[which].G == 0:
                continue
            a[which].flag |= BSW2_FLAG_RESCUED
            p1[:] = [a[which]]
            p0[0].flag |= 2
            p1[0].flag |= 2
            n_rescued += 1
        else:  # both ends mapped
            is_fixed = False
            for j in range(2):
                p = bufs[i + j][0]
                if p.G < a[j].G:
                    a[j].G2 = a[j].G2 if a[j].G2 > p.G else p.G
                    bufs[i + j][0] = a[j]
                    n_fixed += 1
                    is_fixed = True
                elif p.k != a[j].k and p.G2 < a[j].G:
                    p.G2 = a[j].G
                elif p.k == a[j].k and p.G2 < a[j].G2:
                    p.G2 = a[j].G2
            h0, h1 = bufs[i][0], bufs[i + 1][0]
            if h0.k == a[0].k and h1.k == a[1].k:
                for j in range(2):
                    bufs[i + j][0].flag |= 2 | (a[j].flag
                                                & BSW2_FLAG_TANDEM)
            elif h0.k == a[0].k or h1.k == a[1].k:
                for j in range(2):
                    bufs[i + j][0].flag |= 2
                    if bufs[i + j][0].k != a[j].k:
                        bufs[i + j][0].flag |= BSW2_FLAG_TANDEM
            elif not is_fixed and (a[0].G or a[1].G):
                if a[0].G and a[1].G:
                    G0 = bufs[i][0].G + a[1].G
                    G1 = bufs[i + 1][0].G + a[0].G
                    diff = abs(G0 - G1) / (opt.a + opt.b) / (
                        (bufs[i][0].len + a[1].len + bufs[i + 1][0].len
                         + a[0].len) / 2.)
                    if diff > 0.05:
                        a[0 if G0 > G1 else 1].G = 0
                if a[0].G == 0 or a[1].G == 0:
                    if a[0].G:
                        p0, p1, which = bufs[i + 1][0], bufs[i], 0
                    else:
                        p0, p1, which = bufs[i][0], bufs[i + 1], 1
                    isize = (p0.k + p0.len - a[which].k if p0.is_rev
                             else a[which].k + a[which].len - p0.k)
                    dev = abs(isize - pes.avg) / pes.std
                    diff = ((p1[0].G - a[which].G) / (opt.a + opt.b)
                            / (p1[0].end - p1[0].beg) * 100.0)
                    if diff < dev * 2.:
                        a[which].G2 = a[which].G
                        p1[0] = a[which]
                        p1[0].flag |= BSW2_FLAG_MOVED | 2
                        p0.flag |= 2
                        n_moved += 1
            elif is_fixed:
                bufs[i][0].flag |= 2
                bufs[i + 1][0].flag |= 2
    sys.stderr.write("[bsw2_pair] #fixed=%d, #rescued=%d, #moved=%d\n"
                     % (n_fixed, n_rescued, n_moved))


# ---------------------------------------------------------------------------
# driver (software/bwtsw2_aux.c:560-...)
# ---------------------------------------------------------------------------

def aln_core(reads, _opt: Bsw2Opt, bns, fm, is_pe: bool,
             rng: Rand48) -> List[str]:
    """bsw2_aln_core: returns SAM text per read."""
    from ..config import fill_scmat
    n = len(reads)
    bufs: List[Optional[List[Hit]]] = [None] * n
    opt = _opt
    for xi, rd in enumerate(reads):
        l = len(rd.seq)
        opt = update_opt(_opt, l)
        mat = np.asarray(fill_scmat(opt.a, opt.b), dtype=np.int64)
        nt4 = NT4_TABLE[np.frombuffer(rd.seq.encode("latin1"), np.uint8)]
        n_amb = int(np.sum(nt4 >= 4))
        seq0 = nt4.astype(np.uint8).copy()
        for pidx in np.nonzero(nt4 >= 4)[0]:
            seq0[pidx] = int(rng.drand48() * 4)
        seq1 = (3 - seq0)[::-1].copy()       # reverse complement
        rseq0 = seq1                          # same array contents
        rseq1 = seq0                          # forward
        if l - n_amb < opt.t:
            bufs[xi] = []
            continue
        b0 = aln1_core(opt, bns, fm, l, seq0, seq1, rng, mat)
        k = 0
        while k < len(b0) and b0[k].n_seeds >= opt.t_seeds:
            k += 1
        if k < len(b0):
            b1 = aln1_core(opt, bns, fm, l, rseq0, rseq1, rng, mat)
            for p in b1:
                x = p.beg
                p.flag ^= 0x10
                p.is_rev ^= 1
                p.beg = l - p.end
                p.end = l - x
            b = [b0, b1]
            flag_fr(b)
            merged = merge_hits2(b, l, False)
            merged = resolve_duphits(None, None, merged, 0)
            merged = resolve_query_overlaps(merged, opt.mask_level, rng)
            b0 = merged
        bufs[xi] = [h.copy() for h in b0]
    if is_pe:
        bsw2_pair(opt, bns.l_pac, bns.pac, reads, bufs)
    auxs_all: List[Optional[List[Aux]]] = [None] * n
    for xi, rd in enumerate(reads):
        l = len(rd.seq)
        nt4 = NT4_TABLE[np.frombuffer(rd.seq.encode("latin1"), np.uint8)]
        seq0 = nt4.astype(np.uint8).copy()
        for pidx in np.nonzero(nt4 >= 4)[0]:
            seq0[pidx] = int(rng.drand48() * 4)
        seq1 = (3 - seq0)[::-1].copy()
        opt = update_opt(_opt, l)
        auxs_all[xi] = write_aux(opt, bns, l, [seq0, seq1], bufs[xi],
                                 rd.name)
    sams = []
    for xi, rd in enumerate(reads):
        if is_pe:
            update_mate_aux(bufs[xi], auxs_all[xi], bufs[xi ^ 1],
                            auxs_all[xi ^ 1])
        sams.append(print_hits(bns, opt, rd, bufs[xi], auxs_all[xi],
                               is_pe))
    return sams


def main_bwasw(argv) -> int:
    import getopt as _getopt
    from ..index.bntseq import bns_restore
    from ..index.fmindex import FmIndex
    from ..io.native import make_chunk_reader
    opt = Bsw2Opt()
    rng = Rand48(11)  # srand48(11), software/bwtsw2_main.c:18
    out = sys.stdout
    try:
        opts, args = _getopt.getopt(argv, "q:r:a:b:t:T:w:d:z:m:s:c:N:Hf:MI:SG:C")
    except _getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n")
        return 1
    for c, v in opts:
        c = c[1:]
        if c == "q":
            opt.q = int(v)
        elif c == "r":
            opt.r = int(v)
        elif c == "a":
            opt.a = int(v)
        elif c == "b":
            opt.b = int(v)
        elif c == "w":
            opt.bw = int(v)
        elif c == "T":
            opt.t = int(v)
        elif c == "t":
            opt.n_threads = int(v)
        elif c == "z":
            opt.z = int(v)
        elif c == "s":
            opt.is_ = int(v)
        elif c == "m":
            opt.mask_level = float(v)
        elif c == "c":
            opt.coef = float(v)
        elif c == "N":
            opt.t_seeds = int(v)
        elif c == "M":
            opt.multi_2nd = 1
        elif c == "H":
            opt.hard_clip = 1
        elif c == "f":
            out = open(v, "w")
        elif c == "I":
            opt.max_ins = int(v)
        elif c == "S":
            opt.skip_sw = 1
        elif c == "C":
            opt.cpy_cmt = 1
        elif c == "G":
            opt.max_chain_gap = int(v)
    opt.qr = opt.q + opt.r
    if len(args) < 2:
        sys.stderr.write("Usage: bwa bwasw [options] <target.prefix> "
                         "<query.fa> [query2.fa]\n")
        return 1
    opt.t *= opt.a
    opt.coef *= opt.a
    bns = bns_restore(args[0], load_pac_file=True)
    fm = FmIndex.restore(args[0] + ".bwt", args[0] + ".sa")
    for ann in bns.anns:
        out.write("@SQ\tSN:%s\tLN:%d\n" % (ann.name, ann.length))
    is_pe = len(args) > 2
    reader = make_chunk_reader(args[1], args[2] if is_pe else None)
    while True:
        reads = reader.read_chunk(opt.chunk_size * opt.n_threads)
        if not reads:
            break
        size = sum(len(r.seq) for r in reads)
        sys.stderr.write("[bsw2_aln] read %d sequences/pairs (%d bp) ...\n"
                         % (len(reads), size))
        sams = aln_core(reads, opt, bns, fm, is_pe, rng)
        for s in sams:
            out.write(s)
    return 0
