"""Seed collection and chaining.

mem_chain: walk the SMEM iterator, look up every seed occurrence's
reference position through the sampled SA, and grow chains keyed by the
position of their first seed (reference: software/bwamem.c:316-615).
The reference keeps chains in a kbtree ordered by pos and merges each
new seed into the closest chain at or before it (kb_intervalp's `lower`,
software/kbtree.h:152-167); a sorted list with bisect reproduces that
exactly, including in-order traversal for the final chain order.

mem_chain_flt: drop chains dominated by overlapping better chains
(software/bwamem.c:629-690); the sort is tie-prone (weight only), so it
runs through the ks_introsort emulation to reproduce the reference's
exact permutation.
"""

import bisect
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..utils.ksort import ks_introsort

Seed = Tuple[int, int, int]  # (rbeg, qbeg, len)


@dataclass
class Chain:
    pos: int
    seeds: List[Seed] = field(default_factory=list)

    @property
    def n(self) -> int:
        return len(self.seeds)


def chain_weight(c: Chain) -> int:
    """mem_chain_weight (software/bwamem.c:503-521) — note the reference
    reuses `s->qbeg + s->len` for the running end in the *reference*-side
    pass too (a quirk we reproduce)."""
    w = 0
    end = 0
    for rbeg, qbeg, ln in c.seeds:
        if qbeg >= end:
            w += ln
        elif qbeg + ln > end:
            w += qbeg + ln - end
        end = max(end, qbeg + ln)
    tmp = w
    w = 0
    end = 0
    for rbeg, qbeg, ln in c.seeds:
        if rbeg >= end:
            w += ln
        elif rbeg + ln > end:
            w += rbeg + ln - end
        end = max(end, qbeg + ln)  # sic — matches bwamem.c:518
    return min(w, tmp)


def _test_and_merge(opt, l_pac: int, c: Chain, s: Seed) -> bool:
    """test_and_merge (software/bwamem.c:334-354).  True if the seed is
    contained in / merged into chain c; False requests a new chain."""
    rbeg, qbeg, ln = s
    last_r, last_q, last_l = c.seeds[-1]
    qend = last_q + last_l
    rend = last_r + last_l
    if (qbeg >= c.seeds[0][1] and qbeg + ln <= qend
            and rbeg >= c.seeds[0][0] and rbeg + ln <= rend):
        return True  # contained seed
    if (last_r < l_pac or c.seeds[0][0] < l_pac) and rbeg >= l_pac:
        return False  # different strand
    x = qbeg - last_q  # non-negative
    y = rbeg - last_r
    if (y >= 0 and x - y <= opt.w and y - x <= opt.w
            and x - last_l < opt.max_chain_gap and y - last_l < opt.max_chain_gap):
        c.seeds.append(s)
        return True
    return False


class ChainTree:
    """kbtree(chn) replacement: chains in pos order with predecessor
    queries; equal keys insert after existing ones (kbtree in-order)."""

    def __init__(self):
        self.keys: List[int] = []
        self.chains: List[Chain] = []

    def lower(self, pos: int) -> Optional[Chain]:
        i = bisect.bisect_right(self.keys, pos)
        return self.chains[i - 1] if i > 0 else None

    def insert(self, c: Chain) -> None:
        i = bisect.bisect_right(self.keys, c.pos)
        self.keys.insert(i, c.pos)
        self.chains.insert(i, c)

    def __len__(self):
        return len(self.chains)


def mem_chain(opt, fm, l_pac: int, query, trace=None) -> List[Chain]:
    """mem_chain + mem_insert_seed (software/bwamem.c:453-501,593-615).
    `trace` collects the bwa_verbose>=5 seed dump (bwamem.c:478-479)."""
    from ..oracle.smem import SmemIterator
    if len(query) < opt.min_seed_len:
        return []
    tree = ChainTree()
    itr = SmemIterator(fm, query)
    split_len = int(opt.min_seed_len * opt.split_factor + .499)
    split_len = min(split_len, len(query))
    from ..config import MEM_F_NO_EXACT
    start_width = 2 if (opt.flag & MEM_F_NO_EXACT) else 1
    while True:
        a = itr.next(split_len, opt.split_width, start_width)
        if a is None:
            break
        for p in a:
            slen = (p[3] & 0xFFFFFFFF) - (p[3] >> 32)
            if slen < opt.min_seed_len or p[2] > opt.max_occ:
                continue
            for k in range(p[2]):
                rbeg = fm.sa_lookup(p[0] + k)
                s = (rbeg, p[3] >> 32, slen)
                if trace is not None:
                    trace.append("* Found SEED: length=%d,query_beg=%d,"
                                 "ref_beg=%d\n" % (slen, p[3] >> 32, rbeg))
                if rbeg < l_pac < rbeg + slen:
                    continue  # bridging forward-reverse boundary
                to_add = False
                if len(tree):
                    low = tree.lower(rbeg)
                    if low is None or not _test_and_merge(opt, l_pac, low, s):
                        to_add = True
                else:
                    to_add = True
                if to_add:
                    tree.insert(Chain(pos=rbeg, seeds=[s]))
    return tree.chains


def mem_chain_flt(opt, chains: List[Chain]) -> List[Chain]:
    """mem_chain_flt (software/bwamem.c:629-690)."""
    n_chn = len(chains)
    if n_chn <= 1:
        return chains
    # aux entries [beg, end, w, chain, p2]
    aux = []
    for c in chains:
        w = chain_weight(c)
        aux.append([c.seeds[0][1], c.seeds[-1][1] + c.seeds[-1][2], w, c, None])
    ks_introsort(aux, lambda x, y: x[2] > y[2])  # flt_lt: weight desc
    # reorder chains so the best chain appears first; aux[i] then refers
    # to slot i (bwamem.c:644-653)
    chains = [a[3] for a in aux]
    for i, a in enumerate(aux):
        a[3] = i
    kept = [aux[0]]
    for i in range(1, n_chn):
        ai = aux[i]
        j = 0
        while j < len(kept):
            aj = kept[j]
            b_max = max(aj[0], ai[0])
            e_min = min(aj[1], ai[1])
            if e_min > b_max:  # overlap
                min_l = min(ai[1] - ai[0], aj[1] - aj[0])
                if e_min - b_max >= min_l * opt.mask_level:  # significant
                    if aj[4] is None:
                        aj[4] = ai[3]
                    if (ai[2] < aj[2] * opt.chain_drop_ratio
                            and aj[2] - ai[2] >= opt.min_seed_len * 2):
                        break
            j += 1
        if j == len(kept):
            kept.append(ai)
    keep_idx = set()
    for a in kept:
        keep_idx.add(a[3])
        if a[4] is not None:
            keep_idx.add(a[4])
    return [chains[i] for i in range(n_chn) if i in keep_idx]
