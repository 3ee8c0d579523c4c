"""Suffix array construction (host-side, NumPy).

The BWT is a canonical function of the text, so unlike the seeding and
alignment stages we do not need to mirror the reference's particular
construction algorithm (software/is.c SA-IS for small genomes,
software/bwt_gen.c incremental BWT for large ones) — any correct suffix
array yields bit-identical .bwt/.sa artifacts.  We use prefix-doubling
with NumPy radix passes: O(n log n), fully vectorized, comfortable up to
hundreds of Mbp on the host.  Convention matches is_sa (is.c:191-200):
the implicit sentinel (smaller than every base) sorts first, so the
returned array has SA[0] == n.
"""

import numpy as np


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of `text` (uint8 values 0..3) including the sentinel
    row: returns int64 array of length n+1 with SA[0] == n."""
    n = int(len(text))
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    # rank 0 is reserved for the sentinel; bases become 1..4
    rank = np.zeros(n + 1, dtype=np.int64)
    rank[:n] = text.astype(np.int64) + 1
    sa = np.argsort(rank, kind="stable")  # length n+1
    # initial ranks from single characters
    r = np.empty(n + 1, dtype=np.int64)
    sorted_keys = rank[sa]
    r[sa] = np.cumsum(np.concatenate(([0], (np.diff(sorted_keys) != 0).astype(np.int64))))
    k = 1
    while k <= n:
        # key = (rank[i], rank[i+k]), sentinel/rank beyond end -> -1
        second = np.full(n + 1, -1, dtype=np.int64)
        second[: n + 1 - k] = r[k:]
        # radix sort: stable sort by second, then stable sort by first
        order = np.argsort(second, kind="stable")
        order = order[np.argsort(r[order], kind="stable")]
        sa = order
        first_sorted = r[sa]
        second_sorted = second[sa]
        changed = np.concatenate((
            [0],
            ((np.diff(first_sorted) != 0) | (np.diff(second_sorted) != 0)).astype(np.int64),
        ))
        new_r = np.empty(n + 1, dtype=np.int64)
        new_r[sa] = np.cumsum(changed)
        r = new_r
        if r[sa[-1]] == n:  # all ranks distinct
            break
        k <<= 1
    return sa
