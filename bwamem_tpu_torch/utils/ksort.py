"""Behavioral emulation of klib's ks_introsort.

BWA-MEM's output bytes depend on the *exact permutation* its sorts produce
for elements that compare equal (several comparators are partial orders:
chain weight only, alignment end only, ...).  ks_introsort is an unstable
median-of-3 quicksort with an explicit stack, falling back to combsort at
depth exhaustion and finishing with insertion sort
(reference: software/ksort.h:146-226).  To be byte-equivalent we replay
the same algorithm — same pivot rule, same partition walk, same small-range
cutoffs — over Python lists.

`lt(a, b)` must implement the C comparator's strict less-than.
"""

from math import isqrt

_SHRINK = 1.2473309501039786540366528676643


def _insertsort(a, lt, s, t):
    # insertion sort over a[s:t) (exclusive end), mirrors __ks_insertsort
    for i in range(s + 1, t):
        j = i
        while j > s and lt(a[j], a[j - 1]):
            a[j], a[j - 1] = a[j - 1], a[j]
            j -= 1


def _combsort(a, lt, s, n):
    gap = n
    while True:
        if gap > 2:
            gap = int(gap / _SHRINK)
            if gap in (9, 10):
                gap = 11
        do_swap = False
        for i in range(s, s + n - gap):
            j = i + gap
            if lt(a[j], a[i]):
                a[i], a[j] = a[j], a[i]
                do_swap = True
        if not (do_swap or gap > 2):
            break
    if gap != 1:
        _insertsort(a, lt, s, s + n)


def ks_introsort(a, lt):
    """Sort list `a` in place with ks_introsort's exact element movement."""
    n = len(a)
    if n < 1:
        return a
    if n == 2:
        if lt(a[1], a[0]):
            a[0], a[1] = a[1], a[0]
        return a
    d = 2
    while (1 << d) < n:
        d += 1
    stack = []
    s, t = 0, n - 1  # inclusive ends, like the C pointer arithmetic
    d <<= 1
    while True:
        if s < t:
            d -= 1
            if d == 0:
                _combsort(a, lt, s, t - s + 1)
                t = s
                continue
            i, j = s, t
            k = i + ((j - i) >> 1) + 1
            # median-of-3 pivot selection (ksort.h:198-201)
            if lt(a[k], a[i]):
                if lt(a[k], a[j]):
                    k = j
            else:
                k = i if lt(a[j], a[i]) else j
            rp = a[k]
            if k != t:
                a[k], a[t] = a[t], a[k]
            while True:
                i += 1
                while lt(a[i], rp):
                    i += 1
                j -= 1
                while i <= j and lt(rp, a[j]):
                    j -= 1
                if j <= i:
                    break
                a[i], a[j] = a[j], a[i]
            a[i], a[t] = a[t], a[i]
            if i - s > t - i:
                if i - s > 16:
                    stack.append((s, i - 1, d))
                s = i + 1 if t - i > 16 else t
            else:
                if t - i > 16:
                    stack.append((i + 1, t, d))
                t = i - 1 if i - s > 16 else s
        else:
            if not stack:
                _insertsort(a, lt, 0, n)
                return a
            s, t, d = stack.pop()


def ks_introsort_u64(a):
    """ks_introsort_64: plain < on uint64 values (total order, so any
    correct sort matches; we reuse the emulation for uniformity)."""
    a.sort()
    return a


def ks_introsort_u128(a):
    """ks_introsort_128 on pair64_t with `(a.x < b.x || (a.x == b.x &&
    a.y < b.y))` — a total order, so a plain sort is byte-equivalent."""
    a.sort()
    return a
