"""Smith–Waterman kernels — host oracle, NumPy row-vectorized.

Exact behavioral transcriptions of the reference's three SW entry points
(the SW surface used by bwamem, software/ksw.h:63-108):

  ksw_extend2  banded extension with z-drop, end-bonus and gscore
               tracking (software/ksw.c:379-476)
  ksw_global2  banded global alignment with CIGAR backtrack
               (software/ksw.c:501-584)
  ksw_align2   full local SW via Farrar striped SSE2 (ksw_u8/ksw_i16,
               software/ksw.c:110-364)

Exactness notes:
  * Rows are vectorized over the query; the horizontal F-dependency is
    resolved with a prefix-scan (the F chain F(j+1)=max(F(j)-e, G(j)-oe)
    unrolls to a running maximum of G(k)+k*e).
  * ksw_u8/ksw_i16's striped layout is equivalent to standard SW over a
    *virtual* query padded to slen*p positions whose profile scores are 0
    for every target base; the padding participates in row maxima and the
    second-best bookkeeping, so we emulate it rather than ignore it.
  * u8 mode saturates adds at 255 and subs at 0 exactly like
    _mm_adds_epu8/_mm_subs_epu8.
"""

from dataclasses import dataclass
from typing import List, Tuple
import numpy as np

KSW_XBYTE = 0x10000
KSW_XSTOP = 0x20000
KSW_XSUBO = 0x40000
KSW_XSTART = 0x80000

MINUS_INF = -0x40000000

_native_ok = None


def _native() -> bool:
    """True when the native scalar kernels (native/ksw.cpp, bit-identical
    to the pure-Python specs below) are available and not disabled via
    BWAMEM_TPU_NATIVE_KSW=0."""
    global _native_ok
    if _native_ok is None:
        try:
            from . import nksw
            _native_ok = nksw.available()
        except Exception:
            _native_ok = False
    return _native_ok


# --------------------------------------------------------------------------
# ksw_extend2
# --------------------------------------------------------------------------

def ksw_extend2(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
                o_del: int, e_del: int, o_ins: int, e_ins: int, w: int,
                end_bonus: int, zdrop: int, h0: int
                ) -> Tuple[int, int, int, int, int, int]:
    """Returns (max, qle, tle, gtle, gscore, max_off)."""
    if _native():
        from . import nksw
        return nksw.ksw_extend2(query, target, mat, o_del, e_del, o_ins,
                                e_ins, w, end_bonus, zdrop, h0)
    return ksw_extend2_py(query, target, mat, o_del, e_del, o_ins, e_ins,
                          w, end_bonus, zdrop, h0)


def ksw_extend2_py(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
                   o_del: int, e_del: int, o_ins: int, e_ins: int, w: int,
                   end_bonus: int, zdrop: int, h0: int
                   ) -> Tuple[int, int, int, int, int, int]:
    """Pure-Python spec (NumPy row-vectorized)."""
    qlen, tlen = len(query), len(target)
    m = 5
    if h0 < 0:
        h0 = 0
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qp = mat.reshape(m, m)[:, query].astype(np.int64)  # [target_char, j]

    eh_h = np.zeros(qlen + 1, dtype=np.int64)
    eh_e = np.zeros(qlen + 1, dtype=np.int64)
    eh_h[0] = h0
    if qlen >= 1:
        eh_h[1] = h0 - oe_ins if h0 > oe_ins else 0
        j = 2
        while j <= qlen and eh_h[j - 1] > e_ins:
            eh_h[j] = eh_h[j - 1] - e_ins
            j += 1

    # band clamp (ksw.c:398-406); float math matches the C doubles
    max_sc = int(mat.max())
    max_ins = int(float(qlen * max_sc + end_bonus - o_ins) / e_ins + 1.0)
    max_ins = max(max_ins, 1)
    w = min(w, max_ins)
    max_del = int(float(qlen * max_sc + end_bonus - o_del) / e_del + 1.0)
    max_del = max(max_del, 1)
    w = min(w, max_del)

    best, max_i, max_j = h0, -1, -1
    max_ie, gscore = -1, -1
    max_off = 0
    beg, end = 0, qlen
    for i in range(tlen):
        h1 = h0 - (o_del + e_del * (i + 1))
        if h1 < 0:
            h1 = 0
        if beg < i - w:
            beg = i - w
        if end > i + w + 1:
            end = i + w + 1
        if end > qlen:
            end = qlen
        if beg >= end:
            # degenerate band: C runs the row with zero inner iterations
            # (j stays at beg) and still applies the j==qlen gscore
            # update before the m==0 break (software/ksw.c:450-456)
            if beg == qlen and gscore <= h1:
                max_ie, gscore = i, h1
            break
        js = np.arange(beg, end)
        hdiag = eh_h[beg:end].copy()
        e = eh_e[beg:end].copy()
        g = hdiag + qp[target[i], beg:end]
        g = np.maximum(g, e)
        # F prefix-scan: F(beg)=0; F(j+1)=max(F(j)-e_ins, H(j)-oe_ins, 0)
        # with H=max(G,F); the F-derived branch is dominated, so
        # F(j) = max(0, cummax(G(k)+k*e_ins)-oe_ins-(j)*e_ins) shifted
        a_vec = g + js * e_ins
        cm = np.maximum.accumulate(a_vec)
        f = np.zeros(end - beg, dtype=np.int64)
        if end - beg > 1:
            # F(j) = max(0, max_{k<j}(G(k)-oe_ins-(j-1-k)*e_ins))
            f[1:] = np.maximum(cm[:-1] - oe_ins - (js[1:] - 1) * e_ins, 0)
        h = np.maximum(g, f)
        # m/mj: running max with ties taking the later index
        mrow = int(h.max()) if h.size else 0
        if mrow > 0:
            mj = beg + int(h.size - 1 - np.argmax(h[::-1] >= mrow))
        else:
            mrow = 0
            # h >= 0 always; running max stays 0, mj = last index
            mj = end - 1
        # E update
        t = np.maximum(h - oe_del, 0)
        eh_e[beg:end] = np.maximum(e - e_del, t)
        # H row shift-store: eh_h[j] = H(i, j-1)
        eh_h[beg] = h1
        eh_h[beg + 1:end + 1] = h
        eh_e[end] = 0
        h1_last = int(h[-1])
        if end == qlen:
            if gscore <= h1_last:
                max_ie = i
                gscore = h1_last
        if mrow == 0:
            break
        if mrow > best:
            best, max_i, max_j = mrow, i, mj
            if max_off < abs(mj - i):
                max_off = abs(mj - i)
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if best - mrow - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if best - mrow - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        # narrow the band for the next row (ksw.c:463-466), using the
        # *new* eh_h values
        j = mj
        while j >= beg and eh_h[j] != 0:
            j -= 1
        beg = j + 1
        j = mj + 2
        while j <= end and eh_h[j] != 0:
            j += 1
        end = j
    return best, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off


# --------------------------------------------------------------------------
# ksw_global2
# --------------------------------------------------------------------------

def ksw_global2(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
                o_del: int, e_del: int, o_ins: int, e_ins: int, w: int,
                want_cigar: bool = True) -> Tuple[int, List[int]]:
    """Banded global alignment.  Returns (score, cigar) where cigar is a
    list of BAM-encoded ops (len<<4|op, op: 0=M 1=I 2=D)."""
    if _native():
        from . import nksw
        return nksw.ksw_global2(query, target, mat, o_del, e_del, o_ins,
                                e_ins, w, want_cigar)
    return ksw_global2_py(query, target, mat, o_del, e_del, o_ins, e_ins,
                          w, want_cigar)


def ksw_global2_py(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
                   o_del: int, e_del: int, o_ins: int, e_ins: int, w: int,
                   want_cigar: bool = True) -> Tuple[int, List[int]]:
    """Pure-Python spec of ksw_global2."""
    qlen, tlen = len(query), len(target)
    m = 5
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    n_col = qlen if qlen < 2 * w + 1 else 2 * w + 1
    z = np.zeros((tlen, n_col), dtype=np.uint8) if want_cigar else None
    qp = mat.reshape(m, m)[:, query].astype(np.int64)

    eh_h = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    eh_e = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    eh_h[0] = 0
    jmax = min(qlen, w)
    if jmax >= 1:
        eh_h[1:jmax + 1] = -(o_ins + e_ins * np.arange(1, jmax + 1, dtype=np.int64))

    for i in range(tlen):
        beg = i - w if i > w else 0
        end = i + w + 1 if i + w + 1 < qlen else qlen
        h1 = -(o_del + e_del * (i + 1)) if beg == 0 else MINUS_INF
        if end <= beg:  # band misses the query entirely (out-of-contract
            # input; C runs an empty inner loop and just stores h1)
            eh_h[end] = h1
            eh_e[end] = MINUS_INF
            continue
        js = np.arange(beg, end)
        hdiag = eh_h[beg:end].copy()
        e = eh_e[beg:end].copy()
        mm = hdiag + qp[target[i], beg:end]  # M(i,j)
        # F chain: F(beg) = MINUS_INF; F(j+1) = max(F(j)-e_ins, M(j)-oe_ins)
        a_vec = mm + js * e_ins
        cm = np.maximum.accumulate(a_vec)
        # F(beg) = MINUS_INF; F(j) = max(M(k)-oe_ins-(j-1-k)e_ins for k<j,
        # MINUS_INF-(j-beg)e_ins)  — the decayed initial term matters for
        # bit-exact direction flags at the band edge
        f = np.full(end - beg, MINUS_INF, dtype=np.int64)
        if end - beg > 1:
            f[1:] = np.maximum(cm[:-1] - oe_ins - (js[1:] - 1) * e_ins,
                               MINUS_INF - (js[1:] - beg) * e_ins)
        d = np.where(mm >= e, 0, 1).astype(np.uint8)
        h = np.maximum(mm, e)
        d = np.where(h >= f, d, 2).astype(np.uint8)
        h = np.maximum(h, f)
        t = mm - oe_del
        e2 = e - e_del
        d |= np.where(e2 > t, 1 << 2, 0).astype(np.uint8)
        eh_e[beg:end] = np.maximum(e2, t)
        t = mm - oe_ins
        f2 = f - e_ins
        d |= np.where(f2 > t, 2 << 4, 0).astype(np.uint8)
        # (f next-value is implicit in the scan next row start)
        if want_cigar:
            z[i, :end - beg] = d
        eh_h[beg] = h1
        eh_h[beg + 1:end + 1] = h
        eh_e[end] = MINUS_INF

    score = int(eh_h[qlen])
    cigar: List[int] = []
    if want_cigar:
        ops: List[Tuple[int, int]] = []

        def push(op, ln):
            if not ops or ops[-1][0] != op:
                ops.append((op, ln))
            else:
                ops[-1] = (op, ops[-1][1] + ln)

        i = tlen - 1
        k = (i + w + 1 if i + w + 1 < qlen else qlen) - 1
        which = 0
        while i >= 0 and k >= 0:
            off = i - w if i > w else 0
            which = (int(z[i, k - off]) >> (which << 1)) & 3
            if which == 0:
                push(0, 1)
                i -= 1
                k -= 1
            elif which == 1:
                push(2, 1)
                i -= 1
            else:
                push(1, 1)
                k -= 1
        if i >= 0:
            push(2, i + 1)
        if k >= 0:
            push(1, k + 1)
        ops.reverse()
        cigar = [(ln << 4) | op for op, ln in ops]
    return score, cigar


# --------------------------------------------------------------------------
# ksw_align2 (Farrar striped local SW, u8 / i16 variants)
# --------------------------------------------------------------------------

@dataclass
class KswR:
    score: int = 0
    te: int = -1
    qe: int = -1
    score2: int = -1
    te2: int = -1
    tb: int = -1
    qb: int = -1


def _ksw_core(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
              o_del: int, e_del: int, o_ins: int, e_ins: int,
              xtra: int, size: int) -> KswR:
    """ksw_u8 (size=1) / ksw_i16 (size=2) over the virtual padded query."""
    qlen, tlen = len(query), len(target)
    m = 5
    p = 8 * (3 - size)            # lanes per __m128i
    slen = (qlen + p - 1) // p    # segment length
    vlen = slen * p               # virtual query length
    mat2 = mat.reshape(m, m).astype(np.int64)
    shift = int(-mat2.min()) if size == 1 else 0
    max_sc = int(mat2.max())      # q->max

    r = KswR()
    minsc = (xtra & 0xFFFF) if (xtra & KSW_XSUBO) else 0x10000
    endsc = (xtra & 0xFFFF) if (xtra & KSW_XSTOP) else 0x10000

    # virtual-position profile: qp[c][j] = mat[c][query[j]] (0 for pads)
    qp = np.zeros((m, vlen), dtype=np.int64)
    qp[:, :qlen] = mat2[:, query]

    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    H = np.zeros(vlen, dtype=np.int64)
    E = np.zeros(vlen, dtype=np.int64)
    Hmax = np.zeros(vlen, dtype=np.int64)
    gmax, te = 0, -1
    b: List[Tuple[int, int]] = []  # (row_max, row) candidates
    sat = 255 - shift if size == 1 else None

    js = np.arange(vlen, dtype=np.int64)
    for i in range(tlen):
        hdiag = np.empty(vlen, dtype=np.int64)
        hdiag[0] = 0
        hdiag[1:] = H[:-1]
        g = hdiag + qp[target[i]]
        if size == 1:
            # u8: adds saturate at 255 (in shifted domain), subs clamp at 0
            np.minimum(g, sat, out=g)
            np.maximum(g, 0, out=g)
        g = np.maximum(g, E)
        # F scan (F(0)=0, F(j+1)=max(F(j)-e_ins, H(j)-oe_ins, 0))
        a_vec = g + js * e_ins
        cm = np.maximum.accumulate(a_vec)
        F = np.zeros(vlen, dtype=np.int64)
        if vlen > 1:
            F[1:] = np.maximum(cm[:-1] - oe_ins - (js[1:] - 1) * e_ins, 0)
        H = np.maximum(g, F)
        imax = int(H.max())
        # E update: E' = max(E-e_del, H-oe_del, 0)
        E = np.maximum(E - e_del, np.maximum(H - oe_del, 0))
        if imax >= minsc:
            if not b or b[-1][1] + 1 != i:
                b.append((imax, i))
            elif b[-1][0] < imax:
                b[-1] = (imax, i)
        if imax > gmax:
            gmax, te = imax, i
            Hmax[:] = H
            if size == 1 and gmax + shift >= 255:
                break
            if gmax >= endsc:
                break

    r.score = gmax if (size != 1 or gmax + shift < 255) else 255
    r.te = te
    if size != 1 or r.score != 255:
        # qe: smallest virtual position achieving the max of Hmax
        mx = int(Hmax.max()) if vlen else -1
        if mx > -1:
            r.qe = int(np.argmax(Hmax == mx))
        if b:
            ii = (r.score + max_sc - 1) // max_sc
            low, high = te - ii, te + ii
            for rm, e_row in b:
                if (e_row < low or e_row > high) and rm > r.score2:
                    r.score2, r.te2 = rm, e_row
    return r


def ksw_align2(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
               o_del: int, e_del: int, o_ins: int, e_ins: int,
               xtra: int) -> KswR:
    if _native():
        from . import nksw
        return nksw.ksw_align2(query, target, mat, o_del, e_del, o_ins,
                               e_ins, xtra)
    return ksw_align2_py(query, target, mat, o_del, e_del, o_ins, e_ins,
                         xtra)


def ksw_align2_py(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
                  o_del: int, e_del: int, o_ins: int, e_ins: int,
                  xtra: int) -> KswR:
    """Pure-Python spec of ksw_align2 (striped-kernel emulation)."""
    size = 1 if (xtra & KSW_XBYTE) else 2
    r = _ksw_core(query, target, mat, o_del, e_del, o_ins, e_ins, xtra, size)
    if (xtra & KSW_XSTART) == 0 or ((xtra & KSW_XSUBO) and r.score < (xtra & 0xFFFF)):
        return r
    # locate the start by rerunning on the reversed prefixes with an
    # early-stop at the known score (ksw.c:355-363)
    rq = query[:r.qe + 1][::-1].copy()
    rt = target[:r.te + 1][::-1].copy()
    rr = _ksw_core(rq, rt, mat, o_del, e_del, o_ins, e_ins,
                   KSW_XSTOP | r.score, size)
    if r.score == rr.score:
        r.tb = r.te - rr.te
        r.qb = r.qe - rr.qe
    return r
