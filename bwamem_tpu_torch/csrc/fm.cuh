// FM-index primitives shared by the SMEM and SA-walk kernels.
//
// The occ table is the (n_blocks, 16) uint32 layout of
// bwamem_tpu_torch/ops/fm.py: one row is one 64-byte occ block, words
// 0..7 the four 64-bit checkpoint counts (lo, hi), words 8..15 the 128
// 2-bit BWT symbols of the block ($-removed).  Coordinates are int64 for
// every table size: Hopper has native 64-bit integer arithmetic, so the
// int32/int64 split of the JAX package is a storage choice here, not a
// kernel variant.
//
// Scalar spec: native/hostsmem.cpp (occ4/extend/B0/occ1) and
// bwamem_tpu/ops/fm.py (occ4 :308, extend :351, bwt_b0 :382, occ1 :393,
// inv_psi :404).
//
// Split tables (mem --shard-tables): the occ table and the sampled SA may
// be cut by rows into up to kMaxParts contiguous parts, each its own
// allocation on its own card; a kernel loads a row where it lies, over
// NVLink for a peer card's part.  The functions below take the view as a
// template parameter: FmView (the whole table, one pointer) or
// FmSplitView (the parts), so the whole-table kernels compile as they did
// and only the split ones pay the part lookup (part_row).
#pragma once

#include <cstdint>
#include <type_traits>

#ifdef __CUDACC__
#define BM_HD __host__ __device__ __forceinline__
#else
#define BM_HD inline
#endif

struct FmView {
  const uint32_t* blocks;  // (n_blocks, 16)
  int64_t primary;
  int64_t seq_len;
  int64_t L2[5];
};

constexpr int kMaxParts = 8;  // one part per card of an 8-card node
constexpr int kBadParts = 1;  // an entry's return for parts it does not
                              // take (cudaErrorInvalidValue)

// A table cut by rows into contiguous parts: part i holds rows
// [i * rows, (i + 1) * rows), the last one what is left.  Passed by value
// inside the kernel's view, so the bases sit in its parameter space.
// rows is a multiple of 2^shift, shift = max(0, bit_length(rows) - 29):
// the part of row r is then (r >> shift) / (rows >> shift), a quotient of
// 32-bit numbers for every r of up to 8 parts (make_parts).
struct Parts {
  const char* base[kMaxParts];
  uint64_t rows;      // rows of each part but the last
  uint32_t magic_lo;  // ceil(2^64 / (rows >> shift)), low and high words
  uint32_t magic_hi;
  int shift;
};

struct FmSplitView {
  Parts occ;       // 64-byte occ rows
  int64_t primary;
  int64_t seq_len;
  int64_t L2[5];
};

// The whole table, as a Parts-like view of one base (the SA of the
// whole-table SA walk).
struct Whole {
  const char* base;
};

BM_HD uint32_t bm_mulhi32(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
#endif
}

// Row r of a split table: its part q = a / d for the 32-bit a = r >> shift
// and d = rows >> shift, taken as the high word of a * ceil(2^64 / d),
// which is exact for 32-bit a and d (Lemire, Kaser and Kurz, "Faster
// remainder by direct computation", 2019); with a < 2^32 the product's
// high word is two 32-bit multiplies.  No 64-bit division, which the
// card runs as a long software sequence.
BM_HD const char* row_at(const Parts& p, uint64_t r, int row_bytes) {
  const uint32_t a = static_cast<uint32_t>(r >> p.shift);
  const uint32_t q = static_cast<uint32_t>(
      (static_cast<uint64_t>(a) * p.magic_hi + bm_mulhi32(a, p.magic_lo))
      >> 32);
  return p.base[q] + (r - q * p.rows) * row_bytes;
}

BM_HD const char* row_at(const Whole& w, uint64_t r, int row_bytes) {
  return w.base + r * row_bytes;
}

// The first word of occ row r.
BM_HD const uint32_t* fm_row(const FmView& f, int64_t r) {
  return f.blocks + r * 16;
}

BM_HD const uint32_t* fm_row(const FmSplitView& f, int64_t r) {
  return reinterpret_cast<const uint32_t*>(
      row_at(f.occ, static_cast<uint64_t>(r), 64));
}

// The entries' views, built on the host from their arguments: base[0..n)
// the parts' addresses, rows the rows of each part but the last.
inline FmView fm_view(const void* blocks, int64_t primary, int64_t seq_len,
                      const void* L2) {
  FmView f;
  f.blocks = static_cast<const uint32_t*>(blocks);
  f.primary = primary;
  f.seq_len = seq_len;
  for (int c = 0; c < 5; ++c) f.L2[c] = static_cast<const int64_t*>(L2)[c];
  return f;
}

// false for a count or a part size the split kernels do not take: 2 to
// kMaxParts parts of at least 2 rows, rows a multiple of 2^shift.
inline bool make_parts(Parts* p, const void* const* base, int n,
                       int64_t rows) {
  if (n < 2 || n > kMaxParts || rows < 2) return false;
  int bits = 0;
  while (bits < 63 && (int64_t{1} << bits) <= rows) ++bits;
  p->shift = bits > 29 ? bits - 29 : 0;
  if (rows & ((int64_t{1} << p->shift) - 1)) return false;
  for (int i = 0; i < kMaxParts; ++i)
    p->base[i] = i < n ? static_cast<const char*>(base[i]) : nullptr;
  p->rows = static_cast<uint64_t>(rows);
  const uint64_t magic = ~uint64_t{0} / (p->rows >> p->shift) + 1;
  p->magic_lo = static_cast<uint32_t>(magic);
  p->magic_hi = static_cast<uint32_t>(magic >> 32);
  return true;
}

// fn(view) with the view that n_parts asks for: FmView for one part (the
// whole table), FmSplitView for several; kBadParts where make_parts
// refuses them.
template <class Fn>
int with_fm_view(const void* const* occ, int n_parts, int64_t part_rows,
                 int64_t primary, int64_t seq_len, const void* L2, Fn fn) {
  const FmView w = fm_view(occ[0], primary, seq_len, L2);
  if (n_parts == 1) return fn(w);
  FmSplitView f;
  if (!make_parts(&f.occ, occ, n_parts, part_rows)) return kBadParts;
  f.primary = w.primary;
  f.seq_len = w.seq_len;
  for (int c = 0; c < 5; ++c) f.L2[c] = w.L2[c];
  return fn(f);
}

struct Iv3 {
  int64_t x0, x1, s;
};

BM_HD int bm_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// bwt_occ4: per-base counts of bwt[0..k] (inclusive); zeros for k < 0.
template <class FV>
BM_HD void fm_occ4(const FV& f, int64_t k, int64_t cnt[4]) {
  if (k < 0) {
    cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
    return;
  }
  const int64_t kk = k - (k >= f.primary ? 1 : 0);
  const uint32_t* row = fm_row(f, kk >> 7);
  const int off = static_cast<int>(kk & 127);
  const int wi = off >> 4;
  const int r = (~off) & 15;
  int c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t w = row[8 + j];
    const uint32_t m = j < wi ? 0xFFFFFFFFu
                              : (j == wi ? ~((1u << (r * 2)) - 1u) : 0u);
    w &= m;
    const uint32_t hb = (w >> 1) & 0x55555555u;
    const uint32_t lb = w & 0x55555555u;
    c3 += bm_popc(hb & lb);
    c2 += bm_popc(hb & ~lb);
    c1 += bm_popc(lb & ~hb);
  }
  const int c0 = off + 1 - c1 - c2 - c3;
  cnt[0] = (static_cast<int64_t>(row[1]) << 32 | row[0]) + c0;
  cnt[1] = (static_cast<int64_t>(row[3]) << 32 | row[2]) + c1;
  cnt[2] = (static_cast<int64_t>(row[5]) << 32 | row[4]) + c2;
  cnt[3] = (static_cast<int64_t>(row[7]) << 32 | row[6]) + c3;
}

// Four words of an occ row, loaded as one 16-byte access (the rows are
// 64-byte aligned).
struct W4 {
  uint32_t w[4];
};

BM_HD W4 fm_load4(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  return W4{{v.x, v.y, v.z, v.w}};
#else
  return W4{{p[0], p[1], p[2], p[3]}};
#endif
}

// The share of chunk ch (words 4ch..4ch+3) of the occ row that bwt_occ4
// reads for k in cnt[c] (added to *at) and in the sum of cnt[d] over d > c
// (added to *above).  Chunks 0-1 hold the checkpoints, chunks 2-3 the
// BWT words; the four chunks together give fm_occ4's counts, and k < 0
// gives nothing.
template <class FV>
BM_HD void fm_occ_chunk(const FV& f, int64_t k, int ch, int c,
                        int64_t* at, int64_t* above) {
  if (k < 0) return;
  const int64_t kk = k - (k >= f.primary ? 1 : 0);
  const W4 v = fm_load4(fm_row(f, kk >> 7) + ch * 4);
  int64_t p0, p1, p2, p3;
  if (ch < 2) {
    const int64_t a = static_cast<int64_t>(v.w[1]) << 32 | v.w[0];
    const int64_t b = static_cast<int64_t>(v.w[3]) << 32 | v.w[2];
    p0 = ch == 0 ? a : 0;
    p1 = ch == 0 ? b : 0;
    p2 = ch == 1 ? a : 0;
    p3 = ch == 1 ? b : 0;
  } else {
    const int off = static_cast<int>(kk & 127);
    const int wi = off >> 4;
    const int r = (~off) & 15;
    int c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = (ch - 2) * 4 + q;
      const uint32_t m = j < wi ? 0xFFFFFFFFu
                                : (j == wi ? ~((1u << (r * 2)) - 1u) : 0u);
      const uint32_t w = v.w[q] & m;
      const uint32_t hb = (w >> 1) & 0x55555555u;
      const uint32_t lb = w & 0x55555555u;
      c3 += bm_popc(hb & lb);
      c2 += bm_popc(hb & ~lb);
      c1 += bm_popc(lb & ~hb);
    }
    p0 = (ch == 2 ? off + 1 : 0) - c1 - c2 - c3;
    p1 = c1;
    p2 = c2;
    p3 = c3;
  }
  *at += c == 0 ? p0 : (c == 1 ? p1 : (c == 2 ? p2 : p3));
  *above += (c < 1 ? p1 : 0) + (c < 2 ? p2 : 0) + (c < 3 ? p3 : 0);
}

// The bi-interval from bwt_occ4's counts at the two rows: tk_c = cnt(k)[c],
// tl_c = cnt(l)[c] and above = the sum over d > c of cnt(l)[d] - cnt(k)[d].
template <class FV>
BM_HD Iv3 fm_interval(const FV& f, int64_t x0, int64_t x1, int64_t s,
                      bool is_back, int c, int64_t tk_c, int64_t tl_c,
                      int64_t above) {
  const int64_t fwd = is_back ? x0 : x1;
  const int64_t bump = (fwd <= f.primary && fwd + s - 1 >= f.primary);
  const int64_t same = (is_back ? x1 : x0) + bump + above;
  const int64_t side = f.L2[c] + 1 + tk_c;
  const int64_t sz = tl_c - tk_c;
  return is_back ? Iv3{side, same, sz} : Iv3{same, side, sz};
}

// bwt_extend for one base c: the bi-interval of (x0, x1, s) extended by
// c, backward (is_back) or forward, on one thread by eight independent
// 16-byte loads.
template <class FV>
BM_HD Iv3 fm_extend1_v(const FV& f, int64_t x0, int64_t x1, int64_t s,
                       bool is_back, int c) {
  const int64_t fwd = is_back ? x0 : x1;
  int64_t tk = 0, tl = 0, ak = 0, al = 0;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    fm_occ_chunk(f, fwd - 1, ch, c, &tk, &ak);
    fm_occ_chunk(f, fwd - 1 + s, ch, c, &tl, &al);
  }
  return fm_interval(f, x0, x1, s, is_back, c, tk, tl, al - ak);
}

// fm_extend1_v by the lanes of a group of 4 or 8 (team.cuh): the two rows'
// 64 bytes as one 16-byte load a lane and row (G = 4: lane t reads chunk
// t of both rows; G = 8: lane t chunk t & 3 of row t >> 2), the counts
// summed across the group.  Every lane gets the interval.
template <class TM, class FV>
BM_HD Iv3 fm_extend1_team(const TM& tm, const FV& f, int64_t x0,
                          int64_t x1, int64_t s, bool is_back, int c) {
  constexpr int NL = TM::NL;
  static_assert(TM::kG == 4 || TM::kG == 8, "a group of 4 or 8 lanes");
  const int64_t fwd = is_back ? x0 : x1;
  int64_t tk[NL], tl[NL], ab[NL];
  for (int l = 0; l < NL; ++l) {
    const int t = tm.lane(l);
    int64_t ak = 0, al = 0;
    tk[l] = tl[l] = 0;
    if (TM::kG == 4 || t < 4) fm_occ_chunk(f, fwd - 1, t & 3, c, &tk[l], &ak);
    if (TM::kG == 4 || t >= 4)
      fm_occ_chunk(f, fwd - 1 + s, t & 3, c, &tl[l], &al);
    ab[l] = al - ak;
  }
  return fm_interval(f, x0, x1, s, is_back, c, tm.sum_all(tk),
                     tm.sum_all(tl), tm.sum_all(ab));
}

// bwt_B0: the BWT symbol at $-removed position x.
template <class FV>
BM_HD int fm_b0(const FV& f, int64_t x) {
  const uint32_t w = fm_row(f, x >> 7)[8 + ((x >> 4) & 7)];
  return static_cast<int>(w >> (((~x) & 15) * 2)) & 3;
}

// bwt_invPsi: one inverse-Psi step.
template <class FV>
BM_HD int64_t fm_inv_psi(const FV& f, int64_t k) {
  if (k == f.primary) return 0;
  const int c = fm_b0(f, k - (k > f.primary ? 1 : 0));
  int64_t occ;
  if (k == f.seq_len) {
    occ = f.L2[c + 1] - f.L2[c];
  } else {
    int64_t cnt[4];
    fm_occ4(f, k, cnt);
    occ = cnt[c];
  }
  return f.L2[c] + occ;
}
