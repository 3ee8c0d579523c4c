// Extension rows on the device: the four 4-bit-packed sequence rows of
// every seed's fused left+right extension, built from per-seed scalars,
// the chunk's reads and the 2-bit pac.
//
// Replaces the TPU kernel bwamem_tpu/ops/pallas_extbuild.py
// build_rows_pallas (_make_builder), which extend_lr_onchip feeds to the
// extension DP.  The rows equal the ones native/pack.cpp bm_pack_extlr
// writes for the host route (the slices of core/region.py
// seed_lr_request, software/bwamem.c:1121-1160):
//   lq[j] = query[qb0-1-j]         for j < qb0
//   rq[j] = query[qb0+slen+j]      for j < lquery-qb0-slen
//   lt[j] = base(rb0-1-j)          for j < rb0-rmax0, when qb0 > 0
//   rt[j] = base(rb0+slen+j)       for j < rmax1-rb0-slen, when the seed
//                                  does not end the read
// base(p) reads the forward strand at p, or at 2*l_pac-1-p complemented
// (3-b) when the chain's window lies on the reverse strand (rmax0 >=
// l_pac); pad 4 everywhere else, two bases a byte, low nibble first.
// The output is exactly what bm_extend_lr reads, so that kernel is
// unchanged.  The plain PyTorch version beside this kernel is
// ops/extbuild.py; like it, the kernel clamps a read position into the
// read's row and a reference position into the pac, so a lane out of
// range reads nothing past either.
//
// What bounds it on an H100: bytes.  It is a gather with no reuse that
// writes 11 MB at LQ=128/LT=544 over 16,384 seeds, and reads the seeds'
// scalars, a few hundred bytes of each read and ~LT/4 pac bytes a seed.
// The first version ran one thread per output byte (11 M threads at that
// shape), each with a 64-bit division by LQ + LT, seven scalar loads and
// a one-byte store.  Design: a thread builds 16 output bytes (32 bases)
// of one seed's row in registers and writes them as one 16-byte store
// (byte stores where a row's start is not 16-byte aligned: a bucket whose
// half-width is not a multiple of 16).  Block row 0 builds the query rows
// (lq, rq), block row 1 the target rows (lt, rt), so a warp runs one of
// the two paths; within a block row a thread's seed and chunk come from
// its index (one 32-bit division), consecutive threads taking
// consecutive chunks of a row.  A target chunk is 32 consecutive
// reference bases, at most 9 pac bytes: three aligned 32-bit words, byte
// swapped into one big-endian bit stream, shifted into a 64-bit window,
// the 2-bit groups reversed when the chunk walks the pac forwards
// (complemented on the reverse strand), then spread into nibbles.  A
// query chunk is 32 consecutive bytes of the read's row (width W is
// arbitrary): nine aligned words, funnel-shifted into place.  A warp per
// seed (the chunks of all four rows across its lanes) measured 0.033 ms
// at that shape on the bundled genome: its lanes took the query and the
// target path in turn, and a query chunk's 32 byte loads ran one after
// another.
//
// g++ builds the same source (bm_build_rows_host): ops/emulate.py holds it
// against the plain version on the CPU.
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define BM_HD __host__ __device__ __forceinline__
#else
#define BM_HD inline
#endif

namespace {

constexpr int kThreads = 128;   // a block: 128 chunks

struct BuildArgs {
  const int8_t* reads;  // [n_reads, W] bases, pad 4
  int n_reads, W;
  bool read_words;      // 4-byte aligned: read as 32-bit words
  const uint8_t* pac;   // 2-bit forward strand, 4 bases a byte
  int64_t n_pac;        // its bytes
  bool pac_words;       // 4-byte aligned: read as 32-bit words
  int64_t l_pac;
  const int32_t *rid, *qb0, *slen, *lquery;
  const int64_t *rb0, *rmax0, *rmax1;
  int LQ, LT, B;
  int8_t *lq, *lt, *rq, *rt;  // [B, LQ/2] / [B, LT/2]
};

// A seed's scalars, loaded by each thread that builds one of its chunks.
struct Seed {
  const int8_t* read;     // its read's row
  int64_t row_off;        // the row's first byte in the reads matrix
  int64_t qb0, qe0, nr;   // the seed on the read; bases right of it
  int64_t rb0, re0;       // the seed on the doubled reference
  int64_t llen, rlen;     // the target rows' lengths
  bool rev;               // the chain's window on the reverse strand
};

BM_HD Seed load_seed(const BuildArgs& a, int b) {
  Seed s;
  int64_t r = a.rid[b];
  r = r < 0 ? 0 : (r >= a.n_reads ? a.n_reads - 1 : r);
  s.row_off = r * a.W;
  s.read = a.reads + s.row_off;
  const int64_t slen = a.slen[b], lquery = a.lquery[b];
  const int64_t rmax0 = a.rmax0[b];
  s.qb0 = a.qb0[b];
  s.qe0 = s.qb0 + slen;
  s.nr = lquery - s.qe0;
  s.rb0 = a.rb0[b];
  s.re0 = s.rb0 + slen;
  s.rev = rmax0 >= a.l_pac;
  s.llen = s.qb0 > 0 ? s.rb0 - rmax0 : 0;
  s.rlen = s.qe0 != lquery ? a.rmax1[b] - s.re0 : 0;
  return s;
}

BM_HD uint32_t bswap32(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __byte_perm(v, 0, 0x0123);
#else
  return __builtin_bswap32(v);
#endif
}

// Bytes [4w, 4w + 4) of an n-byte array as a little-endian word (word
// loads where `words`); bytes outside the array read 0.
BM_HD uint32_t load_word(const uint8_t* p, int64_t n, bool words,
                         int64_t w) {
  const int64_t i = 4 * w;
  if (words && i >= 0 && i + 4 <= n) {
    uint32_t v;
#ifdef __CUDA_ARCH__
    v = *reinterpret_cast<const uint32_t*>(p + i);
#else
    std::memcpy(&v, p + i, 4);
#endif
    return v;
  }
  uint32_t v = 0;
  for (int k = 0; k < 4; ++k)
    if (i + k >= 0 && i + k < n)
      v |= static_cast<uint32_t>(p[i + k]) << 8 * k;
  return v;
}

// pac bytes [4w, 4w + 4) as a big-endian word: the base at pac position
// 16w + m in bits (31 - 2m, 30 - 2m).
BM_HD uint32_t pac_word(const BuildArgs& a, int64_t w) {
  return bswap32(load_word(a.pac, a.n_pac, a.pac_words, w));
}

// (hi:lo) >> sh, the low 32 bits; sh in [0, 32).
BM_HD uint32_t funnel(uint32_t lo, uint32_t hi, int sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, sh);
#else
  return static_cast<uint32_t>(((static_cast<uint64_t>(hi) << 32) | lo) >>
                               sh);
#endif
}

// The order of the 32 2-bit groups of x reversed.
BM_HD uint64_t reverse_pairs(uint64_t x) {
  const uint64_t m2 = 0x3333333333333333ull, m4 = 0x0F0F0F0F0F0F0F0Full;
  x = ((x >> 2) & m2) | ((x & m2) << 2);
  x = ((x >> 4) & m4) | ((x & m4) << 4);
  return (static_cast<uint64_t>(bswap32(static_cast<uint32_t>(x))) << 32) |
         bswap32(static_cast<uint32_t>(x >> 32));
}

// 16 bases of 2 bits (base t in bits 2t, 2t + 1) as 16 nibbles, pad 4
// from base n on: 8 output bytes, low nibble first.
BM_HD uint64_t nibbles(uint32_t v, int n) {
  uint64_t x = v;
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFull;
  x = (x | (x << 8)) & 0x00FF00FF00FF00FFull;
  x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x << 2)) & 0x3333333333333333ull;
  const uint64_t keep = n >= 16 ? ~0ull : (1ull << (4 * n)) - 1;
  return (x & keep) | (0x4444444444444444ull & ~keep);
}

// Two bases (raw read bytes) as one output byte, as the plain version
// packs them: the first's low 8 bits or'd with the second's shifted 4.
BM_HD uint64_t pair_byte(uint32_t b0, uint32_t b1) {
  return (b0 | (b1 << 4)) & 0xFF;
}

// Chunk c of a query row (lq: left, else rq): its 16 bytes into out.
// Base j of the row is read byte p0 - t (left) or p0 + t (right),
// t = j - 32c, for j below the row's length, pad 4 past it.
BM_HD void query_chunk(const BuildArgs& a, const Seed& s, bool left, int c,
                       uint64_t out[2]) {
  int64_t m = (left ? s.qb0 : s.nr) - 32 * c;   // the chunk's bases
  m = m < 0 ? 0 : (m > 32 ? 32 : m);
  const int64_t p0 = left ? s.qb0 - 1 - 32 * c : s.qe0 + 32 * c;
  const int64_t lo = left ? p0 - (m - 1) : p0, hi = left ? p0 : p0 + m - 1;
  uint32_t ub[32];   // base t's read byte
  if (m > 0 && lo >= 0 && hi < a.W) {
    // the 32 bytes from the window's first, as eight words: nine aligned
    // words funnel-shifted into place (bytes outside the window, even
    // outside the matrix, are never kept)
    const int64_t ws = s.row_off + (left ? p0 - 31 : p0);
    const int64_t w0 = ws >> 2;
    const int sh = static_cast<int>(ws - 4 * w0) * 8;
    const int64_t n_bytes = static_cast<int64_t>(a.n_reads) * a.W;
    const uint8_t* rd = reinterpret_cast<const uint8_t*>(a.reads);
    uint32_t w[9], v[8];
#pragma unroll
    for (int i = 0; i < 9; ++i) w[i] = load_word(rd, n_bytes, a.read_words,
                                                 w0 + i);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = funnel(w[i], w[i + 1], sh);
    if (left) {
#pragma unroll
      for (int t = 0; t < 32; ++t)
        ub[t] = (v[(31 - t) >> 2] >> (8 * ((31 - t) & 3))) & 0xFF;
    } else {
#pragma unroll
      for (int t = 0; t < 32; ++t) ub[t] = (v[t >> 2] >> (8 * (t & 3))) & 0xFF;
    }
  } else {  // a position outside the row (a lane out of range): each
            // clamped into it, as the plain version does
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      int64_t pos = left ? p0 - t : p0 + t;
      pos = pos < 0 ? 0 : (pos >= a.W ? a.W - 1 : pos);
      ub[t] = t < m ? static_cast<uint8_t>(s.read[pos]) : 4;
    }
  }
  out[0] = out[1] = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    out[k >> 3] |= pair_byte(2 * k < m ? ub[2 * k] : 4,
                             2 * k + 1 < m ? ub[2 * k + 1] : 4)
                   << (8 * (k & 7));
}

// Chunk c of a target row (lt: left, else rt): its 16 bytes into out.
// Base j of the row is at doubled-reference position rb0 - 1 - j (left)
// or re0 + j (right), so the chunk's 32 bases are consecutive forward-
// strand positions f = F0 + sg * t, t = j - 32c.
BM_HD void target_chunk(const BuildArgs& a, const Seed& s, bool left, int c,
                        uint64_t out[2]) {
  int64_t m = (left ? s.llen : s.rlen) - 32 * c;  // the chunk's bases
  m = m < 0 ? 0 : (m > 32 ? 32 : m);
  const int64_t p = left ? s.rb0 - 1 - 32 * c : s.re0 + 32 * c;
  const int64_t F0 = s.rev ? 2 * a.l_pac - 1 - p : p;
  const int sg = left != s.rev ? -1 : 1;
  const int64_t Fm = F0 + sg * (m - 1);
  uint64_t x = 0;  // base t in bits 2t, 2t + 1
  if (m > 0 && (F0 < Fm ? F0 : Fm) >= 0 && (F0 > Fm ? F0 : Fm) < 4 * a.n_pac) {
    // the 32 positions from ws up, as a window of 64 bits: position
    // ws + q in bits (63 - 2q, 62 - 2q)
    const int64_t ws = sg > 0 ? F0 : F0 - 31;
    const int64_t w = ws >> 4;   // floor: ws may be below 0 when m < 32
    const int o = static_cast<int>(ws - 16 * w);
    uint64_t win = (static_cast<uint64_t>(pac_word(a, w)) << 32) |
                   pac_word(a, w + 1);
    if (o) win = (win << (2 * o)) | (pac_word(a, w + 2) >> (32 - 2 * o));
    // walking forwards base t is q = t, backwards q = 31 - t
    x = sg > 0 ? reverse_pairs(win) : win;
  } else {  // a position past the pac (a lane out of range): each base
            // clamped into it, as the plain version does
    for (int t = 0; t < m; ++t) {
      int64_t f = F0 + sg * t;
      f = f < 0 ? 0 : (f >= 4 * a.n_pac ? 4 * a.n_pac - 1 : f);
      x |= static_cast<uint64_t>((a.pac[f >> 2] >> ((~f & 3) << 1)) & 3)
           << (2 * t);
    }
  }
  if (s.rev) x = ~x;   // 3 - b
  const int n = static_cast<int>(m);
  out[0] = nibbles(static_cast<uint32_t>(x), n < 16 ? n : 16);
  out[1] = nibbles(static_cast<uint32_t>(x >> 32), n > 16 ? n - 16 : 0);
}

// nb bytes of out at dst: one 16-byte store where it can.
BM_HD void store_chunk(int8_t* dst, int nb, const uint64_t out[2]) {
#ifdef __CUDA_ARCH__
  if (nb == 16 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        static_cast<uint32_t>(out[0]), static_cast<uint32_t>(out[0] >> 32),
        static_cast<uint32_t>(out[1]), static_cast<uint32_t>(out[1] >> 32));
    return;
  }
  for (int k = 0; k < nb; ++k)
    dst[k] = static_cast<int8_t>(out[k >> 3] >> (8 * (k & 7)));
#else
  std::memcpy(dst, out, nb);   // the hosts the emulation builds for are
                               // little-endian
#endif
}

// The chunks of one row of `half` bytes, 16 bytes a chunk, the last
// shorter where the width is not a multiple of 16.
BM_HD int chunks(int half) { return (half + 15) >> 4; }

// Chunk c of seed b's query rows (lq, then rq; cls 0) or target rows
// (lt, then rt; cls 1).
BM_HD void build_chunk(const BuildArgs& a, int cls, int b, int c) {
  const int half = cls ? a.LT >> 1 : a.LQ >> 1;
  const int per = chunks(half);
  const bool left = c < per;
  if (!left) c -= per;
  const Seed s = load_seed(a, b);
  uint64_t out[2];
  int8_t* row;
  if (cls) {
    target_chunk(a, s, left, c, out);
    row = left ? a.lt : a.rt;
  } else {
    query_chunk(a, s, left, c, out);
    row = left ? a.lq : a.rq;
  }
  const int nb = half - 16 * c < 16 ? half - 16 * c : 16;
  store_chunk(row + static_cast<int64_t>(b) * half + 16 * c, nb, out);
}

BuildArgs build_args(const void* reads, int n_reads, int W, const void* pac,
                     int64_t n_pac, int64_t l_pac, const void* rid,
                     const void* qb0, const void* slen, const void* rb0,
                     const void* rmax0, const void* rmax1,
                     const void* lquery, int LQ, int LT, int B, void* lq,
                     void* lt, void* rq, void* rt) {
  BuildArgs a;
  a.reads = static_cast<const int8_t*>(reads);
  a.n_reads = n_reads;
  a.W = W;
  a.read_words = (reinterpret_cast<uintptr_t>(reads) & 3) == 0;
  a.pac = static_cast<const uint8_t*>(pac);
  a.n_pac = n_pac;
  a.pac_words = (reinterpret_cast<uintptr_t>(pac) & 3) == 0;
  a.l_pac = l_pac;
  a.rid = static_cast<const int32_t*>(rid);
  a.qb0 = static_cast<const int32_t*>(qb0);
  a.slen = static_cast<const int32_t*>(slen);
  a.lquery = static_cast<const int32_t*>(lquery);
  a.rb0 = static_cast<const int64_t*>(rb0);
  a.rmax0 = static_cast<const int64_t*>(rmax0);
  a.rmax1 = static_cast<const int64_t*>(rmax1);
  a.LQ = LQ;
  a.LT = LT;
  a.B = B;
  a.lq = static_cast<int8_t*>(lq);
  a.lt = static_cast<int8_t*>(lt);
  a.rq = static_cast<int8_t*>(rq);
  a.rt = static_cast<int8_t*>(rt);
  return a;
}

#ifdef __CUDACC__
// blockIdx.y: the row class (0 query, 1 target); thread t of the class
// builds chunk t mod (2 x chunks a row) of seed t / (2 x chunks a row).
__global__ void __launch_bounds__(kThreads) build_rows_kernel(BuildArgs a) {
  const int cls = blockIdx.y;
  const int two = 2 * chunks(cls ? a.LT >> 1 : a.LQ >> 1);
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.B * two) return;
  const int b = t / two;
  build_chunk(a, cls, b, t - b * two);
}
#endif

}  // namespace

// reads int8 [n_reads, W] (n_reads, W >= 1); pac uint8 [n_pac];
// rid/qb0/slen/lquery int32 [B]; rb0/rmax0/rmax1 int64 [B]; outputs int8
// [B, LQ/2] and [B, LT/2]; B times the chunks of a seed's two rows of
// either class below 2^31.
#ifdef __CUDACC__
// Returns cudaGetLastError(); 1002 for a launch past 2^31 chunks.
extern "C" int bm_build_rows(
    const void* reads, int n_reads, int W, const void* pac, int64_t n_pac,
    int64_t l_pac, const void* rid, const void* qb0, const void* slen,
    const void* rb0, const void* rmax0, const void* rmax1,
    const void* lquery, int LQ, int LT, int B, void* lq, void* lt, void* rq,
    void* rt, void* stream) {
  const BuildArgs a = build_args(reads, n_reads, W, pac, n_pac, l_pac, rid,
                                 qb0, slen, rb0, rmax0, rmax1, lquery, LQ,
                                 LT, B, lq, lt, rq, rt);
  const int64_t most = static_cast<int64_t>(B) * 2 *
                       chunks((LQ > LT ? LQ : LT) >> 1);
  if (most >= (int64_t{1} << 31)) return 1002;
  if (B > 0)
    build_rows_kernel<<<dim3(static_cast<unsigned>(
                                 (most + kThreads - 1) / kThreads), 2),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
#else
// The host emulation (g++): the same arguments on host memory, without
// the stream; each class's chunks in the kernel's order.  Returns 0.
extern "C" int bm_build_rows_host(
    const void* reads, int n_reads, int W, const void* pac, int64_t n_pac,
    int64_t l_pac, const void* rid, const void* qb0, const void* slen,
    const void* rb0, const void* rmax0, const void* rmax1,
    const void* lquery, int LQ, int LT, int B, void* lq, void* lt, void* rq,
    void* rt) {
  const BuildArgs a = build_args(reads, n_reads, W, pac, n_pac, l_pac, rid,
                                 qb0, slen, rb0, rmax0, rmax1, lquery, LQ,
                                 LT, B, lq, lt, rq, rt);
  for (int cls = 0; cls < 2; ++cls) {
    const int two = 2 * chunks(cls ? LT >> 1 : LQ >> 1);
    for (int b = 0; b < B; ++b)
      for (int c = 0; c < two; ++c) build_chunk(a, cls, b, c);
  }
  return 0;
}
#endif
