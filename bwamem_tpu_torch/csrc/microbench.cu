// Microbenchmark kernels: dependent row-fetch chains and a loop inside
// one kernel.
//
// bm_row_chain replaces the TPU kernels of tools/microbench_dmawave.py
// (the in-kernel DMA wave, :109), tools/microbench_bigsmem.py gwk
// (:165 with a grid, :179 without: K independent wave chains in flight
// together) and gw (:261: the dependency through the decoded occ block,
// the transposed rows or the row sum).  Each of C lanes runs K chains of
// T steps over an int32 (n_rows, W) table; a step fetches the chain's
// row and derives the next row id from it:
//
//   dep    ((old ^ s) * 1103515245 + 12345 + t) % n_rows, s = the row sum
//   nodep  (old * 1103515245 + 12345 + t) % n_rows; the row is fetched
//          and summed but the next id does not wait for it
//   null   as nodep, with no fetch
//   full   (old + row[0] + row[8] + t) % n_rows: the first checkpoint
//          word and the first BWT word of a 64-byte occ block
//   xpose  (old + row'[0] + t) % n_rows, row' the first row of the
//          512-byte group holding old (the TPU's wide row, transposed)
//   dma    (old + s + t) % n_rows
//
// All in uint32 arithmetic (the TPU's int32 wraps; n_rows a power of two
// makes % the TPU's & MASK).  The TPU's `dma` and gwk modes sum the
// whole wave of C rows into one scalar, a vector reduction that is free
// there; on the card that is a grid-wide barrier each step, so here each
// lane sums its own row, which keeps the step waiting on the bytes it
// fetched.  `vdirect` of microbench_dmawave.py is `dep` here: the card
// has no index bounce.  The output per lane is the sum over its chains
// of the last row id plus the sum of every row it fetched, so no fetch
// can be dropped.  Plain PyTorch version: ops/occ.py row_chain_plain.
//
// bm_affine_loop replaces tools/microbench_palloop.py (:51): c = c *
// 1.000001 + 0.5 ITERS times inside one kernel, against ITERS launches
// of one step.  __fmul_rn/__fadd_rn keep nvcc from contracting the two
// into an FMA, so the kernel equals its plain version (two PyTorch ops
// a step) bit for bit.  Plain version: ops/occ.py affine_loop_plain.
//
// What bounds them on an H100: a chain waits on one dependent fetch per
// step (latency: L2 for tables under 50 MB, HBM and the TLB beyond);
// the K chains of a thread and the lanes of the card are what is in
// flight.  The loop is bound by its 2 x ITERS dependent float operations
// per element.  Design: one thread per lane with K (1, 2, 4, 8) a
// template argument, so the K fetches of a step are issued before the
// first is used; 16-byte loads; int64 row offsets (a 4 GB table has rows
// past 2^31 bytes).
#include "fm.cuh"

namespace {

enum ChainMode { kDep = 0, kNodep = 1, kNull = 2, kFull = 3, kXpose = 4,
                 kDma = 5 };
constexpr uint32_t kMulA = 1103515245u;
constexpr uint32_t kAddB = 12345u;

struct Words4 {
  uint32_t x, y, z, w;
};

BM_HD Words4 load4(const int32_t* p) {
#ifdef __CUDA_ARCH__
  const int4 v = *reinterpret_cast<const int4*>(p);
  return Words4{static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};
#else
  return Words4{static_cast<uint32_t>(p[0]), static_cast<uint32_t>(p[1]),
                static_cast<uint32_t>(p[2]), static_cast<uint32_t>(p[3])};
#endif
}

// One lane's K chains; W a multiple of 4 (16 for full), n_rows <= 2^32.
// A starting id outside the table is taken mod n_rows, as every later one.
template <int K>
BM_HD int32_t chain_lane(const int32_t* table, uint32_t n_rows, int W,
                         const int32_t* idx0, int64_t C, int T, int mode,
                         int64_t i) {
  uint32_t st[K], acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    st[k] = static_cast<uint32_t>(idx0[k * C + i]) % n_rows;
    acc[k] = 0;
  }
  for (int t = 0; t < T; ++t) {
    uint32_t s[K], w0[K], w8[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = w0[k] = w8[k] = 0;
    if (mode != kNull) {
      const int32_t* row[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        row[k] = table + static_cast<int64_t>(
                             mode == kXpose ? (st[k] & ~7u) : st[k]) * W;
#pragma unroll 4
      for (int v = 0; v < W; v += 4) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const Words4 q = load4(row[k] + v);
          s[k] += q.x + q.y + q.z + q.w;
          if (v == 0) w0[k] = q.x;
          if (v == 8) w8[k] = q.x;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t old = st[k];
      uint32_t nxt;
      switch (mode) {
        case kDep: nxt = (old ^ s[k]) * kMulA + kAddB + t; break;
        case kFull: nxt = old + w0[k] + w8[k] + t; break;
        case kXpose: nxt = old + w0[k] + t; break;
        case kDma: nxt = old + s[k] + t; break;
        default: nxt = old * kMulA + kAddB + t;  // nodep, null
      }
      acc[k] += s[k];
      st[k] = nxt % n_rows;
    }
  }
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) out += st[k] + acc[k];
  return static_cast<int32_t>(out);
}

BM_HD float affine_step(float c) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(__fmul_rn(c, 1.000001f), 0.5f);
#else
  const float p = c * 1.000001f;
  return p + 0.5f;
#endif
}

#ifdef __CUDACC__
template <int K>
__global__ void row_chain_kernel(const int32_t* __restrict__ table,
                                 uint32_t n_rows, int W,
                                 const int32_t* __restrict__ idx0,
                                 int64_t C, int T, int mode,
                                 int32_t* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
                    + threadIdx.x;
  if (i < C) out[i] = chain_lane<K>(table, n_rows, W, idx0, C, T, mode, i);
}

__global__ void affine_loop_kernel(const float* __restrict__ x, int64_t n,
                                   int iters, float* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
                    + threadIdx.x;
  if (i >= n) return;
  float c = x[i];
  for (int it = 0; it < iters; ++it) c = affine_step(c);
  out[i] = c;
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" int bm_row_chain(const void* table, int64_t n_rows, int W,
                            const void* idx0, int64_t C, int K, int T,
                            int mode, void* out, void* stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((C + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* tb = static_cast<const int32_t*>(table);
  const int32_t* i0 = static_cast<const int32_t*>(idx0);
  int32_t* o = static_cast<int32_t*>(out);
  const uint32_t n = static_cast<uint32_t>(n_rows);
  if (C <= 0) return static_cast<int>(cudaGetLastError());
  switch (K) {
    case 1: row_chain_kernel<1><<<blocks, threads, 0, s>>>(
                tb, n, W, i0, C, T, mode, o); break;
    case 2: row_chain_kernel<2><<<blocks, threads, 0, s>>>(
                tb, n, W, i0, C, T, mode, o); break;
    case 4: row_chain_kernel<4><<<blocks, threads, 0, s>>>(
                tb, n, W, i0, C, T, mode, o); break;
    case 8: row_chain_kernel<8><<<blocks, threads, 0, s>>>(
                tb, n, W, i0, C, T, mode, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bm_affine_loop(const void* x, int64_t n, int iters, void* out,
                              void* stream) {
  const int threads = 256;
  if (n > 0)
    affine_loop_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                         threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n, iters, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
#endif
