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
// ops/extbuild.py.
//
// What bounds it on an H100: loads.  It is a gather with no reuse: one
// thread per output byte (lane, row, byte), each reading two bases from
// the reads matrix (lq/rq) or from pac (lt/rt) and writing one byte;
// neighbouring threads write neighbouring bytes of one row and read
// neighbouring bases, so both sides coalesce.  The TPU kernel's one-hot
// matmuls, static-roll stages, byte planes and VMEM caps (MAX_READS,
// MAX_PAC_ROWS, power-of-two LQ, LT + 255 <= 1024) have no counterpart:
// coordinates are int64 and every bucket (LT up to 1056) is served.  A
// later version could fuse the build into the extension kernel and skip
// the rows' round trip through device memory.
#include <cstdint>

#ifdef __CUDACC__
#define BM_HD __host__ __device__ __forceinline__
#else
#define BM_HD inline
#endif

namespace {

struct BuildArgs {
  const int8_t* reads;  // [n_reads, W] bases, pad 4
  int W;
  const uint8_t* pac;   // 2-bit forward strand, 4 bases a byte
  int64_t l_pac;
  const int32_t *rid, *qb0, *slen, *lquery;
  const int64_t *rb0, *rmax0, *rmax1;
  int LQ, LT, B;
  int8_t *lq, *lt, *rq, *rt;  // [B, LQ/2] / [B, LT/2]
};

// The base at doubled-reference position p of a window on the reverse
// strand (rev) or the forward one.
BM_HD int ref_base(const BuildArgs& a, int64_t p, bool rev) {
  const int64_t f = rev ? 2 * a.l_pac - 1 - p : p;
  const int b = (a.pac[f >> 2] >> ((~f & 3) << 1)) & 3;
  return rev ? 3 - b : b;
}

// Output byte t of the B * (LQ + LT) bytes: lane t / (LQ + LT), then
// within the lane lq, rq (LQ/2 bytes each), lt, rt (LT/2 each).
BM_HD void build_byte(const BuildArgs& a, int64_t t) {
  const int per = a.LQ + a.LT;
  const int b = static_cast<int>(t / per);
  int k = static_cast<int>(t % per);
  const int hq = a.LQ >> 1, ht = a.LT >> 1;
  const int64_t qb0 = a.qb0[b], slen = a.slen[b], lquery = a.lquery[b];
  const int64_t qe0 = qb0 + slen;
  const int8_t* read = a.reads + static_cast<int64_t>(a.rid[b]) * a.W;
  int v[2];
  int8_t* out;
  if (k < 2 * hq) {  // query rows
    const bool left = k < hq;
    if (!left) k -= hq;
    for (int h = 0; h < 2; ++h) {
      const int64_t j = 2 * k + h;
      v[h] = left ? (j < qb0 ? read[qb0 - 1 - j] : 4)
                  : (j < lquery - qe0 ? read[qe0 + j] : 4);
    }
    out = (left ? a.lq : a.rq) + static_cast<int64_t>(b) * hq + k;
  } else {  // target rows
    k -= 2 * hq;
    const bool left = k < ht;
    if (!left) k -= ht;
    const int64_t rb0 = a.rb0[b];
    const bool rev = a.rmax0[b] >= a.l_pac;
    const int64_t len = left ? (qb0 > 0 ? rb0 - a.rmax0[b] : 0)
                             : (qe0 != lquery ? a.rmax1[b] - rb0 - slen : 0);
    for (int h = 0; h < 2; ++h) {
      const int64_t j = 2 * k + h;
      v[h] = j < len ? ref_base(a, left ? rb0 - 1 - j : rb0 + slen + j, rev)
                     : 4;
    }
    out = (left ? a.lt : a.rt) + static_cast<int64_t>(b) * ht + k;
  }
  *out = static_cast<int8_t>(v[0] | (v[1] << 4));
}

#ifdef __CUDACC__
__global__ void build_rows_kernel(BuildArgs a, int64_t total) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t < total) build_byte(a, t);
}
#endif

}  // namespace

#ifdef __CUDACC__
// reads int8 [n_reads, W]; pac uint8; rid/qb0/slen/lquery int32 [B];
// rb0/rmax0/rmax1 int64 [B]; outputs int8 [B, LQ/2] and [B, LT/2].
// Returns cudaGetLastError().
extern "C" int bm_build_rows(
    const void* reads, int W, const void* pac, int64_t l_pac,
    const void* rid, const void* qb0, const void* slen, const void* rb0,
    const void* rmax0, const void* rmax1, const void* lquery, int LQ,
    int LT, int B, void* lq, void* lt, void* rq, void* rt, void* stream) {
  BuildArgs a;
  a.reads = static_cast<const int8_t*>(reads);
  a.W = W;
  a.pac = static_cast<const uint8_t*>(pac);
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
  const int64_t total = static_cast<int64_t>(B) * (LQ + LT);
  const int threads = 256;
  const int64_t grid = (total + threads - 1) / threads;
  if (total > 0)
    build_rows_kernel<<<static_cast<unsigned>(grid), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a, total);
  return static_cast<int>(cudaGetLastError());
}
#endif
