// Banded global alignment with traceback, one lane per thread.
//
// Replaces the TPU kernel bwamem_tpu/ops/pallas_global.py global_pallas,
// which bwamem_tpu/ops/ksw.py ksw_global2_batched calls.  It computes
// ksw_global2 (software/ksw.c:501-585; scalar model native/ksw.cpp
// bm_ksw_global2) and returns what the JAX function returns, so the host
// turns it into a CIGAR the same way (ops/ksw.py cigars_from_tracebacks):
// score = H[qlen], the traceback ops in reverse order (0=M 1=I 2=D), their
// count, and the row/column where the walk left the matrix.  The plain
// PyTorch version beside this kernel is ops/ksw.py global_plain.
//
// The direction byte of a cell is (f-flag << 4) | (e-flag << 2) | h-source
// at the absolute query column, as in the JAX row loop; cells out of the
// band and the rows of a degenerate band read back 0, because the JAX
// code never stores them.  The F term starts at -2^30 at the band edge
// and decays by e_ins per column: the e/f flags compare those exact
// values.
//
// What bounds it on an H100: the row DP is serial along the query (the F
// dependency) and the traceback is serial by nature, so one lane is
// O(tlen * band + tlen + qlen) dependent integer steps on one thread.  At
// the path's 1,024 lanes that is 8 blocks of 128 threads for 132 SMs, and
// every thread keeps H/E rows (about 1 KB) in local memory and writes its
// direction rows (LQ bytes per row) to a [B, LT, LQ] scratch in device
// memory that the traceback reads back.  A later version would give a
// lane a warp (an anti-diagonal or a prefix-max scan across the band) and
// keep the direction rows of a lane in shared memory.
#include <cstdint>

#ifdef __CUDACC__
#define BM_HD __host__ __device__ __forceinline__
#else
#define BM_HD inline
#endif

namespace {

constexpr int32_t kNeg = -0x40000000;

BM_HD int nib(const int8_t* row, int j) {
  return (row[j >> 1] >> ((j & 1) * 4)) & 15;
}

struct GloArgs {
  const int8_t *q, *t;       // packed rows [B, LQ/2] / [B, LT/2]
  const int32_t *qlen, *tlen, *w;
  int LT;
  int o_del, e_del, o_ins, e_ins;
  uint8_t* z;                // scratch [B, LT, LQ]
  int32_t* score;
  uint8_t* ops;              // [B, LT + LQ]
  int32_t *n_ops, *rem_i, *rem_k;
};

// ksw_global2_batched for lane b (bwamem_tpu/ops/ksw.py:369-490).
template <int LQ>
BM_HD void global_lane(const GloArgs& a, const int8_t* mat, int b) {
  const int LT = a.LT;
  const int qlen = a.qlen[b], tlen = a.tlen[b], w = a.w[b];
  const int oe_del = a.o_del + a.e_del, oe_ins = a.o_ins + a.e_ins;
  const int8_t* qpk = a.q + static_cast<int64_t>(b) * (LQ / 2);
  const int8_t* tpk = a.t + static_cast<int64_t>(b) * (LT / 2);
  uint8_t* z = a.z + static_cast<int64_t>(b) * LT * LQ;

  int8_t qs[LQ];
  for (int j = 0; j < LQ; ++j) qs[j] = static_cast<int8_t>(nib(qpk, j));
  // eh_h[j] = H(i-1, j-1), eh_e[j] = E(i, j) (ksw.c:520-526)
  int32_t eh_h[LQ + 1], eh_e[LQ + 1];
  const int w0 = qlen < w ? qlen : w;
  eh_h[0] = 0;
  eh_e[0] = kNeg;
  for (int j = 1; j <= LQ; ++j) {
    eh_h[j] = j <= w0 ? -(a.o_ins + a.e_ins * j) : kNeg;
    eh_e[j] = kNeg;
  }

  for (int i = 0; i < tlen; ++i) {
    uint8_t* zr = z + static_cast<int64_t>(i) * LQ;
    const int beg = i - w > 0 ? i - w : 0;
    const int end = i + w + 1 < qlen ? i + w + 1 : qlen;
    int32_t h1 = beg == 0 ? -(a.o_del + a.e_del * (i + 1)) : kNeg;
    if (end <= beg) {  // degenerate band: only eh[end] is stored
      if (end >= 0 && end <= LQ) {
        eh_h[end] = h1;
        eh_e[end] = kNeg;
      }
      for (int j = 0; j < LQ; ++j) zr[j] = 0;
      continue;
    }
    const int8_t* mrow = mat + nib(tpk, i) * 5;
    for (int j = 0; j < beg; ++j) zr[j] = 0;
    int32_t f = kNeg;
    for (int j = beg; j < end; ++j) {
      // the M term stays apart so the e/f flags compare against M, not H
      int32_t m = eh_h[j] + mrow[qs[j]];
      int32_t e = eh_e[j];
      eh_h[j] = h1;
      uint8_t d = m >= e ? 0 : 1;
      int32_t h = m >= e ? m : e;
      d = h >= f ? d : 2;
      h = h >= f ? h : f;
      h1 = h;
      int32_t t = m - oe_del;
      e -= a.e_del;
      d |= e > t ? 1 << 2 : 0;
      eh_e[j] = e > t ? e : t;
      t = m - oe_ins;
      f -= a.e_ins;
      d |= f > t ? 2 << 4 : 0;
      f = f > t ? f : t;
      zr[j] = d;
    }
    eh_h[end] = h1;
    eh_e[end] = kNeg;
    for (int j = end; j < LQ; ++j) zr[j] = 0;
  }
  a.score[b] = eh_h[qlen];

  // traceback (ksw.c:570-584): ops in reverse order
  uint8_t* ops = a.ops + static_cast<int64_t>(b) * (LT + LQ);
  int i = tlen - 1;
  int k = (i + w + 1 < qlen ? i + w + 1 : qlen) - 1;
  int which = 0, n = 0;
  while (i >= 0 && k >= 0) {
    which = (z[static_cast<int64_t>(i) * LQ + k] >> (which << 1)) & 3;
    ops[n++] = which == 0 ? 0 : (which == 1 ? 2 : 1);
    if (which != 2) --i;
    if (which != 1) --k;
  }
  for (int j = n; j < LT + LQ; ++j) ops[j] = 0;
  a.n_ops[b] = n;
  a.rem_i[b] = i;
  a.rem_k[b] = k;
}

#ifdef __CUDACC__
template <int LQ>
__global__ void global_kernel(GloArgs a, const int8_t* mat, int B) {
  __shared__ int8_t smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) global_lane<LQ>(a, smat, b);
}
#endif

}  // namespace

#ifdef __CUDACC__
// mat: device int8[25]; z: device uint8[B, LT, LQ] scratch.  Returns
// cudaGetLastError(); 1001 for an LQ without an instantiation.
extern "C" int bm_global2(int LQ, int LT, int B, const void* q,
                          const void* t, const void* qlen, const void* tlen,
                          const void* w, const void* mat, int o_del,
                          int e_del, int o_ins, int e_ins, void* z,
                          void* score, void* ops, void* n_ops, void* rem_i,
                          void* rem_k, void* stream) {
  GloArgs a;
  a.q = static_cast<const int8_t*>(q);
  a.t = static_cast<const int8_t*>(t);
  a.qlen = static_cast<const int32_t*>(qlen);
  a.tlen = static_cast<const int32_t*>(tlen);
  a.w = static_cast<const int32_t*>(w);
  a.LT = LT;
  a.o_del = o_del;
  a.e_del = e_del;
  a.o_ins = o_ins;
  a.e_ins = e_ins;
  a.z = static_cast<uint8_t*>(z);
  a.score = static_cast<int32_t*>(score);
  a.ops = static_cast<uint8_t*>(ops);
  a.n_ops = static_cast<int32_t*>(n_ops);
  a.rem_i = static_cast<int32_t*>(rem_i);
  a.rem_k = static_cast<int32_t*>(rem_k);
  if (LQ != 128) return 1001;
  const int threads = 128;
  const int grid = (B + threads - 1) / threads;
  if (B > 0)
    global_kernel<128><<<grid, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<const int8_t*>(mat), B);
  return static_cast<int>(cudaGetLastError());
}
#endif
