// Local Smith-Waterman with ksw_u8 / ksw_i16 semantics, one lane per
// thread.
//
// Replaces the TPU kernel bwamem_tpu/ops/pallas_align.py align_pallas,
// which bwamem_tpu/ops/ksw_align.py ksw_align_batched calls.  The
// reference's kernels are SSE2 Farrar-striped (software/ksw.c:110-364);
// their result equals plain SW over a virtual query of ceil(qlen/p)*p
// positions (p = 16 for u8, 8 for i16) whose pad columns score 0, with
// u8 saturation reproduced by clipping the diagonal term to
// [0, 255 - shift].  The scalar model is native/ksw.cpp ksw_core; the
// batched contract, which this kernel returns, is ksw_align_batched:
// gmax, te, the smallest virtual column qe reaching max(Hmax), the
// saturation flag, each row's maximum (0 for rows not run) for the
// host's second-best replay, and the last row computed.  The early stop
// comes at gmax + shift >= 255 (u8) or gmax >= endsc.  The plain PyTorch
// version beside this kernel is ops/ksw_align.py align_plain.
//
// What bounds it on an H100: the row DP is serial along the query (the F
// dependency), so one lane is O(tlen * vlen) dependent integer steps on
// one thread; at the path's 512 lanes that is 4 blocks of 128 threads
// for 132 SMs.  H, E and Hmax (1.5 KB) live in local memory, served by
// L1, and each row's maximum goes to device memory.  A later version
// would run a lane on a warp, the striped layout the reference uses
// (p columns in parallel, a lazy-F correction loop).
#include <cstdint>

#ifdef __CUDACC__
#define BM_HD __host__ __device__ __forceinline__
#else
#define BM_HD inline
#endif

namespace {

struct AlnArgs {
  const int8_t *q, *t;       // bases [B, LQV] / [B, LT]
  const int32_t *qlen, *tlen, *endsc;
  int LT;
  int o_del, e_del, o_ins, e_ins, shift;
  int32_t *gmax, *te, *qe;
  uint8_t* saturated;
  int32_t* row_max;          // [B, LT]
  int32_t* last;
};

// ksw_align_batched for lane b (bwamem_tpu/ops/ksw_align.py:70-139);
// SIZE 1 = ksw_u8, 2 = ksw_i16.
template <int SIZE, int LQV>
BM_HD void align_lane(const AlnArgs& a, const int8_t* mat, int b) {
  const int LT = a.LT;
  const int qlen = a.qlen[b], tlen = a.tlen[b], endsc = a.endsc[b];
  const int p = SIZE == 1 ? 16 : 8;
  const int vlen = (qlen + p - 1) / p * p;
  const int sat = 255 - a.shift;
  const int oe_del = a.o_del + a.e_del, oe_ins = a.o_ins + a.e_ins;
  const int8_t* qrow = a.q + static_cast<int64_t>(b) * LQV;
  const int8_t* trow = a.t + static_cast<int64_t>(b) * LT;
  int32_t* row_max = a.row_max + static_cast<int64_t>(b) * LT;

  int8_t qs[LQV];
  int32_t H[LQV], E[LQV], Hmax[LQV];
  for (int j = 0; j < vlen; ++j) {
    qs[j] = j < qlen ? qrow[j] : -1;   // -1: a pad column, scores 0
    H[j] = E[j] = Hmax[j] = 0;
  }
  int32_t gmax = 0;
  int te = -1, last = -1;
  bool saturated = false;
  int i = 0;
  for (; i < tlen; ++i) {
    const int8_t* mrow = mat + trow[i] * 5;
    int32_t hdiag = 0, f = 0, imax = 0;   // hdiag = H(i-1, j-1)
    for (int j = 0; j < vlen; ++j) {
      int32_t g = hdiag + (qs[j] >= 0 ? mrow[qs[j]] : 0);
      hdiag = H[j];
      if (SIZE == 1) g = g < 0 ? 0 : (g > sat ? sat : g);
      g = g > E[j] ? g : E[j];
      const int32_t h = g > f ? g : f;
      H[j] = h;
      imax = imax > h ? imax : h;
      int32_t t = h - oe_del;
      t = t > 0 ? t : 0;
      E[j] = E[j] - a.e_del > t ? E[j] - a.e_del : t;
      t = g - oe_ins;
      t = t > 0 ? t : 0;
      f = f - a.e_ins > t ? f - a.e_ins : t;
    }
    row_max[i] = imax;
    last = i;
    if (imax > gmax) {
      gmax = imax;
      te = i;
      for (int j = 0; j < vlen; ++j) Hmax[j] = H[j];
      if (SIZE == 1 && gmax + a.shift >= 255) {
        saturated = true;
        ++i;
        break;
      }
      if (gmax >= endsc) {
        ++i;
        break;
      }
    }
  }
  for (; i < LT; ++i) row_max[i] = 0;   // rows not run
  // qe: the smallest column reaching max(Hmax); pad columns past vlen
  // hold 0, so with no positive cell it is column 0
  int32_t mx = 0;
  for (int j = 0; j < vlen; ++j) mx = Hmax[j] > mx ? Hmax[j] : mx;
  int qe = 0;
  for (int j = 0; j < vlen; ++j)
    if (Hmax[j] == mx) {
      qe = j;
      break;
    }
  a.gmax[b] = gmax;
  a.te[b] = te;
  a.qe[b] = qe;
  a.saturated[b] = saturated ? 1 : 0;
  a.last[b] = last;
}

#ifdef __CUDACC__
template <int SIZE, int LQV>
__global__ void align_kernel(AlnArgs a, const int8_t* mat, int B) {
  __shared__ int8_t smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) align_lane<SIZE, LQV>(a, smat, b);
}
#endif

}  // namespace

#ifdef __CUDACC__
// mat: device int8[25].  Returns cudaGetLastError(); 1001 for an
// (LQV, size) without an instantiation.
extern "C" int bm_align2(int size, int LQV, int LT, int B, const void* q,
                         const void* t, const void* qlen, const void* tlen,
                         const void* endsc, const void* mat, int o_del,
                         int e_del, int o_ins, int e_ins, int shift,
                         void* gmax, void* te, void* qe, void* saturated,
                         void* row_max, void* last, void* stream) {
  AlnArgs a;
  a.q = static_cast<const int8_t*>(q);
  a.t = static_cast<const int8_t*>(t);
  a.qlen = static_cast<const int32_t*>(qlen);
  a.tlen = static_cast<const int32_t*>(tlen);
  a.endsc = static_cast<const int32_t*>(endsc);
  a.LT = LT;
  a.o_del = o_del;
  a.e_del = e_del;
  a.o_ins = o_ins;
  a.e_ins = e_ins;
  a.shift = shift;
  a.gmax = static_cast<int32_t*>(gmax);
  a.te = static_cast<int32_t*>(te);
  a.qe = static_cast<int32_t*>(qe);
  a.saturated = static_cast<uint8_t*>(saturated);
  a.row_max = static_cast<int32_t*>(row_max);
  a.last = static_cast<int32_t*>(last);
  if (LQV != 128 || (size != 1 && size != 2)) return 1001;
  const int threads = 128;
  const int grid = (B + threads - 1) / threads;
  const auto* m = static_cast<const int8_t*>(mat);
  auto s = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    if (size == 1)
      align_kernel<1, 128><<<grid, threads, 0, s>>>(a, m, B);
    else
      align_kernel<2, 128><<<grid, threads, 0, s>>>(a, m, B);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
