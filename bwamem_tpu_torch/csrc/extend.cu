// Banded extension, one lane per thread: the fused left+right extension
// of a seed, and the bare ksw_extend2 call.
//
// Replaces the TPU kernel bwamem_tpu/ops/pallas_extend.py _call
// (_make_kernel, via extend_pallas), which bwamem_tpu/ops/ksw.py calls
// through two entries.  bm_extend_lr covers the whole of _extend_lr_core,
// which calls it up to four times per seed: left at w, left retry at 2w,
// the left decision, right at w, right retry at 2w, the right decision
// (software/bwamem.c:1120-1176).  bm_extend2 is ksw_extend2_batched, one
// ksw_extend2 per lane with its own band, end bonus and h0: the traced
// path yields each attempt on its own.  The DP is ksw_extend2
// (software/ksw.c:379-477) as in native/ksw.cpp bm_ksw_extend2: affine
// gaps, band clamp through double, z-drop, end-bonus gscore tracking,
// later-index-wins row maxima and band narrowing.  The plain PyTorch
// version beside this kernel is ops/ksw.py.
//
// What bounds it on an H100: the DP is serial along a row (the F
// dependency), so one seed is O(tlen * band) dependent integer steps on
// one thread, and the band state eh_h/eh_e[LQ+2] (about 1 KB at LQ=128)
// lives in local memory, served by L1.  Both entries are instantiated for
// LQ = 128, 256 and 512, the JAX engine's query buckets (ops/engine.py
// _ext_shapes); at LQ=512 hh/ee/qs take 4,624 bytes of local memory per
// thread (the ptxas stack and spill numbers of each instantiation are in
// PERF.md), more than L1 holds for a full SM, so the long buckets' band
// state also moves through L2.  Design: one thread per seed and
// thousands of seeds per launch (WAVE_EXT), sequences read straight from
// the 4-bit-packed rows the host packer writes, the 5x5 scoring matrix in
// shared memory.  Lanes are size-sorted by the caller, so a warp's
// threads run rows of similar count.  bm_extend2 runs at most WAVE (512)
// lanes a launch, 4 blocks of 128 threads for 132 SMs, unsorted: its
// launches are latency-bound, and a later version would give a lane a
// warp (a prefix-max scan across the band) to fill the card.
#include <cstdint>

#ifdef __CUDACC__
#define BM_HD __host__ __device__ __forceinline__
#else
#define BM_HD inline
#endif

namespace {

struct Ext6 {
  int32_t best, qle, tle, gtle, gscore, max_off;
};

BM_HD int nib(const int8_t* row, int j) {
  return (row[j >> 1] >> ((j & 1) * 4)) & 15;
}

// ksw_extend2 over a 4-bit-packed query/target pair.
template <int LQ>
BM_HD Ext6 ksw_extend2(const int8_t* qpk, int qlen, const int8_t* tpk,
                       int tlen, const int8_t* mat, int o_del, int e_del,
                       int o_ins, int e_ins, int w, int end_bonus, int zdrop,
                       int h0) {
  if (h0 < 0) h0 = 0;
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  int8_t qs[LQ];
  for (int j = 0; j < qlen; ++j) qs[j] = static_cast<int8_t>(nib(qpk, j));
  int32_t hh[LQ + 2], ee[LQ + 2];
  for (int j = 0; j <= qlen + 1; ++j) hh[j] = ee[j] = 0;
  hh[0] = h0;
  if (qlen >= 1) {
    hh[1] = h0 > oe_ins ? h0 - oe_ins : 0;
    for (int j = 2; j <= qlen && hh[j - 1] > e_ins; ++j)
      hh[j] = hh[j - 1] - e_ins;
  }
  int max_sc = 0;
  for (int k = 0; k < 25; ++k)
    if (mat[k] > max_sc) max_sc = mat[k];
  int cap = static_cast<int>(
      static_cast<double>(qlen * max_sc + end_bonus - o_ins) / e_ins + 1.);
  if (cap < 1) cap = 1;
  if (w > cap) w = cap;
  cap = static_cast<int>(
      static_cast<double>(qlen * max_sc + end_bonus - o_del) / e_del + 1.);
  if (cap < 1) cap = 1;
  if (w > cap) w = cap;

  int32_t best = h0, gscore = -1;
  int best_i = -1, best_j = -1, best_ie = -1, max_off = 0;
  int beg = 0, end = qlen;
  for (int i = 0; i < tlen; ++i) {
    const int8_t* mrow = mat + nib(tpk, i) * 5;
    int32_t f = 0, row_max = 0;
    int row_mj = -1;
    int32_t h1 = h0 - (o_del + e_del * (i + 1));
    if (h1 < 0) h1 = 0;
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    int j = beg;
    for (; j < end; ++j) {
      // hh[j] = H(i-1, j-1), ee[j] = E(i, j), f = F(i, j), h1 = H(i, j-1)
      int32_t h = hh[j], e = ee[j];
      hh[j] = h1;
      h += mrow[qs[j]];
      h = h > e ? h : e;
      h = h > f ? h : f;
      h1 = h;
      row_mj = row_max > h ? row_mj : j;
      row_max = row_max > h ? row_max : h;
      int32_t t = h - oe_del;
      t = t > 0 ? t : 0;
      e -= e_del;
      e = e > t ? e : t;
      ee[j] = e;
      t = h - oe_ins;
      t = t > 0 ? t : 0;
      f -= e_ins;
      f = f > t ? f : t;
    }
    hh[end] = h1;
    ee[end] = 0;
    if (j == qlen && gscore <= h1) {
      best_ie = i;
      gscore = h1;
    }
    if (row_max == 0) break;
    if (row_max > best) {
      best = row_max;
      best_i = i;
      best_j = row_mj;
      const int off = row_mj > i ? row_mj - i : i - row_mj;
      if (off > max_off) max_off = off;
    } else if (zdrop > 0) {
      const int di = i - best_i, dj = row_mj - best_j;
      if (di > dj) {
        if (best - row_max - (di - dj) * e_del > zdrop) break;
      } else if (best - row_max - (dj - di) * e_ins > zdrop) {
        break;
      }
    }
    for (j = row_mj; j >= beg && hh[j] != 0; --j) {
    }
    beg = j + 1;
    for (j = row_mj + 2; j <= end && hh[j] != 0; ++j) {
    }
    end = j;
  }
  return Ext6{best, best_j + 1, best_i + 1, best_ie + 1, gscore, max_off};
}

struct ExtArgs {
  const int8_t *lq, *lt, *rq, *rt;  // packed rows [B, LQ/2] / [B, LT/2]
  int LT;
  const int32_t *llq, *llt, *rlq, *rlt;
  int o_del, e_del, o_ins, e_ins, w0, pc5, pc3, zdrop;
  const int32_t* sc_seed;
  const int32_t* s_qbeg;
  const int64_t* s_rbeg;
  const int32_t* l_query;
  const int32_t* s_len;
  int32_t *score, *truesc, *qb, *qe, *aw0, *aw1;
  int64_t *rb, *re;
};

// _extend_lr_core for seed b (bwamem_tpu/ops/ksw.py:531-608).
template <int LQ>
BM_HD void extend_lr_lane(const ExtArgs& a, const int8_t* mat, int b) {
  const int64_t qo = static_cast<int64_t>(b) * (LQ / 2);
  const int64_t to = static_cast<int64_t>(b) * (a.LT / 2);
  const int w0 = a.w0, w1 = a.w0 * 2;
  const int retry_hi = (w0 >> 1) + (w0 >> 2);
  const int sc_seed = a.sc_seed[b];

  const int llq = a.llq[b];
  const bool has_l = llq > 0;
  Ext6 l{0, 0, 0, 0, 0, 0};
  int aw0 = w0;
  if (has_l) {
    l = ksw_extend2<LQ>(a.lq + qo, llq, a.lt + to, a.llt[b], mat, a.o_del,
                        a.e_del, a.o_ins, a.e_ins, w0, a.pc5, a.zdrop,
                        sc_seed);
    if (l.best != -1 && l.max_off >= retry_hi) {
      l = ksw_extend2<LQ>(a.lq + qo, llq, a.lt + to, a.llt[b], mat,
                          a.o_del, a.e_del, a.o_ins, a.e_ins, w1, a.pc5,
                          a.zdrop, sc_seed);
      aw0 = w1;
    }
  }
  const int64_t s_rbeg = a.s_rbeg[b];
  const bool g_ok = l.gscore <= 0 || l.gscore <= l.best - a.pc5;
  int32_t score = has_l ? l.best : sc_seed;
  int32_t truesc = has_l ? (g_ok ? l.best : l.gscore) : sc_seed;
  const int32_t qb = (has_l && g_ok) ? a.s_qbeg[b] - l.qle : 0;
  const int64_t rb =
      has_l ? s_rbeg - (g_ok ? l.tle : l.gtle) : s_rbeg;

  const int rlq = a.rlq[b];
  const bool has_r = rlq > 0;
  const int32_t sc0 = score;
  Ext6 r{0, 0, 0, 0, 0, 0};
  int aw1 = w0;
  if (has_r) {
    r = ksw_extend2<LQ>(a.rq + qo, rlq, a.rt + to, a.rlt[b], mat, a.o_del,
                        a.e_del, a.o_ins, a.e_ins, w0, a.pc3, a.zdrop, sc0);
    if (r.best != sc0 && r.max_off >= retry_hi) {
      r = ksw_extend2<LQ>(a.rq + qo, rlq, a.rt + to, a.rlt[b], mat,
                          a.o_del, a.e_del, a.o_ins, a.e_ins, w1, a.pc3,
                          a.zdrop, sc0);
      aw1 = w1;
    }
  }
  const int32_t l_query = a.l_query[b];
  const int64_t s_len = a.s_len[b];
  const bool g_ok_r = r.gscore <= 0 || r.gscore <= r.best - a.pc3;
  int32_t qe = l_query;
  int64_t re = s_rbeg + s_len;
  if (has_r) {
    if (g_ok_r) qe = l_query - rlq + r.qle;
    re = s_rbeg + s_len + (g_ok_r ? r.tle : r.gtle);
    truesc += (g_ok_r ? r.best : r.gscore) - sc0;
    score = r.best;
  }
  a.score[b] = score;
  a.truesc[b] = truesc;
  a.qb[b] = qb;
  a.rb[b] = rb;
  a.qe[b] = qe;
  a.re[b] = re;
  a.aw0[b] = aw0;
  a.aw1[b] = aw1;
}

struct Ext2Args {
  const int8_t *q, *t;  // packed rows [B, LQ/2] / [B, LT/2]
  int LT;
  const int32_t *qlen, *tlen, *w, *end_bonus, *h0;
  int o_del, e_del, o_ins, e_ins, zdrop;
  int32_t *best, *qle, *tle, *gtle, *gscore, *max_off;
};

// ksw_extend2_batched for lane b (bwamem_tpu/ops/ksw.py:96).
template <int LQ>
BM_HD void extend2_lane(const Ext2Args& a, const int8_t* mat, int b) {
  const Ext6 r = ksw_extend2<LQ>(
      a.q + static_cast<int64_t>(b) * (LQ / 2), a.qlen[b],
      a.t + static_cast<int64_t>(b) * (a.LT / 2), a.tlen[b], mat, a.o_del,
      a.e_del, a.o_ins, a.e_ins, a.w[b], a.end_bonus[b], a.zdrop, a.h0[b]);
  a.best[b] = r.best;
  a.qle[b] = r.qle;
  a.tle[b] = r.tle;
  a.gtle[b] = r.gtle;
  a.gscore[b] = r.gscore;
  a.max_off[b] = r.max_off;
}

#ifdef __CUDACC__
template <int LQ>
__global__ void extend2_kernel(Ext2Args a, const int8_t* mat, int B) {
  __shared__ int8_t smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) extend2_lane<LQ>(a, smat, b);
}

template <int LQ>
__global__ void extend_lr_kernel(ExtArgs a, const int8_t* mat, int B) {
  __shared__ int8_t smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) extend_lr_lane<LQ>(a, smat, b);
}
#endif

}  // namespace

#ifdef __CUDACC__
// mat: device int8[25].  Returns cudaGetLastError(); 1001 for an LQ
// without an instantiation.
extern "C" int bm_extend_lr(
    int LQ, int LT, int B, const void* lq, const void* lt, const void* llq,
    const void* llt, const void* rq, const void* rt, const void* rlq,
    const void* rlt, const void* mat, int o_del, int e_del, int o_ins,
    int e_ins, int w0, int pc5, int pc3, int zdrop, const void* sc_seed,
    const void* s_qbeg, const void* s_rbeg, const void* l_query,
    const void* s_len, void* score, void* truesc, void* qb, void* rb,
    void* qe, void* re, void* aw0, void* aw1, void* stream) {
  ExtArgs a;
  a.lq = static_cast<const int8_t*>(lq);
  a.lt = static_cast<const int8_t*>(lt);
  a.rq = static_cast<const int8_t*>(rq);
  a.rt = static_cast<const int8_t*>(rt);
  a.LT = LT;
  a.llq = static_cast<const int32_t*>(llq);
  a.llt = static_cast<const int32_t*>(llt);
  a.rlq = static_cast<const int32_t*>(rlq);
  a.rlt = static_cast<const int32_t*>(rlt);
  a.o_del = o_del;
  a.e_del = e_del;
  a.o_ins = o_ins;
  a.e_ins = e_ins;
  a.w0 = w0;
  a.pc5 = pc5;
  a.pc3 = pc3;
  a.zdrop = zdrop;
  a.sc_seed = static_cast<const int32_t*>(sc_seed);
  a.s_qbeg = static_cast<const int32_t*>(s_qbeg);
  a.s_rbeg = static_cast<const int64_t*>(s_rbeg);
  a.l_query = static_cast<const int32_t*>(l_query);
  a.s_len = static_cast<const int32_t*>(s_len);
  a.score = static_cast<int32_t*>(score);
  a.truesc = static_cast<int32_t*>(truesc);
  a.qb = static_cast<int32_t*>(qb);
  a.rb = static_cast<int64_t*>(rb);
  a.qe = static_cast<int32_t*>(qe);
  a.re = static_cast<int64_t*>(re);
  a.aw0 = static_cast<int32_t*>(aw0);
  a.aw1 = static_cast<int32_t*>(aw1);
  const int threads = 128;
  const int grid = (B + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* m = static_cast<const int8_t*>(mat);
  if (LQ != 128 && LQ != 256 && LQ != 512) return 1001;
  if (B > 0) {
    if (LQ == 128)
      extend_lr_kernel<128><<<grid, threads, 0, st>>>(a, m, B);
    else if (LQ == 256)
      extend_lr_kernel<256><<<grid, threads, 0, st>>>(a, m, B);
    else
      extend_lr_kernel<512><<<grid, threads, 0, st>>>(a, m, B);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif

#ifdef __CUDACC__
// mat: device int8[25].  Returns cudaGetLastError(); 1001 for an LQ
// without an instantiation.
extern "C" int bm_extend2(int LQ, int LT, int B, const void* q,
                          const void* t, const void* qlen, const void* tlen,
                          const void* mat, int o_del, int e_del, int o_ins,
                          int e_ins, const void* w, const void* end_bonus,
                          int zdrop, const void* h0, void* best, void* qle,
                          void* tle, void* gtle, void* gscore, void* max_off,
                          void* stream) {
  Ext2Args a;
  a.q = static_cast<const int8_t*>(q);
  a.t = static_cast<const int8_t*>(t);
  a.LT = LT;
  a.qlen = static_cast<const int32_t*>(qlen);
  a.tlen = static_cast<const int32_t*>(tlen);
  a.w = static_cast<const int32_t*>(w);
  a.end_bonus = static_cast<const int32_t*>(end_bonus);
  a.h0 = static_cast<const int32_t*>(h0);
  a.o_del = o_del;
  a.e_del = e_del;
  a.o_ins = o_ins;
  a.e_ins = e_ins;
  a.zdrop = zdrop;
  a.best = static_cast<int32_t*>(best);
  a.qle = static_cast<int32_t*>(qle);
  a.tle = static_cast<int32_t*>(tle);
  a.gtle = static_cast<int32_t*>(gtle);
  a.gscore = static_cast<int32_t*>(gscore);
  a.max_off = static_cast<int32_t*>(max_off);
  if (LQ != 128 && LQ != 256 && LQ != 512) return 1001;
  const int threads = 128;
  const int grid = (B + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* m = static_cast<const int8_t*>(mat);
  if (B > 0) {
    if (LQ == 128)
      extend2_kernel<128><<<grid, threads, 0, st>>>(a, m, B);
    else if (LQ == 256)
      extend2_kernel<256><<<grid, threads, 0, st>>>(a, m, B);
    else
      extend2_kernel<512><<<grid, threads, 0, st>>>(a, m, B);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
