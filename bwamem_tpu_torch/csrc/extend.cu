// Banded extension, one warp per seed: the fused left+right extension
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
// What bounds it on an H100: the rows of one extension are dependent, and
// a row's cells are chained by F (the gap along the query), so a seed is
// a chain of rows whose length only the data set.  The first version ran
// one seed on one thread, serial along each row, with the band state
// (hh/ee[LQ+2], 4.6 KB at LQ=512) in local memory, out of L1 at the long
// buckets.  Design: one warp per seed.  The row's columns are split into
// K = LQ/32 chunks of 32 (4, 8 or 16), lane l holding column 32k + l of
// chunk k in registers: H of the row above (hh), E (ee) and the query
// base.  A row runs only the chunks its band [beg, end] touches, so a
// band narrowed to a few columns costs one chunk, not LQ/32 (strips of
// consecutive columns per lane would keep every lane's loop as long as
// the widest strip).  F is a prefix maximum, the Hopper counterpart of
// pallas_extend.py _cummax_sublanes and of the plain version's cummax:
// F(j) = max(0, max_{k<j} g(k) - oe_ins - (j-1-k)*e_ins) with g =
// max(H(i-1,j-1) + score, E), so within a chunk a 5-step shuffle scan of
// g(k) + k*e_ins gives each lane its carry-in, and the chunks before hand
// theirs on as one warp-uniform maximum (integer maxima: equal to the
// serial loop).  One shuffle hands H(i, j-1) to the lane above; the row
// maximum (the last j of it), the gscore column, z-drop and the band
// narrowing are warp collectives, so every break is warp-uniform.  The
// target base comes by one shuffle from a 32-byte window the lanes load
// every 64 rows, the 5x5 score matrix from shared memory.  No band state
// goes to local memory (ptxas: no stack, no spill at any LQ).  What bounds
// it now: each chunk of a row costs the warp 8 dependent shuffles and
// reductions and the row 6 more, so the time follows the rows times the
// band's chunks, and
// a seed whose band spans all of LQ=512 still runs 16 chunks a row.  A
// block is one warp (measured faster than four a block); lane 0 writes a
// seed's outputs.
//
// The lanes are written against a team (team.cuh): on the host, g++
// builds the same source with the 32 lanes as arrays
// (bm_extend_lr_host, bm_extend2_host), which also count the DP cells
// each seed visits.
#include <cstdint>

#include "team.cuh"

namespace {

constexpr int kSeedsPerBlock = 1;   // warps per block
constexpr int32_t kNeg = -0x40000000;

struct Ext6 {
  int32_t best, qle, tle, gtle, gscore, max_off;
};

// ksw_extend2 over a 4-bit-packed query/target pair, by the 32 lanes of
// tm.  Lane l holds the columns j = 32k + l (chunk k in [0, K)); a row
// runs the chunks its band [beg, end] touches.  Adds the cells of the
// rows' bands to *cells when it is not null.
template <int LQ, class TM>
BM_HD Ext6 ksw_extend2(const TM& tm, const int8_t* qpk, int qlen,
                       const int8_t* tpk, int tlen, const int8_t* mat,
                       int o_del, int e_del, int o_ins, int e_ins, int w,
                       int end_bonus, int zdrop, int h0, int64_t* cells) {
  constexpr int K = LQ / 32, NL = TM::NL, QW = (K + 7) / 8;
  static_assert(TM::kG == 32, "one warp a seed");
  if (h0 < 0) h0 = 0;
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  // the lane's columns: query bases (4 bits each), hh[j] = H(i-1, j-1),
  // ee[j] = E(i, j); hh[LQ] past the last chunk is the uniform h_lq
  uint32_t qw[NL][QW];
  int32_t hh[NL][K], ee[NL][K];
  for (int l = 0; l < NL; ++l) {
#pragma unroll
    for (int v = 0; v < QW; ++v) qw[l][v] = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = 32 * k + tm.lane(l);
      if (j < qlen)  // columns past the query score as base 0, unused
        qw[l][k >> 3] |= static_cast<uint32_t>((qpk[j >> 1] >> ((j & 1) * 4))
                                               & 15) << ((k & 7) * 4);
      hh[l][k] = j == 0 ? h0
                        : (j <= qlen ? bm_max(h0 - oe_ins - (j - 1) * e_ins, 0)
                                     : 0);
      ee[l][k] = 0;
    }
  }
  int32_t h_lq =
      qlen == LQ ? bm_max(h0 - oe_ins - (LQ - 1) * e_ins, 0) : 0;
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
  int32_t tbyte[NL];
  for (int i = 0; i < tlen; ++i) {
    if ((i & 63) == 0)  // the next 64 target bases, a byte per lane
      for (int l = 0; l < NL; ++l) {
        const int at = (i >> 1) + tm.lane(l);
        tbyte[l] = at < ((tlen + 1) >> 1) ? static_cast<uint8_t>(tpk[at]) : 0;
      }
    const int tb = (tm.bcast(tbyte, (i & 63) >> 1) >> ((i & 1) * 4)) & 15;
    const int8_t* mrow = mat + tb * 5;
    int32_t h1 = h0 - (o_del + e_del * (i + 1));
    if (h1 < 0) h1 = 0;
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    if (beg >= end) {  // an empty band: the serial loop ends at j = beg
      if (beg == qlen && gscore <= h1) {
        best_ie = i;
        gscore = h1;
      }
      break;
    }
    if (cells) *cells += end - beg;
    // the chunks of columns [beg, end]: kb..kc (column LQ is h_lq)
    const int kb = beg >> 5, kc = (end >> 5) < K ? end >> 5 : K - 1;
    int32_t pre = kNeg;  // max of g + j*e_ins over the band's done chunks
    int32_t rm[NL], rj[NL], hend[NL], left0[NL];
    for (int l = 0; l < NL; ++l) {
      rm[l] = -1;
      rj[l] = -1;
      hend[l] = 0;
      left0[l] = 0;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kb || k > kc) continue;  // uniform
      // g = max(H(i-1, j-1) + score, E(i, j)); F(j) from the maximum of
      // g + j*e_ins over the band's columns below j: the chunks before
      // (pre) and the lanes below in this chunk (a shuffle scan)
      int32_t g[NL], a[NL], ex[NL], h[NL], rot[NL];
      int src[NL];
      for (int l = 0; l < NL; ++l) {
        const int j = 32 * k + tm.lane(l);
        const int qb = (qw[l][k >> 3] >> ((k & 7) * 4)) & 15;
        g[l] = bm_max(hh[l][k] + mrow[qb], ee[l][k]);
        a[l] = j >= beg && j < end ? g[l] + j * e_ins : kNeg;
        src[l] = (tm.lane(l) + 31) & 31;
      }
      const int32_t top = tm.max_all(a);
      tm.scan_max_excl(a, kNeg, ex);
      for (int l = 0; l < NL; ++l) {
        const int j = 32 * k + tm.lane(l);
        const bool in = j >= beg && j < end;
        const int32_t f =
            bm_max(bm_max(pre, ex[l]) - oe_ins - (j - 1) * e_ins, 0);
        h[l] = in ? bm_max(g[l], f) : 0;
        if (in) {
          ee[l][k] = bm_max(ee[l][k] - e_del, bm_max(h[l] - oe_del, 0));
          if (h[l] >= rm[l]) {  // the row maximum, its last j
            rm[l] = h[l];
            rj[l] = j;
          }
        }
        if (j == end - 1) hend[l] = h[l];
      }
      pre = bm_max(pre, top);
      // the next row's diagonal: hh[j] = H(i, j-1) on (beg, end], hh[beg]
      // = h1, ee[end] = 0; H(i, j-1) is the lane below's, lane 0 takes
      // lane 31's of the chunk before
      tm.shfl(h, src, rot);
      for (int l = 0; l < NL; ++l) {
        const int j = 32 * k + tm.lane(l);
        const int32_t left = tm.lane(l) ? rot[l] : left0[l];
        if (j == beg)
          hh[l][k] = h1;
        else if (j > beg && j <= end)
          hh[l][k] = left;
        if (j == end) ee[l][k] = 0;
        left0[l] = rot[l];
      }
      if (k == K - 1 && end == LQ) h_lq = tm.bcast(h, 31);
    }
    const int32_t row_max = tm.max_all(rm);
    int32_t cj[NL];
    for (int l = 0; l < NL; ++l) cj[l] = rm[l] == row_max ? rj[l] : -1;
    const int row_mj = tm.max_all(cj);
    if (end == qlen) {
      const int32_t h_end = tm.max_all(hend);  // H(i, end-1); others 0
      if (gscore <= h_end) {
        best_ie = i;
        gscore = h_end;
      }
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
    // band narrowing over the new hh: beg past the last zero in [beg,
    // row_mj], end at the first zero in [row_mj + 2, end] (else end + 1)
    int32_t lo[NL], hi[NL];
    for (int l = 0; l < NL; ++l) {
      lo[l] = -1;
      hi[l] = LQ + 1;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kb || k > kc) continue;  // uniform
      for (int l = 0; l < NL; ++l) {
        const int j = 32 * k + tm.lane(l);
        if (hh[l][k] == 0) {
          if (j >= beg && j <= row_mj) lo[l] = j;
          if (j >= row_mj + 2 && j <= end && hi[l] > LQ) hi[l] = j;
        }
      }
    }
    const int32_t lo_all = tm.max_all(lo), hi_all = tm.min_all(hi);
    if (lo_all >= 0) beg = lo_all + 1;
    if (hi_all <= LQ)
      end = hi_all;
    else if (end == LQ && row_mj + 2 <= LQ && h_lq == 0)
      end = LQ;
    else
      end = end + 1;
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

// _extend_lr_core for seed b (bwamem_tpu/ops/ksw.py:531-608), by the
// lanes of tm: the left side at w and its retry at 2w, the left
// decision, the right side and its retry, the right decision.  One
// inlined copy of the DP runs the four attempts; lane 0 writes the
// outputs.
template <int LQ, class TM>
BM_HD void extend_lr_lane(const TM& tm, const ExtArgs& a, const int8_t* mat,
                          int b, int64_t* cells) {
  const int64_t qo = static_cast<int64_t>(b) * (LQ / 2);
  const int64_t to = static_cast<int64_t>(b) * (a.LT / 2);
  const int w0 = a.w0, w1 = a.w0 * 2;
  const int retry_hi = (w0 >> 1) + (w0 >> 2);
  const int32_t sc_seed = a.sc_seed[b];
  const int64_t s_rbeg = a.s_rbeg[b];
  int32_t score = sc_seed, truesc = sc_seed, qb = 0, qe = a.l_query[b];
  int64_t rb = s_rbeg, re = s_rbeg + a.s_len[b];
  int aw0 = w0, aw1 = w0;
#pragma unroll 1
  for (int side = 0; side < 2; ++side) {
    // lengths inside the bucket: a longer one from a caller that skipped
    // the host check reads nothing past the lane's rows
    const int qlen = bm_min(side ? a.rlq[b] : a.llq[b], LQ);
    if (qlen <= 0) continue;
    const int8_t* qp = (side ? a.rq : a.lq) + qo;
    const int8_t* tp = (side ? a.rt : a.lt) + to;
    const int tlen = bm_min(side ? a.rlt[b] : a.llt[b], a.LT);
    const int bonus = side ? a.pc3 : a.pc5;
    const int32_t h0 = score;   // the seed's score, then the left's
    Ext6 r;
#pragma unroll 1
    for (int w = w0;; w = w1) {
      r = ksw_extend2<LQ>(tm, qp, qlen, tp, tlen, mat, a.o_del, a.e_del,
                          a.o_ins, a.e_ins, w, bonus, a.zdrop, h0, cells);
      // retry at 2w when the band was close (bwamem.c:1136-1138)
      if (w == w1 || r.best == (side ? h0 : -1) || r.max_off < retry_hi)
        break;
      if (side)
        aw1 = w1;
      else
        aw0 = w1;
    }
    const bool g_ok = r.gscore <= 0 || r.gscore <= r.best - bonus;
    if (side == 0) {  // the left decision (bwamem.c:1140-1148)
      score = r.best;
      truesc = g_ok ? r.best : r.gscore;
      qb = g_ok ? a.s_qbeg[b] - r.qle : 0;
      rb = s_rbeg - (g_ok ? r.tle : r.gtle);
    } else {          // the right decision (bwamem.c:1168-1176)
      if (g_ok) qe = a.l_query[b] - qlen + r.qle;
      re += g_ok ? r.tle : r.gtle;
      truesc += (g_ok ? r.best : r.gscore) - h0;
      score = r.best;
    }
  }
  if (tm.lane(0) != 0) return;
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

// ksw_extend2_batched for lane b (bwamem_tpu/ops/ksw.py:96), by the lanes
// of tm; lane 0 writes the outputs.
template <int LQ, class TM>
BM_HD void extend2_lane(const TM& tm, const Ext2Args& a, const int8_t* mat,
                        int b, int64_t* cells) {
  const Ext6 r = ksw_extend2<LQ>(
      tm, a.q + static_cast<int64_t>(b) * (LQ / 2), bm_min(a.qlen[b], LQ),
      a.t + static_cast<int64_t>(b) * (a.LT / 2), bm_min(a.tlen[b], a.LT),
      mat, a.o_del,
      a.e_del, a.o_ins, a.e_ins, a.w[b], a.end_bonus[b], a.zdrop, a.h0[b],
      cells);
  if (tm.lane(0) != 0) return;
  a.best[b] = r.best;
  a.qle[b] = r.qle;
  a.tle[b] = r.tle;
  a.gtle[b] = r.gtle;
  a.gscore[b] = r.gscore;
  a.max_off[b] = r.max_off;
}

ExtArgs ext_args(int LT, const void* lq, const void* lt, const void* llq,
                 const void* llt, const void* rq, const void* rt,
                 const void* rlq, const void* rlt, int o_del, int e_del,
                 int o_ins, int e_ins, int w0, int pc5, int pc3, int zdrop,
                 const void* sc_seed, const void* s_qbeg, const void* s_rbeg,
                 const void* l_query, const void* s_len, void* score,
                 void* truesc, void* qb, void* rb, void* qe, void* re,
                 void* aw0, void* aw1) {
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
  return a;
}

Ext2Args ext2_args(int LT, const void* q, const void* t, const void* qlen,
                   const void* tlen, int o_del, int e_del, int o_ins,
                   int e_ins, const void* w, const void* end_bonus, int zdrop,
                   const void* h0, void* best, void* qle, void* tle,
                   void* gtle, void* gscore, void* max_off) {
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
  return a;
}

#ifdef __CUDACC__
template <int LQ>
__global__ void __launch_bounds__(32 * kSeedsPerBlock)
    extend2_kernel(Ext2Args a, const int8_t* mat, int B) {
  __shared__ int8_t smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * kSeedsPerBlock + (threadIdx.x >> 5);
  if (b < B) extend2_lane<LQ>(DevTeam<32>(), a, smat, b, nullptr);
}

template <int LQ>
__global__ void __launch_bounds__(32 * kSeedsPerBlock)
    extend_lr_kernel(ExtArgs a, const int8_t* mat, int B) {
  __shared__ int8_t smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * kSeedsPerBlock + (threadIdx.x >> 5);
  if (b < B) extend_lr_lane<LQ>(DevTeam<32>(), a, smat, b, nullptr);
}
#endif

}  // namespace

#ifdef __CUDACC__
// mat: device int8[25].  One warp per seed.  Returns cudaGetLastError();
// 1001 for an LQ without an instantiation.
extern "C" int bm_extend_lr(
    int LQ, int LT, int B, const void* lq, const void* lt, const void* llq,
    const void* llt, const void* rq, const void* rt, const void* rlq,
    const void* rlt, const void* mat, int o_del, int e_del, int o_ins,
    int e_ins, int w0, int pc5, int pc3, int zdrop, const void* sc_seed,
    const void* s_qbeg, const void* s_rbeg, const void* l_query,
    const void* s_len, void* score, void* truesc, void* qb, void* rb,
    void* qe, void* re, void* aw0, void* aw1, void* stream) {
  const ExtArgs a = ext_args(LT, lq, lt, llq, llt, rq, rt, rlq, rlt, o_del,
                             e_del, o_ins, e_ins, w0, pc5, pc3, zdrop,
                             sc_seed, s_qbeg, s_rbeg, l_query, s_len, score,
                             truesc, qb, rb, qe, re, aw0, aw1);
  const int grid = (B + kSeedsPerBlock - 1) / kSeedsPerBlock;
  const int threads = 32 * kSeedsPerBlock;
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

// mat: device int8[25].  One warp per lane.  Returns cudaGetLastError();
// 1001 for an LQ without an instantiation.
extern "C" int bm_extend2(int LQ, int LT, int B, const void* q,
                          const void* t, const void* qlen, const void* tlen,
                          const void* mat, int o_del, int e_del, int o_ins,
                          int e_ins, const void* w, const void* end_bonus,
                          int zdrop, const void* h0, void* best, void* qle,
                          void* tle, void* gtle, void* gscore, void* max_off,
                          void* stream) {
  const Ext2Args a = ext2_args(LT, q, t, qlen, tlen, o_del, e_del, o_ins,
                               e_ins, w, end_bonus, zdrop, h0, best, qle,
                               tle, gtle, gscore, max_off);
  if (LQ != 128 && LQ != 256 && LQ != 512) return 1001;
  const int grid = (B + kSeedsPerBlock - 1) / kSeedsPerBlock;
  const int threads = 32 * kSeedsPerBlock;
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
#else
// The host emulation (g++): the same arguments on host memory, the last
// one int64[B] of DP cells visited per seed (or null) in place of the
// stream.  Returns 0; 1001 for an LQ without an instantiation.
extern "C" int bm_extend_lr_host(
    int LQ, int LT, int B, const void* lq, const void* lt, const void* llq,
    const void* llt, const void* rq, const void* rt, const void* rlq,
    const void* rlt, const void* mat, int o_del, int e_del, int o_ins,
    int e_ins, int w0, int pc5, int pc3, int zdrop, const void* sc_seed,
    const void* s_qbeg, const void* s_rbeg, const void* l_query,
    const void* s_len, void* score, void* truesc, void* qb, void* rb,
    void* qe, void* re, void* aw0, void* aw1, void* cells) {
  const ExtArgs a = ext_args(LT, lq, lt, llq, llt, rq, rt, rlq, rlt, o_del,
                             e_del, o_ins, e_ins, w0, pc5, pc3, zdrop,
                             sc_seed, s_qbeg, s_rbeg, l_query, s_len, score,
                             truesc, qb, rb, qe, re, aw0, aw1);
  const int8_t* m = static_cast<const int8_t*>(mat);
  int64_t* c = static_cast<int64_t*>(cells);
  const HostTeam<32> tm;
  for (int b = 0; b < B; ++b) {
    int64_t* cb = c ? c + b : nullptr;
    if (cb) *cb = 0;
    if (LQ == 128)
      extend_lr_lane<128>(tm, a, m, b, cb);
    else if (LQ == 256)
      extend_lr_lane<256>(tm, a, m, b, cb);
    else if (LQ == 512)
      extend_lr_lane<512>(tm, a, m, b, cb);
    else
      return 1001;
  }
  return 0;
}

extern "C" int bm_extend2_host(int LQ, int LT, int B, const void* q,
                               const void* t, const void* qlen,
                               const void* tlen, const void* mat, int o_del,
                               int e_del, int o_ins, int e_ins, const void* w,
                               const void* end_bonus, int zdrop,
                               const void* h0, void* best, void* qle,
                               void* tle, void* gtle, void* gscore,
                               void* max_off, void* cells) {
  const Ext2Args a = ext2_args(LT, q, t, qlen, tlen, o_del, e_del, o_ins,
                               e_ins, w, end_bonus, zdrop, h0, best, qle,
                               tle, gtle, gscore, max_off);
  const int8_t* m = static_cast<const int8_t*>(mat);
  int64_t* c = static_cast<int64_t*>(cells);
  const HostTeam<32> tm;
  for (int b = 0; b < B; ++b) {
    int64_t* cb = c ? c + b : nullptr;
    if (cb) *cb = 0;
    if (LQ == 128)
      extend2_lane<128>(tm, a, m, b, cb);
    else if (LQ == 256)
      extend2_lane<256>(tm, a, m, b, cb);
    else if (LQ == 512)
      extend2_lane<512>(tm, a, m, b, cb);
    else
      return 1001;
  }
  return 0;
}
#endif
