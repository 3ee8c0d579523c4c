// Local Smith-Waterman with ksw_u8 / ksw_i16 semantics, one warp per
// lane of the wave.
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
// What bounds it on an H100: the rows of one lane are dependent and a
// row's cells are chained along the query by F, so a lane is a chain of
// up to tlen rows of vlen cells.  The first version ran a lane on one
// thread, serial along each row, with H, E and Hmax (1.5 KB) and the
// query in local memory and each row's maximum stored alone to device
// memory; 512 lanes filled 4 of the 132 SMs.  Design: one warp per lane,
// one warp a block.  Lane l holds, in chunk k, the S = kS consecutive
// columns j = 32*S*k + S*l + s in registers: H of the row above, E,
// Hmax, and the lane's scores against each target base (0 on a pad
// column).  F is a prefix maximum, as pallas_align.py _cummax_sublanes:
// F(j) = max(0, max over k < j of g(k) - oe_ins - (j-1-k)*e_ins) with g =
// max(clip(H(i-1, j-1) + score), E), which does not depend on the row's
// H, so a serial maximum over the lane's columns and one shuffle scan
// across the lanes give every column its F (equal to the serial loop).
// Columns at or past vlen are never computed and enter no maximum.  The
// row maximum is one warp reduction, and every break follows it, so it
// is warp-uniform; lane i mod 32 keeps row i's maximum and the warp
// stores 32 rows at once.  qe is a minimum over the lanes' columns that
// reach max(Hmax).  Nothing in local memory.  What bounds it now: a row
// costs the warp one shuffle, one dependent shuffle scan and one
// reduction, so a lane is tlen of those.
//
// The lanes are written against a team (team.cuh): on the host, g++
// builds the same source with the 32 lanes as arrays (bm_align2_host).
#include <cstdint>

#include "team.cuh"

namespace {

constexpr int32_t kNeg = -0x40000000;
constexpr int kS = 4;   // consecutive columns a lane holds in a chunk

// the lane's scores against target base tb (one packed word per base)
BM_HD uint32_t pick(const uint32_t (&prof)[5], int tb) {
  uint32_t w = prof[0];
#pragma unroll
  for (int t = 1; t < 5; ++t) w = tb == t ? prof[t] : w;
  return w;
}

BM_HD int32_t byte_at(uint32_t w, int s) {
  return static_cast<int8_t>(w >> (8 * s));
}

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

// ksw_align_batched for lane b (bwamem_tpu/ops/ksw_align.py:70-139) by
// the 32 lanes of tm; SIZE 1 = ksw_u8, 2 = ksw_i16.
template <int SIZE, int LQV, int S, class TM>
BM_HD void align_lane(const TM& tm, const AlnArgs& a, const int8_t* mat,
                      int b) {
  constexpr int NL = TM::NL, CW = 32 * S, K = LQV / CW;
  static_assert(TM::kG == 32 && K * CW == LQV, "one warp, whole chunks");
  const int LT = a.LT;
  // lengths inside the bucket: a longer one from a caller that skipped
  // the host check reads and writes nothing past the lane's rows
  const int qlen = bm_min(bm_max(a.qlen[b], 0), LQV);
  const int tlen = bm_min(bm_max(a.tlen[b], 0), LT);
  const int endsc = a.endsc[b];
  const int p = SIZE == 1 ? 16 : 8;
  const int vlen = (qlen + p - 1) / p * p;
  const int sat = 255 - a.shift;
  const int e_del = a.e_del, e_ins = a.e_ins;
  const int oe_del = a.o_del + e_del, oe_ins = a.o_ins + e_ins;
  const int8_t* qrow = a.q + static_cast<int64_t>(b) * LQV;
  const int8_t* trow = a.t + static_cast<int64_t>(b) * LT;
  int32_t* row_max = a.row_max + static_cast<int64_t>(b) * LT;

  // the lane's columns: H (of the row above), E, Hmax, and prof[t] the
  // scores against target base t (0 on a pad column j >= qlen)
  int32_t H[NL][K][S], E[NL][K][S], Hmax[NL][K][S];
  uint32_t prof[NL][K][5];
  for (int l = 0; l < NL; ++l)
    for (int k = 0; k < K; ++k) {
      for (int t = 0; t < 5; ++t) prof[l][k][t] = 0;
      for (int s = 0; s < S; ++s) {
        const int j = CW * k + S * tm.lane(l) + s;
        if (j < qlen)
          for (int t = 0; t < 5; ++t)
            prof[l][k][t] |= static_cast<uint32_t>(
                static_cast<uint8_t>(mat[t * 5 + qrow[j]])) << (8 * s);
        H[l][k][s] = E[l][k][s] = Hmax[l][k][s] = 0;
      }
    }
  int32_t gmax = 0;
  int te = -1, last = -1;
  bool saturated = false;
  int32_t rmw[NL];   // lane r keeps the maximum of row 32n + r
  for (int l = 0; l < NL; ++l) rmw[l] = 0;
  int i = 0;
  int tb = tlen > 0 ? trow[0] : 0;
  for (; i < tlen; ++i) {
    const int tb_next = i + 1 < tlen ? trow[i + 1] : 0;
    int32_t pre = kNeg;   // max of g(j) + j*e_ins over the chunks done
    int32_t carry[NL], im[NL];
    for (int l = 0; l < NL; ++l) carry[l] = im[l] = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // H(i-1, j-1) of a lane's first column is the lane below's last;
      // lane 0 takes lane 31's of the chunk before (0 at column 0)
      int32_t hl[NL], rot[NL];
      int src[NL];
      for (int l = 0; l < NL; ++l) {
        hl[l] = H[l][k][S - 1];
        src[l] = (tm.lane(l) + 31) & 31;
      }
      tm.shfl(hl, src, rot);
      // g (in the serial loop's order: the diagonal plus the score,
      // clipped for u8, then the maximum with E), and the maxima of
      // g(k) + k*e_ins over the columns below j: the lane's own (lx), the
      // lanes below (ex), the chunks before (pre)
      int32_t g[NL][S], lx[NL][S], agg[NL], ex[NL];
      for (int l = 0; l < NL; ++l) {
        const int32_t left = tm.lane(l) ? rot[l] : carry[l];
        carry[l] = rot[l];
        const uint32_t sw = pick(prof[l][k], tb);
        int32_t run = kNeg;
        for (int s = 0; s < S; ++s) {
          const int j = CW * k + S * tm.lane(l) + s;
          int32_t gv = (s ? H[l][k][s - 1] : left) + byte_at(sw, s);
          if (SIZE == 1) gv = gv < 0 ? 0 : (gv > sat ? sat : gv);
          gv = bm_max(gv, E[l][k][s]);
          g[l][s] = gv;
          lx[l][s] = run;
          if (j < vlen) run = bm_max(run, gv + j * e_ins);
        }
        agg[l] = run;
      }
      const int32_t top = K > 1 ? tm.max_all(agg) : kNeg;
      tm.scan_max_excl(agg, kNeg, ex);
      for (int l = 0; l < NL; ++l)
        for (int s = 0; s < S; ++s) {
          const int j = CW * k + S * tm.lane(l) + s;
          if (j >= vlen) continue;
          const int32_t f = bm_max(
              bm_max(pre, bm_max(ex[l], lx[l][s])) - oe_ins
                  - (j - 1) * e_ins, 0);
          const int32_t h = bm_max(g[l][s], f);
          H[l][k][s] = h;
          im[l] = bm_max(im[l], h);
          E[l][k][s] = bm_max(E[l][k][s] - e_del, bm_max(h - oe_del, 0));
        }
      pre = bm_max(pre, top);
    }
    const int32_t imax = tm.max_all(im);
    for (int l = 0; l < NL; ++l)
      if (tm.lane(l) == (i & 31)) rmw[l] = imax;
    if ((i & 31) == 31) {   // 32 rows' maxima, one store
      for (int l = 0; l < NL; ++l) {
        row_max[(i & ~31) + tm.lane(l)] = rmw[l];
        rmw[l] = 0;
      }
    }
    last = i;
    tb = tb_next;
    if (imax > gmax) {
      gmax = imax;
      te = i;
      for (int l = 0; l < NL; ++l)
        for (int k = 0; k < K; ++k)
          for (int s = 0; s < S; ++s) Hmax[l][k][s] = H[l][k][s];
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
  // the rows of the last window run, then 0 for the rows not run
  for (int r0 = i & ~31; r0 < LT; r0 += 32)
    for (int l = 0; l < NL; ++l) {
      if (r0 + tm.lane(l) < LT) row_max[r0 + tm.lane(l)] = rmw[l];
      rmw[l] = 0;
    }
  // qe: the smallest column reaching max(Hmax); the columns past vlen
  // hold 0, so with no positive cell it is column 0
  int32_t mloc[NL], cand[NL];
  for (int l = 0; l < NL; ++l) {
    mloc[l] = 0;
    for (int k = 0; k < K; ++k)
      for (int s = 0; s < S; ++s) mloc[l] = bm_max(mloc[l], Hmax[l][k][s]);
  }
  const int32_t mx = tm.max_all(mloc);
  for (int l = 0; l < NL; ++l) {
    cand[l] = LQV;
    for (int k = K - 1; k >= 0; --k)
      for (int s = S - 1; s >= 0; --s)
        if (Hmax[l][k][s] == mx) cand[l] = CW * k + S * tm.lane(l) + s;
  }
  const int qe = tm.min_all(cand);
  if (tm.lane(0) != 0) return;
  a.gmax[b] = gmax;
  a.te[b] = te;
  a.qe[b] = qe;
  a.saturated[b] = saturated ? 1 : 0;
  a.last[b] = last;
}

AlnArgs aln_args(int LT, const void* q, const void* t, const void* qlen,
                 const void* tlen, const void* endsc, int o_del, int e_del,
                 int o_ins, int e_ins, int shift, void* gmax, void* te,
                 void* qe, void* saturated, void* row_max, void* last) {
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
  return a;
}

#ifdef __CUDACC__
template <int SIZE, int LQV>
__global__ void __launch_bounds__(32)
    align_kernel(AlnArgs a, const int8_t* mat) {
  align_lane<SIZE, LQV, kS>(DevTeam<32>(), a, mat, blockIdx.x);
}
#endif

}  // namespace

#ifdef __CUDACC__
// mat: device int8[25].  One warp per lane.  Returns cudaGetLastError();
// 1001 for an (LQV, size) without an instantiation.
extern "C" int bm_align2(int size, int LQV, int LT, int B, const void* q,
                         const void* t, const void* qlen, const void* tlen,
                         const void* endsc, const void* mat, int o_del,
                         int e_del, int o_ins, int e_ins, int shift,
                         void* gmax, void* te, void* qe, void* saturated,
                         void* row_max, void* last, void* stream) {
  const AlnArgs a = aln_args(LT, q, t, qlen, tlen, endsc, o_del, e_del,
                             o_ins, e_ins, shift, gmax, te, qe, saturated,
                             row_max, last);
  if (LQV != 128 || (size != 1 && size != 2)) return 1001;
  const auto* m = static_cast<const int8_t*>(mat);
  auto s = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    if (size == 1)
      align_kernel<1, 128><<<B, 32, 0, s>>>(a, m);
    else
      align_kernel<2, 128><<<B, 32, 0, s>>>(a, m);
  }
  return static_cast<int>(cudaGetLastError());
}
#else
// The host emulation (g++): the same arguments on host memory, without
// the stream.  Returns 0; 1001 for an (LQV, size) without an
// instantiation.
extern "C" int bm_align2_host(int size, int LQV, int LT, int B,
                              const void* q, const void* t, const void* qlen,
                              const void* tlen, const void* endsc,
                              const void* mat, int o_del, int e_del,
                              int o_ins, int e_ins, int shift, void* gmax,
                              void* te, void* qe, void* saturated,
                              void* row_max, void* last) {
  const AlnArgs a = aln_args(LT, q, t, qlen, tlen, endsc, o_del, e_del,
                             o_ins, e_ins, shift, gmax, te, qe, saturated,
                             row_max, last);
  if (LQV != 128 || (size != 1 && size != 2)) return 1001;
  const auto* m = static_cast<const int8_t*>(mat);
  const HostTeam<32> tm;
  for (int b = 0; b < B; ++b) {
    if (size == 1)
      align_lane<1, 128, kS>(tm, a, m, b);
    else
      align_lane<2, 128, kS>(tm, a, m, b);
  }
  return 0;
}
#endif
