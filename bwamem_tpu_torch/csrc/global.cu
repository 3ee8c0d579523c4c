// Banded global alignment with traceback, one warp per lane of the wave.
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
// What bounds it on an H100: the rows of one alignment are dependent, a
// row's cells are chained along the query by F (the gap in the query),
// and the traceback is a chain of up to tlen + qlen dependent steps
// through the direction bytes.  The first version ran a lane on one
// thread, serial along each row, with the query and the H/E rows in local
// memory, and wrote its direction rows to a [B, LT, LQ] scratch in device
// memory (21 MB at the path's 1,024 lanes) that the traceback read back;
// 1,024 lanes filled 8 of the 132 SMs.  Design: one warp per lane, one
// warp a block (1,024 blocks).  Lane l holds, in chunk k, the S = kS
// consecutive columns j = 32*S*k + S*l + s in registers: H of the row
// above, E, and the lane's scores against each target base.  F is a
// prefix maximum, the Hopper counterpart of pallas_global.py
// _cummax_sublanes: F(j) = max(kNeg - (j-beg)*e_ins, max over beg <= k < j
// of M(k) - oe_ins - (j-1-k)*e_ins) with M(k) = H(i-1, k-1) + score, which
// does not depend on the row's H, so a serial maximum over the lane's
// columns and one shuffle scan across the lanes give every column its F
// (integer maxima: equal to the serial loop).  One shuffle hands H(i, j-1)
// to the lane above.  The direction bytes stay in shared memory (LT x LQ,
// 20 KB at LT=160), a row as one S-byte store per lane; the traceback
// runs on lane 0 from there into ops staged in shared memory, and the
// warp writes the lane's ops row, zero tail included, as 16-byte pieces.
// No scratch in device memory, nothing in local memory.  What bounds it
// now: a row costs the warp one dependent shuffle scan and one shuffle,
// so a lane is tlen of them, then the traceback's dependent
// shared-memory reads on one thread.
//
// The lanes are written against a team (team.cuh): on the host, g++
// builds the same source with the 32 lanes as arrays (bm_global2_host).
#include <cstdint>
#include <cstring>

#include "team.cuh"

namespace {

constexpr int32_t kNeg = -0x40000000;
// below every in-band value of the F scan (pallas_global.py NEG2)
constexpr int32_t kNeg2 = -0x60000000;
constexpr int kS = 4;   // consecutive columns a lane holds in a chunk

BM_HD int nib(const int8_t* row, int j) {
  return (row[j >> 1] >> ((j & 1) * 4)) & 15;
}

// S bytes packed in a word (byte s at bits 8s) stored at p
template <int S>
BM_HD void put_bytes(uint8_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  if (S == 4) {  // one 32-bit store (p is 4-aligned)
    *reinterpret_cast<uint32_t*>(p) = v;
    return;
  }
#endif
  for (int s = 0; s < S; ++s) p[s] = static_cast<uint8_t>(v >> (8 * s));
}

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

// 16 bytes from src to dst (src == null: zeros)
BM_HD void copy16(uint8_t* dst, const uint8_t* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) =
      src ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
#else
  if (src)
    std::memcpy(dst, src, 16);
  else
    std::memset(dst, 0, 16);
#endif
}

// n bytes from src to dst by the lanes of tm (src == null: zeros): 16-byte
// pieces where n and both addresses allow them, else bytes
template <class TM>
BM_HD void warp_copy(const TM& tm, uint8_t* dst, const uint8_t* src, int n) {
  const bool wide = n % 16 == 0
      && (reinterpret_cast<uintptr_t>(dst) & 15) == 0
      && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int l = 0; l < TM::NL; ++l) {
    if (wide) {
      for (int p = 16 * tm.lane(l); p < n; p += 16 * TM::kG)
        copy16(dst + p, src ? src + p : nullptr);
    } else {
      for (int p = tm.lane(l); p < n; p += TM::kG) dst[p] = src ? src[p] : 0;
    }
  }
}

BM_HD int stage_bytes(int LT, int LQ) { return (LT + LQ + 15) & ~15; }

struct GloArgs {
  const int8_t *q, *t;       // packed rows [B, LQ/2] / [B, LT/2]
  const int32_t *qlen, *tlen, *w;
  int LT;
  int o_del, e_del, o_ins, e_ins;
  int32_t* score;
  uint8_t* ops;              // [B, LT + LQ]
  int32_t *n_ops, *rem_i, *rem_k;
};

// ksw_global2_batched for lane b (bwamem_tpu/ops/ksw.py:369-490) by the 32
// lanes of tm.  z (LT x LQ direction bytes) and stage (the ops, LT + LQ
// bytes, 16-aligned) are the warp's shared memory.
template <int LQ, int S, class TM>
BM_HD void global_lane(const TM& tm, const GloArgs& a, const int8_t* mat,
                       int b, uint8_t* z, uint8_t* stage) {
  constexpr int NL = TM::NL, CW = 32 * S, K = LQ / CW;
  static_assert(TM::kG == 32 && K * CW == LQ, "one warp, whole chunks");
  const int LT = a.LT;
  // lengths inside the bucket: a longer one from a caller that skipped
  // the host check reads and writes nothing past the lane's rows
  const int qlen = bm_min(bm_max(a.qlen[b], 0), LQ);
  const int tlen = bm_min(bm_max(a.tlen[b], 0), LT);
  const int w = a.w[b];
  const int e_del = a.e_del, e_ins = a.e_ins;
  const int oe_del = a.o_del + e_del, oe_ins = a.o_ins + e_ins;
  const int8_t* qpk = a.q + static_cast<int64_t>(b) * (LQ / 2);
  const int8_t* tpk = a.t + static_cast<int64_t>(b) * (LT / 2);

  // the lane's columns: hh[j] = H(i-1, j-1), ee[j] = E(i, j) (ksw.c:520-526),
  // prof[t] the scores of the query bases against target base t (0 past
  // qlen, never used); eh_h[LQ] is the uniform h_lq
  const int w0 = qlen < w ? qlen : w;
  int32_t hh[NL][K][S], ee[NL][K][S];
  uint32_t prof[NL][K][5];
  for (int l = 0; l < NL; ++l)
    for (int k = 0; k < K; ++k) {
      for (int t = 0; t < 5; ++t) prof[l][k][t] = 0;
      for (int s = 0; s < S; ++s) {
        const int j = CW * k + S * tm.lane(l) + s;
        const int qb = j < qlen ? nib(qpk, j) : 0;
        for (int t = 0; t < 5; ++t)
          prof[l][k][t] |= static_cast<uint32_t>(
              static_cast<uint8_t>(mat[t * 5 + qb])) << (8 * s);
        hh[l][k][s] = j == 0 ? 0 : (j <= w0 ? -(a.o_ins + e_ins * j) : kNeg);
        ee[l][k][s] = kNeg;
      }
    }
  int32_t h_lq = LQ <= w0 ? -(a.o_ins + e_ins * LQ) : kNeg;

  int tb = tlen > 0 ? nib(tpk, 0) : 0;
  for (int i = 0; i < tlen; ++i) {
    const int tb_next = i + 1 < tlen ? nib(tpk, i + 1) : 0;
    uint8_t* zr = z + i * LQ;
    const int beg = i - w > 0 ? i - w : 0;
    const int end = i + w + 1 < qlen ? i + w + 1 : qlen;
    const int32_t h1 = beg == 0 ? -(a.o_del + e_del * (i + 1)) : kNeg;
    if (end <= beg) {  // a degenerate band: only eh[end] is stored
      for (int l = 0; l < NL; ++l)
        for (int k = 0; k < K; ++k) {
          for (int s = 0; s < S; ++s)
            if (CW * k + S * tm.lane(l) + s == end) {
              hh[l][k][s] = h1;
              ee[l][k][s] = kNeg;
            }
          put_bytes<S>(zr + CW * k + S * tm.lane(l), 0);
        }
      if (end == LQ) h_lq = h1;
      tb = tb_next;
      continue;
    }
    // the chunks of columns [beg, end]: kb..kc (column LQ is h_lq)
    const int kb = beg / CW, kc = end / CW < K ? end / CW : K - 1;
    int32_t pre = kNeg2;  // max of M(j) + j*e_ins over the done chunks' band
    int32_t carry[NL];    // the chunk before's lane-31 H (lane 0 takes it)
    for (int l = 0; l < NL; ++l) carry[l] = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kb || k > kc) {  // uniform: no column of the band
        for (int l = 0; l < NL; ++l)
          put_bytes<S>(zr + CW * k + S * tm.lane(l), 0);
        continue;
      }
      // M(j), and the maxima of M(k) + k*e_ins over the band's columns
      // below j: the lane's own (lx), the lanes below (ex), the chunks
      // before (pre)
      int32_t m[NL][S], lx[NL][S], agg[NL], ex[NL];
      for (int l = 0; l < NL; ++l) {
        const uint32_t sw = pick(prof[l][k], tb);
        int32_t run = kNeg2;
        for (int s = 0; s < S; ++s) {
          const int j = CW * k + S * tm.lane(l) + s;
          m[l][s] = hh[l][k][s] + byte_at(sw, s);
          lx[l][s] = run;
          if (j >= beg && j < end) run = bm_max(run, m[l][s] + j * e_ins);
        }
        agg[l] = run;
      }
      const int32_t top = K > 1 ? tm.max_all(agg) : kNeg2;
      tm.scan_max_excl(agg, kNeg2, ex);
      // the cell as the serial row loop computes it (ksw.c:545-567), with
      // F the value carried into column j
      int32_t h[NL][S], hl[NL], rot[NL];
      int src[NL];
      uint32_t dw[NL];
      for (int l = 0; l < NL; ++l) {
        dw[l] = 0;
        for (int s = 0; s < S; ++s) {
          const int j = CW * k + S * tm.lane(l) + s;
          const int32_t p = bm_max(pre, bm_max(ex[l], lx[l][s]));
          const int32_t f = bm_max(kNeg - (j - beg) * e_ins,
                                   p - oe_ins - (j - 1) * e_ins);
          const int32_t mm = m[l][s], e = ee[l][k][s];
          uint32_t d = mm >= e ? 0 : 1;
          int32_t hv = mm >= e ? mm : e;
          d = hv >= f ? d : 2;
          hv = hv >= f ? hv : f;
          h[l][s] = hv;
          const int32_t e2 = e - e_del, te = mm - oe_del;
          d |= e2 > te ? 1 << 2 : 0;
          d |= f - e_ins > mm - oe_ins ? 2 << 4 : 0;
          if (j >= beg && j < end) {
            ee[l][k][s] = e2 > te ? e2 : te;
            dw[l] |= d << (8 * s);
          }
        }
        hl[l] = h[l][S - 1];
        src[l] = (tm.lane(l) + 31) & 31;
      }
      pre = bm_max(pre, top);
      // the next row's diagonal: hh[j] = h1 at beg and H(i, j-1) on
      // (beg, end], ee[end] = kNeg; H(i, j-1) of a lane's first column is
      // the lane below's last, lane 0 takes lane 31's of the chunk before
      tm.shfl(hl, src, rot);
      for (int l = 0; l < NL; ++l) {
        const int32_t left = tm.lane(l) ? rot[l] : carry[l];
        for (int s = 0; s < S; ++s) {
          const int j = CW * k + S * tm.lane(l) + s;
          const int32_t hp = s ? h[l][s - 1] : left;
          if (j == beg)
            hh[l][k][s] = h1;
          else if (j > beg && j <= end)
            hh[l][k][s] = hp;
          if (j == end) ee[l][k][s] = kNeg;
        }
        carry[l] = rot[l];
        put_bytes<S>(zr + CW * k + S * tm.lane(l), dw[l]);
      }
      if (k == K - 1 && end == LQ) h_lq = tm.bcast(hl, 31);
    }
    tb = tb_next;
  }
  // score = eh_h[qlen], from the lane that holds column qlen
  int32_t sv[NL];
  for (int l = 0; l < NL; ++l) {
    sv[l] = kNeg;
    for (int k = 0; k < K; ++k)
      for (int s = 0; s < S; ++s)
        if (CW * k + S * tm.lane(l) + s == qlen) sv[l] = hh[l][k][s];
  }
  const int32_t score = qlen >= LQ ? h_lq : tm.bcast(sv, (qlen % CW) / S);

  // traceback (ksw.c:570-584) on lane 0, the ops in reverse order into the
  // zeroed stage; then the warp writes the row out
  warp_copy(tm, stage, nullptr, LT + LQ);
  tm.sync();
  if (tm.lane(0) == 0) {
    int i = tlen - 1;
    int k = (i + w + 1 < qlen ? i + w + 1 : qlen) - 1;
    int which = 0, n = 0;
    while (i >= 0 && k >= 0) {
      which = (z[i * LQ + k] >> (which << 1)) & 3;
      stage[n++] = which == 0 ? 0 : (which == 1 ? 2 : 1);
      if (which != 2) --i;
      if (which != 1) --k;
    }
    a.score[b] = score;
    a.n_ops[b] = n;
    a.rem_i[b] = i;
    a.rem_k[b] = k;
  }
  tm.sync();
  warp_copy(tm, a.ops + static_cast<int64_t>(b) * (LT + LQ), stage, LT + LQ);
}

GloArgs glo_args(int LT, const void* q, const void* t, const void* qlen,
                 const void* tlen, const void* w, int o_del, int e_del,
                 int o_ins, int e_ins, void* score, void* ops, void* n_ops,
                 void* rem_i, void* rem_k) {
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
  a.score = static_cast<int32_t*>(score);
  a.ops = static_cast<uint8_t*>(ops);
  a.n_ops = static_cast<int32_t*>(n_ops);
  a.rem_i = static_cast<int32_t*>(rem_i);
  a.rem_k = static_cast<int32_t*>(rem_k);
  return a;
}

#ifdef __CUDACC__
// One warp a block, one block a lane: the stage, then the direction bytes
// in dynamic shared memory.
template <int LQ>
__global__ void __launch_bounds__(32)
    global_kernel(GloArgs a, const int8_t* mat) {
  extern __shared__ __align__(16) uint8_t smem[];
  global_lane<LQ, kS>(DevTeam<32>(), a, mat, blockIdx.x,
                      smem + stage_bytes(a.LT, LQ), smem);
}
#endif

}  // namespace

#ifdef __CUDACC__
// mat: device int8[25].  One warp per lane, LT x LQ + LT + LQ bytes of
// shared memory a block.  Returns cudaGetLastError() (or the error of
// raising the block's shared-memory limit); 1001 for an LQ without an
// instantiation.
extern "C" int bm_global2(int LQ, int LT, int B, const void* q,
                          const void* t, const void* qlen, const void* tlen,
                          const void* w, const void* mat, int o_del,
                          int e_del, int o_ins, int e_ins, void* score,
                          void* ops, void* n_ops, void* rem_i, void* rem_k,
                          void* stream) {
  const GloArgs a = glo_args(LT, q, t, qlen, tlen, w, o_del, e_del, o_ins,
                             e_ins, score, ops, n_ops, rem_i, rem_k);
  if (LQ != 128) return 1001;
  const int shm = stage_bytes(LT, 128) + LT * 128;
  if (shm > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        global_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shm);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  if (B > 0)
    global_kernel<128><<<B, 32, shm, static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<const int8_t*>(mat));
  return static_cast<int>(cudaGetLastError());
}
#else
// The host emulation (g++): the same arguments on host memory, without
// the stream.  Returns 0; 1001 for an LQ without an instantiation.
extern "C" int bm_global2_host(int LQ, int LT, int B, const void* q,
                               const void* t, const void* qlen,
                               const void* tlen, const void* w,
                               const void* mat, int o_del, int e_del,
                               int o_ins, int e_ins, void* score, void* ops,
                               void* n_ops, void* rem_i, void* rem_k) {
  const GloArgs a = glo_args(LT, q, t, qlen, tlen, w, o_del, e_del, o_ins,
                             e_ins, score, ops, n_ops, rem_i, rem_k);
  if (LQ != 128) return 1001;
  // the block's shared memory: operator new[] aligns to 16 on the hosts
  // the emulation builds for
  uint8_t* smem = new uint8_t[stage_bytes(LT, 128) + LT * 128];
  const HostTeam<32> tm;
  for (int b = 0; b < B; ++b)
    global_lane<128, kS>(tm, a, static_cast<const int8_t*>(mat), b,
                         smem + stage_bytes(LT, 128), smem);
  delete[] smem;
  return 0;
}
#endif
