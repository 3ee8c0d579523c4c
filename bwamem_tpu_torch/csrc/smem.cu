// SMEM superstep: the whole per-read SMEM iterator in one launch.
//
// Replaces the TPU kernels bwamem_tpu/ops/pallas_smem.py
// superstep_pallas (_make_superstep_kernel over _build_smem1) and
// bwamem_tpu/ops/pallas_bigsmem.py superstep_pallas_big: rounds of
// bwt_smem1 (forward pass, then backward pass over an M-wide interval
// buffer), the re-seeding test and pass 2, the ordered main/sub merge and
// the append to the read's output stream (software/bwamem.c:110-241).
// The scalar algorithm is native/hostsmem.cpp bt_smem1 plus the round
// logic of bwamem_tpu/ops/smem.py smem_superstep (:246-350); the plain
// PyTorch version beside this kernel is ops/smem.py.
//
// What bounds it on an H100: dependent occ-block loads.  Every extension
// step reads two 64-byte occ blocks whose addresses depend on the
// previous step, so one read is a chain of a few thousand dependent
// loads.  A 4.6 Mbp genome's table (4.6 MB) stays in the 50 MB L2 of
// the card (NVIDIA H100 80GB HBM3, 700 W power limit); a human-scale one
// (3 GB) does not, and then each step waits on HBM.
// Design: one thread per read, the TPU's byte-plane tables, one-hot
// gathers and radix planes left behind: plain global loads of the
// (n_blocks, 16) table and native int64.  Latency is hidden only by
// running many reads at once (8192 per launch on the main path); the
// interval buffers live in local memory.  Caps and flags follow the JAX
// kernel exactly: M-entry forward and mem buffers, OUT_CAP output slots,
// and any count past a cap sets `over` without writing out of bounds.
// Reads of up to 512 bp (the L=128, 256 and 512 buckets) share one
// instantiation: the query buffer is kMaxL bytes of local memory, and
// the merge compares (qb, qe) pairs, so the JAX 512 bucket's radix-1024
// key and its uint8/int32 wire choice have no counterpart here.
//
// bm_smem_iter_step is one iterator step on its own (pass 1, the
// re-seeding test, pass 2), for the round-per-launch route
// (BWAMEM_TPU_SUPERSTEP=0).  It replaces pallas_smem.py smem1_pallas and
// pallas_bigsmem.py smem1_pallas_big, which bwamem_tpu/ops/smem.py
// smem_iter_step (:56-119) calls twice per dispatch.  Same thread-per-read
// design and the same bound; each step pays a launch and a fetch, which
// is what the superstep removes.
#include "fm.cuh"

namespace {

constexpr int kMaxL = 512;

struct Cur {
  int64_t x0, x1, s;
  int32_t end;
};

struct Mem {
  int64_t x0, x1, s;
  int32_t qb, qe;
};

// One bwt_smem1 pass from position x.  mem[] receives the SMEMs in
// append order (qb descending); returns false when a buffer of M
// entries overflows.
template <int MAXM>
BM_HD bool smem1_lane(const FmView& f, const int8_t* q, int qlen, int x,
                      int64_t min_intv, int M, Mem* mem, int* n_mem,
                      int* ret) {
  *n_mem = 0;
  const int qx = q[x];
  if (qx > 3) {
    *ret = x + 1;
    return true;
  }
  if (min_intv < 1) min_intv = 1;
  Cur bufa[MAXM], bufb[MAXM];
  Cur* curr = bufa;
  Cur* prev = bufb;
  int64_t ik0 = f.L2[qx] + 1, ik1 = f.L2[3 - qx] + 1;
  int64_t iks = f.L2[qx + 1] - f.L2[qx];
  int ikend = x + 1;
  int n_curr = 0;
  for (int i = x + 1;; ++i) {  // forward extension
    const bool at_end = i >= qlen;
    const int cb = at_end ? 4 : q[i];
    bool push = true, stop = true;
    Iv3 n{0, 0, 0};
    if (!at_end && cb <= 3) {
      n = fm_extend1(f, ik0, ik1, iks, false, 3 - cb);
      push = n.s != iks;
      stop = push && n.s < min_intv;
    }
    if (push) {
      if (n_curr == M) return false;
      curr[n_curr++] = Cur{ik0, ik1, iks, ikend};
    }
    if (stop) break;
    ik0 = n.x0;
    ik1 = n.x1;
    iks = n.s;
    ikend = i + 1;
  }
  *ret = curr[n_curr - 1].end;
  int n_prev = n_curr;  // longest matches (smallest intervals) first
  for (int k = 0; k < n_curr; ++k) prev[k] = curr[n_curr - 1 - k];
  for (int j = x - 1;; --j) {  // backward extension
    const int c = (j < 0 || q[j] > 3) ? -1 : q[j];
    int n_new = 0;
    for (int p = 0; p < n_prev; ++p) {
      Iv3 ok{0, 0, 0};
      bool fail = c < 0;
      if (!fail) {
        ok = fm_extend1(f, prev[p].x0, prev[p].x1, prev[p].s, true, c);
        fail = ok.s < min_intv;
      }
      if (fail) {
        if (n_new == 0 &&
            (*n_mem == 0 || j + 1 < mem[*n_mem - 1].qb)) {
          if (*n_mem == M) return false;
          mem[(*n_mem)++] =
              Mem{prev[p].x0, prev[p].x1, prev[p].s, j + 1, prev[p].end};
        }
      } else if (n_new == 0 || ok.s != curr[n_new - 1].s) {
        curr[n_new++] = Cur{ok.x0, ok.x1, ok.s, prev[p].end};
      }
    }
    if (n_new == 0) break;
    Cur* t = prev;
    prev = curr;
    curr = t;
    n_prev = n_new;
  }
  return true;
}

// (qb, qlen - qe) lexicographic order of the reference's merge key.
BM_HD bool key_less(const Mem& a, const Mem& b) {
  return a.qb < b.qb || (a.qb == b.qb && a.qe > b.qe);
}

// The re-seeding candidate: the longest SMEM, the first maximum in
// qb-ascending order (mem[] is qb-descending, so scan from its end).
BM_HD int longest_mem(const Mem* mem, int n, int* best_len) {
  int best = 0;
  *best_len = -1;
  for (int k = n - 1; k >= 0; --k) {
    const int len = mem[k].qe - mem[k].qb;
    if (len > *best_len) {
      *best_len = len;
      best = k;
    }
  }
  return best;
}

// The query of lane b, unpacked from two bases a byte.
BM_HD void unpack_query(const int8_t* q_pk, int L, int b, int8_t* q) {
  const int8_t* row = q_pk + static_cast<int64_t>(b) * (L >> 1);
  for (int k = 0; k < (L >> 1); ++k) {
    q[2 * k] = row[k] & 15;
    q[2 * k + 1] = (row[k] >> 4) & 15;
  }
}

// The whole iterator for lane b.  Outputs o0/os/oqb/oqe [B, out_cap],
// n_out [B], over [B].
template <int MAXM>
BM_HD void superstep_lane(const FmView& f, const int8_t* q_pk, int L,
                          const int32_t* qlen_a, const int64_t* min_intv_a,
                          const uint8_t* active, const int32_t* split_len,
                          const int32_t* split_width, int M, int out_cap,
                          int64_t* o0, int64_t* os, int32_t* oqb,
                          int32_t* oqe, int32_t* n_out_a, uint8_t* over_a,
                          int b) {
  int8_t q[kMaxL];
  unpack_query(q_pk, L, b, q);
  const int qlen = qlen_a[b];
  const int64_t min_intv = min_intv_a[b];
  const int64_t base = static_cast<int64_t>(b) * out_cap;
  int n_out = 0;
  bool over = false;
  int x = 0;
  bool done = !active[b] || x >= qlen;
  Mem m1[MAXM], m2[MAXM];
  while (!done) {
    int n1 = 0, n2 = 0, ret = 0, ret2 = 0;
    if (!smem1_lane<MAXM>(f, q, qlen, x, min_intv, M, m1, &n1, &ret)) {
      over = true;
      break;
    }
    // re-seeding test on the longest SMEM (software/bwamem.c:185-204)
    int best_len;
    const int best = longest_mem(m1, n1, &best_len);
    const bool need2 = n1 > 0 && split_len[b] > 0 &&
                       best_len >= split_len[b] &&
                       m1[best].s <= split_width[b];
    if (need2 &&
        !smem1_lane<MAXM>(f, q, qlen, (m1[best].qb + m1[best].qe) >> 1,
                          m1[best].s + 1, M, m2, &n2, &ret2)) {
      over = true;
      break;
    }
    // sub matches kept: at least half the longest, ending after x
    int ns = 0;
    for (int k = 0; k < n2; ++k)
      ns += (m2[k].qe - m2[k].qb >= (best_len >> 1)) && m2[k].qe > x;
    if (n_out + n1 + ns > out_cap) {
      over = true;
      break;
    }
    // ordered merge (software/bwamem.c:206-238), sub first on key ties
    int i = n1 - 1, j = n2 - 1, k = n_out;
    while (i >= 0 || j >= 0) {
      if (j >= 0 && !((m2[j].qe - m2[j].qb >= (best_len >> 1)) &&
                      m2[j].qe > x)) {
        --j;
        continue;
      }
      const bool take_main = j < 0 || (i >= 0 && key_less(m1[i], m2[j]));
      const Mem& m = take_main ? m1[i--] : m2[j--];
      o0[base + k] = m.x0;
      os[base + k] = m.s;
      oqb[base + k] = m.qb;
      oqe[base + k] = m.qe;
      ++k;
    }
    n_out = k;
    x = ret;
    done = x >= qlen;
  }
  n_out_a[b] = n_out;
  over_a[b] = over;
}

// One pass's outputs (bwamem_tpu/ops/smem.py _truncate/_pack): ret and
// n [B]; x0/x1/s int64 and qb/qe int32 [B, m_out], qb-ascending, zero
// past n; over [B].
struct PassOut {
  int32_t *ret, *n;
  int64_t *x0, *x1, *s;
  int32_t *qb, *qe;
  uint8_t* over;
};

// Run one bwt_smem1 pass for lane b into mem[] and write it out.  An
// inactive lane returns x + 1 and no SMEMs, as a lane starting on an
// ambiguous base does; an overflowing lane (a buffer of M entries) is
// flagged and otherwise written as an inactive one.  Returns the count
// of SMEMs, -1 on overflow.
template <int MAXM>
BM_HD int pass_lane(const FmView& f, const int8_t* q, int qlen, bool act,
                    int x, int64_t min_intv, int M, int m_out, Mem* mem,
                    const PassOut& o, int b) {
  int n = 0, ret = x + 1;
  bool ok = true;
  if (act) ok = smem1_lane<MAXM>(f, q, qlen, x, min_intv, M, mem, &n, &ret);
  if (!ok) {
    n = 0;
    ret = x + 1;
  }
  o.ret[b] = ret;
  o.n[b] = n;
  o.over[b] = !ok;
  const int64_t base = static_cast<int64_t>(b) * m_out;
  for (int j = 0; j < m_out; ++j) {
    Mem m{0, 0, 0, 0, 0};
    if (j < n) m = mem[n - 1 - j];
    o.x0[base + j] = m.x0;
    o.x1[base + j] = m.x1;
    o.s[base + j] = m.s;
    o.qb[base + j] = m.qb;
    o.qe[base + j] = m.qe;
  }
  return ok ? n : -1;
}

// One iterator step for lane b (bwamem_tpu/ops/smem.py smem_iter_step):
// pass 1 from x[b]; the re-seeding test on its longest SMEM; pass 2 from
// that SMEM's middle with min_intv = its size + 1 where the test holds.
template <int MAXM>
BM_HD void iter_step_lane(const FmView& f, const int8_t* q_pk, int L,
                          const int32_t* qlen_a, const int32_t* x_a,
                          const int64_t* min_intv_a, const uint8_t* active,
                          const int32_t* split_len,
                          const int32_t* split_width, int M, int m_out,
                          const PassOut& o1, uint8_t* need2_a,
                          const PassOut& o2, int b) {
  int8_t q[kMaxL];
  unpack_query(q_pk, L, b, q);
  const int qlen = qlen_a[b];
  Mem mem[MAXM];
  const int n1 = pass_lane<MAXM>(f, q, qlen, active[b] != 0, x_a[b],
                                 min_intv_a[b], M, m_out, mem, o1, b);
  int best_len = -1, best = 0;
  if (n1 > 0) best = longest_mem(mem, n1, &best_len);
  const bool need2 = n1 > 0 && split_len[b] > 0 &&
                     best_len >= split_len[b] &&
                     mem[best].s <= split_width[b];
  need2_a[b] = need2;
  const int x2 = need2 ? (mem[best].qb + mem[best].qe) >> 1 : 0;
  const int64_t mi2 = need2 ? mem[best].s + 1 : 1;
  pass_lane<MAXM>(f, q, qlen, need2, x2, mi2, M, m_out, mem, o2, b);
}

#ifdef __CUDACC__
template <int MAXM>
__global__ void superstep_kernel(FmView f, const int8_t* q_pk, int L,
                                 const int32_t* qlen,
                                 const int64_t* min_intv,
                                 const uint8_t* active,
                                 const int32_t* split_len,
                                 const int32_t* split_width, int M,
                                 int out_cap, int B, int64_t* o0,
                                 int64_t* os, int32_t* oqb, int32_t* oqe,
                                 int32_t* n_out, uint8_t* over) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  superstep_lane<MAXM>(f, q_pk, L, qlen, min_intv, active, split_len,
                       split_width, M, out_cap, o0, os, oqb, oqe, n_out,
                       over, b);
}

template <int MAXM>
__global__ void iter_step_kernel(FmView f, const int8_t* q_pk, int L,
                                 const int32_t* qlen, const int32_t* x,
                                 const int64_t* min_intv,
                                 const uint8_t* active,
                                 const int32_t* split_len,
                                 const int32_t* split_width, int M,
                                 int m_out, int B, PassOut o1,
                                 uint8_t* need2, PassOut o2) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  iter_step_lane<MAXM>(f, q_pk, L, qlen, x, min_intv, active, split_len,
                       split_width, M, m_out, o1, need2, o2, b);
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" int bm_smem_superstep(
    const void* blocks, int64_t primary, int64_t seq_len, const void* L2,
    const void* q_pk, int L, const void* qlen, const void* min_intv,
    const void* active, const void* split_len, const void* split_width,
    int M, int out_cap, int B, void* o0, void* os, void* oqb, void* oqe,
    void* n_out, void* over, void* stream) {
  FmView f;
  f.blocks = static_cast<const uint32_t*>(blocks);
  f.primary = primary;
  f.seq_len = seq_len;
  for (int c = 0; c < 5; ++c) f.L2[c] = static_cast<const int64_t*>(L2)[c];
  const int threads = 128;
  const int grid = (B + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BM_LAUNCH(MM)                                                      \
  superstep_kernel<MM><<<grid, threads, 0, st>>>(                          \
      f, static_cast<const int8_t*>(q_pk), L,                              \
      static_cast<const int32_t*>(qlen),                                   \
      static_cast<const int64_t*>(min_intv),                               \
      static_cast<const uint8_t*>(active),                                 \
      static_cast<const int32_t*>(split_len),                              \
      static_cast<const int32_t*>(split_width), M, out_cap, B,             \
      static_cast<int64_t*>(o0), static_cast<int64_t*>(os),                \
      static_cast<int32_t*>(oqb), static_cast<int32_t*>(oqe),              \
      static_cast<int32_t*>(n_out), static_cast<uint8_t*>(over))
  if (B > 0) {
    if (M <= 16) {
      BM_LAUNCH(16);
    } else {
      BM_LAUNCH(32);
    }
  }
#undef BM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// out1/out2: the eight pointers of a PassOut each (ret, n, x0, x1, s, qb,
// qe, over), as a host array of device pointers.
extern "C" int bm_smem_iter_step(
    const void* blocks, int64_t primary, int64_t seq_len, const void* L2,
    const void* q_pk, int L, const void* qlen, const void* x,
    const void* min_intv, const void* active, const void* split_len,
    const void* split_width, int M, int m_out, int B, void* const* out1,
    void* need2, void* const* out2, void* stream) {
  FmView f;
  f.blocks = static_cast<const uint32_t*>(blocks);
  f.primary = primary;
  f.seq_len = seq_len;
  for (int c = 0; c < 5; ++c) f.L2[c] = static_cast<const int64_t*>(L2)[c];
  auto pass_out = [](void* const* p) {
    PassOut o;
    o.ret = static_cast<int32_t*>(p[0]);
    o.n = static_cast<int32_t*>(p[1]);
    o.x0 = static_cast<int64_t*>(p[2]);
    o.x1 = static_cast<int64_t*>(p[3]);
    o.s = static_cast<int64_t*>(p[4]);
    o.qb = static_cast<int32_t*>(p[5]);
    o.qe = static_cast<int32_t*>(p[6]);
    o.over = static_cast<uint8_t*>(p[7]);
    return o;
  };
  const PassOut o1 = pass_out(out1), o2 = pass_out(out2);
  const int threads = 128;
  const int grid = (B + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BM_LAUNCH(MM)                                                      \
  iter_step_kernel<MM><<<grid, threads, 0, st>>>(                          \
      f, static_cast<const int8_t*>(q_pk), L,                              \
      static_cast<const int32_t*>(qlen), static_cast<const int32_t*>(x),   \
      static_cast<const int64_t*>(min_intv),                               \
      static_cast<const uint8_t*>(active),                                 \
      static_cast<const int32_t*>(split_len),                              \
      static_cast<const int32_t*>(split_width), M, m_out, B, o1,           \
      static_cast<uint8_t*>(need2), o2)
  if (B > 0) {
    if (M <= 16) {
      BM_LAUNCH(16);
    } else {
      BM_LAUNCH(32);
    }
  }
#undef BM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
#endif
