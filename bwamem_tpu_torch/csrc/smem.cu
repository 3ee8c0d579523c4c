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
// previous step, so one read is a chain of dependent loads, a few
// thousand for the longest reads of a launch.  A 4.6 Mbp genome's table
// (4.6 MB) stays in the 50 MB L2 of the card; a human-scale one (3 GB)
// does not, and then each step waits on HBM.  How many rows a second an
// SM fetches grows with the loads it has in flight, up to one block of
// lanes per SM (PERF.md, the row-chain lanes sweep).
// Design: a group of kGroup = 8 threads per read (team.cuh), so the main
// path's 8,192 reads are 65,536 threads in 2,048 one-warp blocks spread
// over every SM (8 threads measured 10-19% faster than 4 at every bucket,
// PERF.md).  What bounds it now is still the chain: a launch takes as
// long as its longest reads' dependent steps (~2,100 steps of ~467 ns at
// L=128 on an H100 with the table in L2); the group makes each step one
// coalesced fetch, not fewer steps.  A forward step loads the two rows as one 16-byte load per
// thread (fm_extend1_team: threads 0-3 the k row, 4-7 the l row),
// coalesced, and sums the counts across the group with shuffles.  The
// backward step extends the step's intervals in parallel, interval p on
// thread p mod 8, each by eight independent 16-byte loads
// (fm_extend1_v); the serial loop's order-dependent rules follow by
// ballot and shuffle: the first interval alone can end a match (a mem is
// appended when it fails, if j + 1 is below the last mem's qb), and an
// interval is kept unless its size equals the previous surviving
// interval's.  The interval buffers (forward/backward and the
// two passes' mems) live in shared memory, one GroupBuf per read; the
// query is read from its packed row.  Caps and flags follow the JAX
// kernel exactly: M-entry forward and mem buffers, OUT_CAP output slots,
// and any count past a cap sets `over` without writing out of bounds.
// The merge runs on every thread of the group, each writing one of the
// four output arrays.  Reads of up to 512 bp (the L=128, 256 and 512
// buckets) share one instantiation per buffer size (M <= 16, M <= 32):
// the merge compares (qb, qe) pairs, so the JAX 512 bucket's radix-1024
// key and its uint8/int32 wire choice have no counterpart here.
//
// bm_smem_iter_step is one iterator step on its own (pass 1, the
// re-seeding test, pass 2), for the round-per-launch route
// (BWAMEM_TPU_SUPERSTEP=0).  It replaces pallas_smem.py smem1_pallas and
// pallas_bigsmem.py smem1_pallas_big, which bwamem_tpu/ops/smem.py
// smem_iter_step (:56-119) calls twice per dispatch.  The same group
// design and the same bound; each step pays a launch and a fetch, which
// is what the superstep removes.
//
// The table may be split by rows over several cards (mem --shard-tables):
// every function takes the index view as a template parameter (fm.cuh),
// FmView for the whole table or FmSplitView for its parts, and each entry
// launches the instantiation that its count of parts asks for; nothing
// else in the superstep differs.
//
// On the host, g++ builds the same source with a group's threads as
// arrays (bm_smem_superstep_host, bm_smem_iter_step_host).
#include "fm.cuh"
#include "team.cuh"

namespace {

constexpr int kGroup = 8;     // threads per read
constexpr int kBlock = 32;    // threads per block

struct Cur {
  int64_t x0, x1, s;
  int32_t end;
};

struct Mem {
  int64_t x0, x1, s;
  int32_t qb, qe;
};

// A read's buffers: the forward/backward intervals and the two passes'
// SMEMs (shared memory on the card).
template <int MAXM>
struct GroupBuf {
  Cur a[MAXM], b[MAXM];
  Mem m1[MAXM], m2[MAXM];
};

BM_HD int qbase(const int8_t* row, int i) {
  return (row[i >> 1] >> ((i & 1) * 4)) & 15;
}

// One bwt_smem1 pass from position x of the packed query q, by the lanes
// of tm.  mem[] receives the SMEMs in append order (qb descending);
// returns false when a buffer of M entries overflows.
template <int MAXM, class TM, class FV>
BM_HD bool smem1_group(const TM& tm, const FV& f, const int8_t* q,
                       int qlen, int x, int64_t min_intv, int M, Cur* bufa,
                       Cur* bufb, Mem* mem, int* n_mem, int* ret) {
  constexpr int NL = TM::NL, G = TM::kG;
  *n_mem = 0;
  const int qx = qbase(q, x);
  if (qx > 3) {
    *ret = x + 1;
    return true;
  }
  if (min_intv < 1) min_intv = 1;
  int64_t ik0 = f.L2[qx] + 1, ik1 = f.L2[3 - qx] + 1;
  int64_t iks = f.L2[qx + 1] - f.L2[qx];
  int ikend = x + 1;
  int n_curr = 0;
  Cur* const top = bufa + MAXM;  // pushes fill bufa from the top down
  // each step's query base is loaded a step ahead, off the chain of
  // dependent row loads
  int cb_next = x + 1 < qlen ? qbase(q, x + 1) : 4;
  for (int i = x + 1;; ++i) {    // forward extension
    const bool at_end = i >= qlen;
    const int cb = at_end ? 4 : cb_next;
    cb_next = i + 1 < qlen ? qbase(q, i + 1) : 4;
    bool push = true, stop = true;
    Iv3 n{0, 0, 0};
    if (!at_end && cb <= 3) {
      n = fm_extend1_team(tm, f, ik0, ik1, iks, false, 3 - cb);
      push = n.s != iks;
      stop = push && n.s < min_intv;
    }
    if (push) {
      if (n_curr == M) return false;
      ++n_curr;
      for (int l = 0; l < NL; ++l)
        if (tm.lane(l) == 0) top[-n_curr] = Cur{ik0, ik1, iks, ikend};
      *ret = ikend;
    }
    if (stop) break;
    ik0 = n.x0;
    ik1 = n.x1;
    iks = n.s;
    ikend = i + 1;
  }
  tm.sync();
  const Cur* prev = top - n_curr;  // longest matches (smallest intervals)
  Cur* curr = bufb;                // first
  Cur* spare = bufa;
  int n_prev = n_curr;
  int last_qb = 0;                 // mem[*n_mem - 1].qb
  int c_next = x - 1 >= 0 ? qbase(q, x - 1) : 4;
  for (int j = x - 1;; --j) {      // backward extension
    const int c = c_next > 3 ? -1 : c_next;
    c_next = j - 1 >= 0 ? qbase(q, j - 1) : 4;
    int n_new = 0, n_nf = 0;
    int64_t last_s = 0;            // the size of the last surviving interval
    bool fail0 = true;
    for (int p0 = 0; p0 < n_prev; p0 += G) {  // interval p on lane p mod G
      Iv3 ok[NL];
      int64_t s[NL], ps[NL];
      bool nf[NL], keep[NL];
      int src[NL];
      for (int l = 0; l < NL; ++l) {
        const int p = p0 + tm.lane(l);
        ok[l] = Iv3{0, 0, 0};
        nf[l] = false;
        if (c >= 0 && p < n_prev) {
          ok[l] = fm_extend1_v(f, prev[p].x0, prev[p].x1, prev[p].s, true, c);
          nf[l] = ok[l].s >= min_intv;
        }
        s[l] = ok[l].s;
      }
      const uint32_t b_nf = tm.ballot(nf);
      if (p0 == 0) fail0 = !(b_nf & 1u);
      for (int l = 0; l < NL; ++l) {
        const uint32_t below = b_nf & ((1u << tm.lane(l)) - 1u);
        src[l] = below ? bm_top_bit(below) : tm.lane(l);
      }
      tm.shfl(s, src, ps);
      // kept: a surviving interval whose size differs from the previous
      // surviving one's (the first survivor always)
      for (int l = 0; l < NL; ++l) {
        const uint32_t below = b_nf & ((1u << tm.lane(l)) - 1u);
        const int64_t sp = below ? ps[l] : last_s;
        keep[l] = nf[l] && ((below == 0 && n_nf == 0) || s[l] != sp);
      }
      const uint32_t b_keep = tm.ballot(keep);
      for (int l = 0; l < NL; ++l)
        if (keep[l]) {
          const int t = tm.lane(l);
          curr[n_new + bm_popc32(b_keep & ((1u << t) - 1u))] =
              Cur{ok[l].x0, ok[l].x1, ok[l].s, prev[p0 + t].end};
        }
      n_new += bm_popc32(b_keep);
      if (b_nf) {
        last_s = tm.bcast(s, bm_top_bit(b_nf));
        n_nf += bm_popc32(b_nf);
      }
    }
    // the first interval failing ends a match, unless one starts at j + 1
    if (fail0 && (*n_mem == 0 || j + 1 < last_qb)) {
      if (*n_mem == M) return false;
      for (int l = 0; l < NL; ++l)
        if (tm.lane(l) == 0)
          mem[*n_mem] =
              Mem{prev[0].x0, prev[0].x1, prev[0].s, j + 1, prev[0].end};
      ++*n_mem;
      last_qb = j + 1;
    }
    tm.sync();
    if (n_new == 0) break;
    prev = curr;
    Cur* t = spare;
    spare = curr;
    curr = t;
    n_prev = n_new;
  }
  return true;
}

// A lane's query length inside its bucket [0, L]: a longer one from a
// caller that skipped the host check reads no base past the lane's row.
BM_HD int bucket_len(int qlen, int L) {
  return qlen < 0 ? 0 : (qlen > L ? L : qlen);
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

// The whole iterator for read b, by the lanes of tm.  Outputs
// o0/os/oqb/oqe [B, out_cap], n_out [B], over [B].
template <int MAXM, class TM, class FV>
BM_HD void superstep_group(const TM& tm, GroupBuf<MAXM>& buf,
                           const FV& f, const int8_t* q_pk, int L,
                           const int32_t* qlen_a, const int64_t* min_intv_a,
                           const uint8_t* active, const int32_t* split_len,
                           const int32_t* split_width, int M, int out_cap,
                           int64_t* o0, int64_t* os, int32_t* oqb,
                           int32_t* oqe, int32_t* n_out_a, uint8_t* over_a,
                           int b) {
  constexpr int NL = TM::NL, G = TM::kG;
  const int8_t* q = q_pk + static_cast<int64_t>(b) * (L >> 1);
  const int qlen = bucket_len(qlen_a[b], L);
  const int64_t min_intv = min_intv_a[b];
  const int64_t base = static_cast<int64_t>(b) * out_cap;
  const Mem* m1 = buf.m1;
  const Mem* m2 = buf.m2;
  int n_out = 0;
  bool over = false;
  int x = 0;
  bool done = !active[b] || x >= qlen;
  while (!done) {
    int n1 = 0, n2 = 0, ret = 0, ret2 = 0;
    if (!smem1_group<MAXM>(tm, f, q, qlen, x, min_intv, M, buf.a, buf.b,
                           buf.m1, &n1, &ret)) {
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
        !smem1_group<MAXM>(tm, f, q, qlen, (m1[best].qb + m1[best].qe) >> 1,
                           m1[best].s + 1, M, buf.a, buf.b, buf.m2, &n2,
                           &ret2)) {
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
    // ordered merge (software/bwamem.c:206-238), sub first on key ties;
    // lane t writes output array t mod G
    for (int l = 0; l < NL; ++l) {
      const int t = tm.lane(l);
      int i = n1 - 1, j = n2 - 1;
      int64_t at = base + n_out;
      while (i >= 0 || j >= 0) {
        if (j >= 0 && !((m2[j].qe - m2[j].qb >= (best_len >> 1)) &&
                        m2[j].qe > x)) {
          --j;
          continue;
        }
        const bool take_main = j < 0 || (i >= 0 && key_less(m1[i], m2[j]));
        const Mem& m = take_main ? m1[i--] : m2[j--];
        if (t == 0) o0[at] = m.x0;
        if (t == 1 % G) os[at] = m.s;
        if (t == 2 % G) oqb[at] = m.qb;
        if (t == 3 % G) oqe[at] = m.qe;
        ++at;
      }
    }
    tm.sync();
    n_out += n1 + ns;
    x = ret;
    done = x >= qlen;
  }
  for (int l = 0; l < NL; ++l)
    if (tm.lane(l) == 0) {
      n_out_a[b] = n_out;
      over_a[b] = over;
    }
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

// Run one bwt_smem1 pass for read b into buf.m1 and write it out.  An
// inactive lane returns x + 1 and no SMEMs, as a lane starting on an
// ambiguous base does; an overflowing lane (a buffer of M entries) is
// flagged and otherwise written as an inactive one.  Returns the count
// of SMEMs, -1 on overflow.
template <int MAXM, class TM, class FV>
BM_HD int pass_group(const TM& tm, GroupBuf<MAXM>& buf, const FV& f,
                     const int8_t* q, int qlen, bool act, int x,
                     int64_t min_intv, int M, int m_out, const PassOut& o,
                     int b) {
  constexpr int NL = TM::NL, G = TM::kG;
  int n = 0, ret = x + 1;
  bool ok = true;
  if (act)
    ok = smem1_group<MAXM>(tm, f, q, qlen, x, min_intv, M, buf.a, buf.b,
                           buf.m1, &n, &ret);
  if (!ok) {
    n = 0;
    ret = x + 1;
  }
  const int64_t base = static_cast<int64_t>(b) * m_out;
  for (int l = 0; l < NL; ++l) {
    const int t = tm.lane(l);
    if (t == 0) {
      o.ret[b] = ret;
      o.n[b] = n;
      o.over[b] = !ok;
    }
    for (int j = t; j < m_out; j += G) {
      Mem m{0, 0, 0, 0, 0};
      if (j < n) m = buf.m1[n - 1 - j];
      o.x0[base + j] = m.x0;
      o.x1[base + j] = m.x1;
      o.s[base + j] = m.s;
      o.qb[base + j] = m.qb;
      o.qe[base + j] = m.qe;
    }
  }
  return ok ? n : -1;
}

// One iterator step for read b (bwamem_tpu/ops/smem.py smem_iter_step):
// pass 1 from x[b]; the re-seeding test on its longest SMEM; pass 2 from
// that SMEM's middle with min_intv = its size + 1 where the test holds.
template <int MAXM, class TM, class FV>
BM_HD void iter_step_group(const TM& tm, GroupBuf<MAXM>& buf,
                           const FV& f, const int8_t* q_pk, int L,
                           const int32_t* qlen_a, const int32_t* x_a,
                           const int64_t* min_intv_a, const uint8_t* active,
                           const int32_t* split_len,
                           const int32_t* split_width, int M, int m_out,
                           const PassOut& o1, uint8_t* need2_a,
                           const PassOut& o2, int b) {
  const int8_t* q = q_pk + static_cast<int64_t>(b) * (L >> 1);
  const int qlen = bucket_len(qlen_a[b], L);
  const int x = x_a[b];
  const Mem* mem = buf.m1;
  // a start outside the lane's row reads nothing: the lane runs as
  // inactive
  const int n1 = pass_group<MAXM>(tm, buf, f, q, qlen,
                                  active[b] != 0 && x >= 0 && x < L, x,
                                  min_intv_a[b], M, m_out, o1, b);
  int best_len = -1, best = 0;
  if (n1 > 0) best = longest_mem(mem, n1, &best_len);
  const bool need2 = n1 > 0 && split_len[b] > 0 &&
                     best_len >= split_len[b] &&
                     mem[best].s <= split_width[b];
  const int x2 = need2 ? (mem[best].qb + mem[best].qe) >> 1 : 0;
  const int64_t mi2 = need2 ? mem[best].s + 1 : 1;
  for (int l = 0; l < TM::NL; ++l)
    if (tm.lane(l) == 0) need2_a[b] = need2;
  tm.sync();  // pass 2 rewrites buf.m1
  pass_group<MAXM>(tm, buf, f, q, qlen, need2, x2, mi2, M, m_out, o2, b);
}

PassOut pass_out(void* const* p) {
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
}

#ifdef __CUDACC__
constexpr int kReadsPerBlock = kBlock / kGroup;

template <int MAXM, class FV>
__global__ void __launch_bounds__(kBlock)
    superstep_kernel(FV f, const int8_t* q_pk, int L,
                     const int32_t* qlen, const int64_t* min_intv,
                     const uint8_t* active, const int32_t* split_len,
                     const int32_t* split_width, int M, int out_cap, int B,
                     int64_t* o0, int64_t* os, int32_t* oqb, int32_t* oqe,
                     int32_t* n_out, uint8_t* over) {
  __shared__ GroupBuf<MAXM> bufs[kReadsPerBlock];
  const int g = threadIdx.x / kGroup;
  const int b = blockIdx.x * kReadsPerBlock + g;
  if (b >= B) return;
  superstep_group<MAXM>(DevTeam<kGroup>(), bufs[g], f, q_pk, L, qlen,
                        min_intv, active, split_len, split_width, M, out_cap,
                        o0, os, oqb, oqe, n_out, over, b);
}

template <int MAXM, class FV>
__global__ void __launch_bounds__(kBlock)
    iter_step_kernel(FV f, const int8_t* q_pk, int L,
                     const int32_t* qlen, const int32_t* x,
                     const int64_t* min_intv, const uint8_t* active,
                     const int32_t* split_len, const int32_t* split_width,
                     int M, int m_out, int B, PassOut o1, uint8_t* need2,
                     PassOut o2) {
  __shared__ GroupBuf<MAXM> bufs[kReadsPerBlock];
  const int g = threadIdx.x / kGroup;
  const int b = blockIdx.x * kReadsPerBlock + g;
  if (b >= B) return;
  iter_step_group<MAXM>(DevTeam<kGroup>(), bufs[g], f, q_pk, L, qlen, x,
                        min_intv, active, split_len, split_width, M, m_out,
                        o1, need2, o2, b);
}
#endif

}  // namespace

#ifdef __CUDACC__
// A group of kGroup threads per read, kBlock threads per block; every
// part of the table must be 16-byte aligned.  occ: the n_parts parts'
// addresses (a host array), part_rows the rows of each but the last; one
// part is the whole table.
extern "C" int bm_smem_superstep(
    const void* const* occ, int n_parts, int64_t part_rows, int64_t primary,
    int64_t seq_len, const void* L2, const void* q_pk, int L,
    const void* qlen, const void* min_intv, const void* active,
    const void* split_len, const void* split_width, int M, int out_cap,
    int B, void* o0, void* os, void* oqb, void* oqe, void* n_out,
    void* over, void* stream) {
  const int grid = (B + kReadsPerBlock - 1) / kReadsPerBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_fm_view(occ, n_parts, part_rows, primary, seq_len, L2,
                      [&](const auto& f) {
    using FV = std::decay_t<decltype(f)>;
#define BM_LAUNCH(MM)                                                      \
  superstep_kernel<MM, FV><<<grid, kBlock, 0, st>>>(                       \
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
  });
}

// out1/out2: the eight pointers of a PassOut each (ret, n, x0, x1, s, qb,
// qe, over), as a host array of device pointers.
extern "C" int bm_smem_iter_step(
    const void* const* occ, int n_parts, int64_t part_rows, int64_t primary,
    int64_t seq_len, const void* L2, const void* q_pk, int L,
    const void* qlen, const void* x, const void* min_intv,
    const void* active, const void* split_len, const void* split_width,
    int M, int m_out, int B, void* const* out1, void* need2,
    void* const* out2, void* stream) {
  const PassOut o1 = pass_out(out1), o2 = pass_out(out2);
  const int grid = (B + kReadsPerBlock - 1) / kReadsPerBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_fm_view(occ, n_parts, part_rows, primary, seq_len, L2,
                      [&](const auto& f) {
    using FV = std::decay_t<decltype(f)>;
#define BM_LAUNCH(MM)                                                      \
  iter_step_kernel<MM, FV><<<grid, kBlock, 0, st>>>(                       \
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
  });
}

// Peer access from card dev to card peer's memory, so that a kernel on
// dev loads the rows of a table part that lies on peer.  0 once enabled
// (also where it was already), -1 where the pair cannot reach each other,
// else the CUDA error.  Access is one-way: enable both directions.
extern "C" int bm_enable_peer(int dev, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!can) return -1;
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear it: already enabled is success
      e = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : back);
}
#else
// The host emulation (g++): the same arguments on host memory, without
// the stream.  Returns 0, kBadParts for parts it does not take.
extern "C" int bm_smem_superstep_host(
    const void* const* occ, int n_parts, int64_t part_rows, int64_t primary,
    int64_t seq_len, const void* L2, const void* q_pk, int L,
    const void* qlen, const void* min_intv, const void* active,
    const void* split_len, const void* split_width, int M, int out_cap,
    int B, void* o0, void* os, void* oqb, void* oqe, void* n_out,
    void* over) {
  return with_fm_view(occ, n_parts, part_rows, primary, seq_len, L2,
                      [&](const auto& f) {
    const HostTeam<kGroup> tm;
    GroupBuf<32> buf;
    for (int b = 0; b < B; ++b)
      superstep_group<32>(tm, buf, f, static_cast<const int8_t*>(q_pk), L,
                          static_cast<const int32_t*>(qlen),
                          static_cast<const int64_t*>(min_intv),
                          static_cast<const uint8_t*>(active),
                          static_cast<const int32_t*>(split_len),
                          static_cast<const int32_t*>(split_width), M,
                          out_cap, static_cast<int64_t*>(o0),
                          static_cast<int64_t*>(os),
                          static_cast<int32_t*>(oqb),
                          static_cast<int32_t*>(oqe),
                          static_cast<int32_t*>(n_out),
                          static_cast<uint8_t*>(over), b);
    return 0;
  });
}

extern "C" int bm_smem_iter_step_host(
    const void* const* occ, int n_parts, int64_t part_rows, int64_t primary,
    int64_t seq_len, const void* L2, const void* q_pk, int L,
    const void* qlen, const void* x, const void* min_intv,
    const void* active, const void* split_len, const void* split_width,
    int M, int m_out, int B, void* const* out1, void* need2,
    void* const* out2) {
  const PassOut o1 = pass_out(out1), o2 = pass_out(out2);
  return with_fm_view(occ, n_parts, part_rows, primary, seq_len, L2,
                      [&](const auto& f) {
    const HostTeam<kGroup> tm;
    GroupBuf<32> buf;
    for (int b = 0; b < B; ++b)
      iter_step_group<32>(tm, buf, f, static_cast<const int8_t*>(q_pk), L,
                          static_cast<const int32_t*>(qlen),
                          static_cast<const int32_t*>(x),
                          static_cast<const int64_t*>(min_intv),
                          static_cast<const uint8_t*>(active),
                          static_cast<const int32_t*>(split_len),
                          static_cast<const int32_t*>(split_width), M, m_out,
                          o1, static_cast<uint8_t*>(need2), o2, b);
    return 0;
  });
}
#endif
