// SA walk: bwt_sa for a batch of suffix-array rows.
//
// Replaces the TPU kernels bwamem_tpu/ops/pallas_smem.py _sa_walk_fn
// (_make_sa_kernel, via sa_lookup_pallas) and
// bwamem_tpu/ops/pallas_bigsmem.py _sa_walk_big_fn (via
// sa_lookup_pallas_big).  Each key walks inverse-Psi steps until it hits
// a sampled row (k % sa_intv == 0) or max_steps, then adds the step count
// to the sampled value; past max_steps the value is -1 and `over` is set,
// and the caller resolves the key on the host (software/bwt.c:104-114,
// scalar spec native/hostsmem.cpp bt_sa_lookup_batch; plain PyTorch
// version ops/fm.py sa_lookup_batched).
//
// What bounds it on an H100: a chain of dependent occ-block loads per key
// (one block per step: the B0 word and the occ words share it), about
// sa_intv/2 steps on average.  Design: one thread per key, plain loads,
// int64 coordinates for every table size; the parallelism of SA_SLICE or
// KEY_CAP keys per launch hides the latency.  With split tables (mem
// --shard-tables) the occ rows and the final SA read resolve their part
// (fm.cuh row_at); the whole-table instantiation reads as before.
//
// On the host, g++ builds the same source: bm_sa_walk_host runs the keys
// one after another.
#include "fm.cuh"

namespace {

template <class FV, class SA>
BM_HD void sa_walk_lane(const FV& f, const SA& sa, int sa_is64,
                        int64_t mask, int shift, const int64_t* keys,
                        int max_steps, void* vals, int vals_is64,
                        uint8_t* over, int i) {
  int64_t k = keys[i];
  int steps = 0;
  // a key outside [0, seq_len] reads no row: it is over
  const bool in = k >= 0 && k <= f.seq_len;
  while (in && (k & mask) != 0 && steps < max_steps) {
    k = fm_inv_psi(f, k);
    ++steps;
  }
  const bool ov = !in || (k & mask) != 0;
  int64_t v = -1;
  if (!ov) {
    const uint64_t si = static_cast<uint64_t>(k >> shift);
    v = steps + (sa_is64 ? *reinterpret_cast<const int64_t*>(
                               row_at(sa, si, 8))
                         : static_cast<int64_t>(
                               *reinterpret_cast<const int32_t*>(
                                   row_at(sa, si, 4))));
  }
  // the values in the index's coordinate dtype, the flag as a bool byte
  if (vals_is64)
    static_cast<int64_t*>(vals)[i] = v;
  else
    static_cast<int32_t*>(vals)[i] = static_cast<int32_t>(v);
  over[i] = ov;
}

#ifdef __CUDACC__
template <class FV, class SA>
__global__ void sa_walk_kernel(FV f, SA sa, int sa_is64, int64_t mask,
                               int shift, const int64_t* keys, int n,
                               int max_steps, void* vals, int vals_is64,
                               uint8_t* over) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    sa_walk_lane(f, sa, sa_is64, mask, shift, keys, max_steps, vals,
                 vals_is64, over, i);
}
#endif

int log2_of(int64_t sa_intv) {
  int shift = 0;
  while ((int64_t{1} << shift) < sa_intv) ++shift;
  return shift;
}

// fn(occ view, SA view): the whole tables for one part, else the parts
// of both (the SA cut over as many parts as the occ table).
template <class Fn>
int with_sa_views(const void* const* occ, int n_parts, int64_t occ_rows,
                  int64_t primary, int64_t seq_len, const void* L2,
                  const void* const* sa, int64_t sa_rows, Fn fn) {
  return with_fm_view(occ, n_parts, occ_rows, primary, seq_len, L2,
                      [&](const auto& f) {
    if constexpr (std::is_same<std::decay_t<decltype(f)>, FmView>::value) {
      return fn(f, Whole{static_cast<const char*>(sa[0])});
    } else {
      Parts p;
      if (!make_parts(&p, sa, n_parts, sa_rows)) return kBadParts;
      return fn(f, p);
    }
  });
}

}  // namespace

// occ/sa: the n_parts parts' addresses of the occ table and of the
// sampled SA (host arrays; one part each is the whole table), occ_rows
// and sa_rows the rows of each part but the last.  vals: int64 [n]
// (vals_is64) or int32 [n]; over: bool [n].
#ifdef __CUDACC__
extern "C" int bm_sa_walk(const void* const* occ, int n_parts,
                          int64_t occ_rows, int64_t primary, int64_t seq_len,
                          const void* L2, const void* const* sa,
                          int64_t sa_rows, int sa_is64, int64_t sa_intv,
                          const void* keys, int n, int max_steps, void* vals,
                          int vals_is64, void* over, void* stream) {
  const int shift = log2_of(sa_intv);
  const int threads = 256;
  return with_sa_views(occ, n_parts, occ_rows, primary, seq_len, L2, sa,
                       sa_rows, [&](const auto& f, const auto& sv) {
    if (n > 0)
      sa_walk_kernel<<<(n + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
          f, sv, sa_is64, sa_intv - 1, shift,
          static_cast<const int64_t*>(keys), n, max_steps, vals, vals_is64,
          static_cast<uint8_t*>(over));
    return static_cast<int>(cudaGetLastError());
  });
}
#else
// The host emulation: the same arguments on host memory, no stream.
extern "C" int bm_sa_walk_host(const void* const* occ, int n_parts,
                               int64_t occ_rows, int64_t primary,
                               int64_t seq_len, const void* L2,
                               const void* const* sa, int64_t sa_rows,
                               int sa_is64, int64_t sa_intv,
                               const void* keys, int n, int max_steps,
                               void* vals, int vals_is64, void* over) {
  const int shift = log2_of(sa_intv);
  return with_sa_views(occ, n_parts, occ_rows, primary, seq_len, L2, sa,
                       sa_rows, [&](const auto& f, const auto& sv) {
    for (int i = 0; i < n; ++i)
      sa_walk_lane(f, sv, sa_is64, sa_intv - 1, shift,
                   static_cast<const int64_t*>(keys), max_steps, vals,
                   vals_is64, static_cast<uint8_t*>(over), i);
    return 0;
  });
}
#endif
