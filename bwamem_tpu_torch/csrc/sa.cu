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
// KEY_CAP keys per launch hides the latency.
#include "fm.cuh"

namespace {

BM_HD void sa_walk_lane(const FmView& f, const void* sa, int sa_is64,
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
    const int64_t si = k >> shift;
    v = steps + (sa_is64 ? static_cast<const int64_t*>(sa)[si]
                         : static_cast<int64_t>(
                               static_cast<const int32_t*>(sa)[si]));
  }
  // the values in the index's coordinate dtype, the flag as a bool byte
  if (vals_is64)
    static_cast<int64_t*>(vals)[i] = v;
  else
    static_cast<int32_t*>(vals)[i] = static_cast<int32_t>(v);
  over[i] = ov;
}

#ifdef __CUDACC__
__global__ void sa_walk_kernel(FmView f, const void* sa, int sa_is64,
                               int64_t mask, int shift, const int64_t* keys,
                               int n, int max_steps, void* vals,
                               int vals_is64, uint8_t* over) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    sa_walk_lane(f, sa, sa_is64, mask, shift, keys, max_steps, vals,
                 vals_is64, over, i);
}
#endif

}  // namespace

#ifdef __CUDACC__
// vals: int64 [n] (vals_is64) or int32 [n]; over: bool [n].
extern "C" int bm_sa_walk(const void* blocks, int64_t primary,
                          int64_t seq_len, const void* L2, const void* sa,
                          int sa_is64, int64_t sa_intv, const void* keys,
                          int n, int max_steps, void* vals, int vals_is64,
                          void* over, void* stream) {
  FmView f;
  f.blocks = static_cast<const uint32_t*>(blocks);
  f.primary = primary;
  f.seq_len = seq_len;
  for (int c = 0; c < 5; ++c) f.L2[c] = static_cast<const int64_t*>(L2)[c];
  int shift = 0;
  while ((int64_t{1} << shift) < sa_intv) ++shift;
  const int threads = 256;
  if (n > 0)
    sa_walk_kernel<<<(n + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        f, sa, sa_is64, sa_intv - 1, shift,
        static_cast<const int64_t*>(keys), n, max_steps, vals, vals_is64,
        static_cast<uint8_t*>(over));
  return static_cast<int>(cudaGetLastError());
}
#endif
