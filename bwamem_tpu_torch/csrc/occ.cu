// Occ-row gather and occ4 by key.
//
// bm_gather_rows replaces the TPU kernels bwamem_tpu/ops/pallas_occ.py
// _pallas_gather (via gather_rows_pallas: a wave of 512-byte row DMAs,
// 8 occ blocks per row, B a multiple of 8) and bwamem_tpu/ops/
// pallas_onehot.py _run (via gather_rows_onehot: the same rows as a
// one-hot bf16 matmul on the MXU, tables up to 4,096 blocks), and the
// probe kernels of tools/probe_mosaic_features.py (a (1, C) index vector
// gathered from an int32 (4096, 128) table, the output transposed to
// (128, C) in probe a+b).  The wide layout, the multiple-of-8 and 2,048
// paddings and the bf16 planes are Mosaic's; here a row is any width W,
// the ids are int64, any count, and an id outside [0, n_rows) gives a
// zero row.  Plain PyTorch version: ops/occ.py gather_rows_plain.
//
// bm_occ4 replaces the same DMA kernel on its occ4 entry
// (pallas_occ.py occ4_via_pallas): per key, the block gather, the 2-bit
// popcount and the checkpoint sum, on the narrow (n_blocks, 16) table
// through fm_occ4 (fm.cuh), the device function that the superstep and
// the SA walk share; a key past the table gives zeros instead of a read
// out of bounds.  Plain version: ops/fm.py occ4.
//
// What bounds them on an H100: one random 64-byte row per id from device
// memory (or L2, for tables under 50 MB); no arithmetic to speak of.
// Design: one thread per id, 16-byte vector loads and stores where the
// width and the pointers allow it.
#include "fm.cuh"

namespace {

BM_HD void gather_row(const int32_t* table, int64_t n_rows, int W,
                      const int64_t* ids, int64_t B, int transpose,
                      int32_t* out, int64_t b) {
  const int64_t id = ids[b];
  const bool ok = id >= 0 && id < n_rows;
  const int32_t* row = table + (ok ? id : 0) * W;
  for (int w = 0; w < W; ++w) {
    const int32_t v = ok ? row[w] : 0;
    if (transpose)
      out[w * B + b] = v;
    else
      out[b * W + w] = v;
  }
}

BM_HD void occ4_key(const FmView& f, int64_t n_blocks, const int64_t* keys,
                    int64_t* out, int64_t i) {
  const int64_t k = keys[i];
  int64_t cnt[4] = {0, 0, 0, 0};
  if ((k - (k >= f.primary ? 1 : 0)) >> 7 < n_blocks) fm_occ4(f, k, cnt);
  for (int c = 0; c < 4; ++c) out[i * 4 + c] = cnt[c];
}

#ifdef __CUDACC__
__global__ void gather_rows_kernel(const int32_t* __restrict__ table,
                                   int64_t n_rows, int W,
                                   const int64_t* __restrict__ ids,
                                   int64_t B, int transpose, int vec,
                                   int32_t* __restrict__ out) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x)
                    + threadIdx.x;
  if (b >= B) return;
  if (vec) {  // W % 4 == 0, 16-byte aligned table and output
    const int64_t id = ids[b];
    const bool ok = id >= 0 && id < n_rows;
    const int4* src = reinterpret_cast<const int4*>(table
                                                    + (ok ? id : 0) * W);
    int4* dst = reinterpret_cast<int4*>(out + b * W);
    const int4 zero = make_int4(0, 0, 0, 0);
    for (int v = 0; v < W / 4; ++v) dst[v] = ok ? src[v] : zero;
    return;
  }
  gather_row(table, n_rows, W, ids, B, transpose, out, b);
}

__global__ void occ4_kernel(FmView f, int64_t n_blocks,
                            const int64_t* __restrict__ keys, int64_t n,
                            int64_t* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
                    + threadIdx.x;
  if (i < n) occ4_key(f, n_blocks, keys, out, i);
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" int bm_gather_rows(const void* table, int64_t n_rows, int W,
                              const void* ids, int64_t B, int transpose,
                              void* out, void* stream) {
  const int threads = 256;
  const int vec = !transpose && W % 4 == 0
                  && reinterpret_cast<uintptr_t>(table) % 16 == 0
                  && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (B > 0)
    gather_rows_kernel<<<static_cast<unsigned>((B + threads - 1) / threads),
                         threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table), n_rows, W,
        static_cast<const int64_t*>(ids), B, transpose, vec,
        static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bm_occ4(const void* blocks, int64_t n_blocks, int64_t primary,
                       const void* keys, int64_t n, void* out,
                       void* stream) {
  FmView f;
  f.blocks = static_cast<const uint32_t*>(blocks);
  f.primary = primary;
  f.seq_len = 0;
  for (int c = 0; c < 5; ++c) f.L2[c] = 0;  // occ4 reads neither
  const int threads = 256;
  if (n > 0)
    occ4_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                  threads, 0, static_cast<cudaStream_t>(stream)>>>(
        f, n_blocks, static_cast<const int64_t*>(keys), n,
        static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
#endif
