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
// popcount and the checkpoint sum, on the narrow (n_blocks, 16) table; a
// key past the table gives zeros instead of a read out of bounds.  Plain
// version: ops/fm.py occ4.  It reads a split table (mem --shard-tables)
// through the same fm.cuh row lookup as the superstep.
//
// What bounds them on an H100: one random row per id from device memory
// (or L2, for tables under 50 MB), and the output written once; no
// arithmetic to speak of.  So every warp instruction moves whole rows:
//
// - gather_rows, W % 4 == 0 and 16-byte aligned table and output: a group
//   of G lanes a row (G = W/4 rounded up to 4, 8, 16 or 32: a quarter-warp
//   per 64-byte occ row, a warp per 512-byte wide row), each lane moving
//   16 bytes, so a warp instruction reads 32/G whole rows and writes them
//   as one contiguous run.  A warp takes R rows a group (R = 4 where the
//   launch has enough warps to fill the card, else 1), their ids loaded
//   once, one a lane, and shuffled to the groups; all R rows' loads are
//   issued before the first store.  Rows wider than 128 words loop over
//   their 16-byte columns.  The transposed output goes through a
//   32 x 33-word tile a warp in shared memory: 32 rows are read along
//   their words and written along the output's columns, 128 contiguous
//   bytes a store either way.  Other widths and alignments: the warp's
//   32 rows as one run of words, a word a lane.
// - occ4: a group of 4 lanes a key, written against team.cuh (DevTeam<4>
//   on the card, HostTeam<4> in bm_occ4_host): lane ch loads words
//   4ch..4ch+3 of the row in one 16-byte load (fm.cuh fm_occ_chunk4, as
//   the superstep's fm_occ_chunk does); lanes 0-1 hold the checkpoints,
//   lanes 2-3 count their BWT words' bases; two shuffle steps of a
//   reduce-scatter leave lane c with base c's count, and the group writes
//   its four int64 counts as 32 contiguous bytes (a warp's 8 groups, 8
//   consecutive keys: 256 bytes a store instruction).
//
// g++ builds bm_gather_rows_host and bm_occ4_host from the same source:
// the warps of the card's launch, one after another, their lanes as
// HostTeam arrays (ops/emulate.py, tests/test_torch_kernels_host.py).
#include <cstring>
#include <type_traits>

#include "fm.cuh"
#include "team.cuh"

namespace {

const int64_t kNoL2[5] = {0, 0, 0, 0, 0};  // occ4 reads no L2 nor seq_len
constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 32;          // rows of the transposed gather's tile
constexpr int kFillWarps = 2112;   // 16 warps on each of the 132 SMs

struct V4 {
  int32_t w[4];
};

BM_HD V4 load16(const int32_t* p) {
#ifdef __CUDA_ARCH__
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  return V4{{v.x, v.y, v.z, v.w}};
#else
  V4 v;
  std::memcpy(v.w, p, 16);
  return v;
#endif
}

BM_HD void store16(int32_t* p, const V4& v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<int4*>(p) = make_int4(v.w[0], v.w[1], v.w[2], v.w[3]);
#else
  std::memcpy(p, v.w, 16);
#endif
}

BM_HD bool in_table(int64_t id, int64_t n_rows) {
  return id >= 0 && id < n_rows;
}

// The ids of rows base + lane (-1 past B), one a lane.
template <class TM>
BM_HD void lane_ids(const TM& tm, const int64_t* ids, int64_t B,
                    int64_t base, int n, int64_t (&my)[TM::NL]) {
  for (int l = 0; l < TM::NL; ++l) {
    const int lane = tm.lane(l);
    my[l] = lane < n && base + lane < B ? ids[base + lane] : -1;
  }
}

// One warp of the vector gather: rows base + j * (32 / G) + g for j < R,
// group g = lane / G, each lane the 16-byte columns lane % G + G * i.
template <int G, int R, class TM>
BM_HD void gather_warp_vec(const TM& tm, const int32_t* table,
                           int64_t n_rows, int W, const int64_t* ids,
                           int64_t B, int32_t* out, int64_t base) {
  constexpr int NL = TM::NL;
  constexpr int RPW = 32 / G;   // rows a warp instruction
  static_assert(RPW * R <= 32, "one id a lane");
  const int V = W >> 2;
  int64_t my[NL], id[R][NL];
  lane_ids(tm, ids, B, base, RPW * R, my);
  for (int j = 0; j < R; ++j) {
    int src[NL];
    for (int l = 0; l < NL; ++l) src[l] = j * RPW + tm.lane(l) / G;
    tm.shfl(my, src, id[j]);
  }
  for (int c0 = 0; c0 < V; c0 += G) {
    V4 v[R][NL];
    for (int j = 0; j < R; ++j)
      for (int l = 0; l < NL; ++l) {
        const int c = c0 + tm.lane(l) % G;
        const int64_t row = base + j * RPW + tm.lane(l) / G;
        v[j][l] = V4{{0, 0, 0, 0}};
        if (c < V && row < B && in_table(id[j][l], n_rows))
          v[j][l] = load16(table + id[j][l] * W + 4 * c);
      }
    for (int j = 0; j < R; ++j)
      for (int l = 0; l < NL; ++l) {
        const int c = c0 + tm.lane(l) % G;
        const int64_t row = base + j * RPW + tm.lane(l) / G;
        if (c < V && row < B) store16(out + row * W + 4 * c, v[j][l]);
      }
  }
}

// One warp of the transposed gather: rows base..base+31 through a
// kTile x (kTile + 1) tile, kTile words at a time.
template <class TM>
BM_HD void gather_warp_xpose(const TM& tm, const int32_t* table,
                             int64_t n_rows, int W, const int64_t* ids,
                             int64_t B, int32_t* out, int64_t base,
                             int32_t* tile) {
  constexpr int NL = TM::NL;
  int64_t my[NL];
  lane_ids(tm, ids, B, base, kTile, my);
  const int rows = B - base < kTile ? static_cast<int>(B - base) : kTile;
  for (int c0 = 0; c0 < W; c0 += kTile) {
    for (int r = 0; r < rows; ++r) {
      const int64_t id = tm.bcast(my, r);
      for (int l = 0; l < NL; ++l) {
        const int c = c0 + tm.lane(l);
        tile[r * (kTile + 1) + tm.lane(l)] =
            c < W && in_table(id, n_rows) ? table[id * W + c] : 0;
      }
    }
    tm.sync();
    const int cols = W - c0 < kTile ? W - c0 : kTile;
    for (int c = 0; c < cols; ++c)
      for (int l = 0; l < NL; ++l)
        if (tm.lane(l) < rows)
          out[(c0 + c) * B + base + tm.lane(l)] =
              tile[tm.lane(l) * (kTile + 1) + c];
    tm.sync();
  }
}

// One warp of the word gather (any width and alignment): rows
// base..base+31 as one run of 32 W words of the output, a word a lane.
template <class TM>
BM_HD void gather_warp_words(const TM& tm, const int32_t* table,
                             int64_t n_rows, int W, const int64_t* ids,
                             int64_t B, int32_t* out, int64_t base) {
  constexpr int NL = TM::NL;
  int64_t my[NL];
  lane_ids(tm, ids, B, base, 32, my);
  const int64_t rows = B - base < 32 ? B - base : 32;
  for (int64_t e0 = 0; e0 < rows * W; e0 += 32) {
    int src[NL];
    int64_t id[NL];
    for (int l = 0; l < NL; ++l) {
      const int64_t e = e0 + tm.lane(l);
      src[l] = static_cast<int>((e < rows * W ? e : 0) / W);
    }
    tm.shfl(my, src, id);
    for (int l = 0; l < NL; ++l) {
      const int64_t e = e0 + tm.lane(l);
      if (e >= rows * W) continue;
      const int w = static_cast<int>(e - src[l] * static_cast<int64_t>(W));
      out[base * W + e] = in_table(id[l], n_rows) ? table[id[l] * W + w] : 0;
    }
  }
}

// The launch plan of a gather: the kind of warp and, for the vector one,
// G lanes a row and R rows a group; its warps and the rows each takes.
struct GatherPlan {
  int kind;   // 0 vector, 1 transposed, 2 words
  int G, R;
  int64_t rows_a_warp, warps;
};

GatherPlan gather_plan(int W, int64_t B, int transpose, bool aligned) {
  GatherPlan p{2, 0, 0, 32, 0};
  if (transpose) {
    p.kind = 1;
  } else if (W % 4 == 0 && aligned) {
    const int V = W / 4;
    p.kind = 0;
    p.G = V <= 4 ? 4 : (V <= 8 ? 8 : (V <= 16 ? 16 : 32));
    const int64_t rpw = 32 / p.G;
    p.R = (B + rpw * 4 - 1) / (rpw * 4) >= kFillWarps ? 4 : 1;
    p.rows_a_warp = rpw * p.R;
  }
  p.warps = (B + p.rows_a_warp - 1) / p.rows_a_warp;
  return p;
}

template <int N>
using Ic = std::integral_constant<int, N>;

// fn(Ic<G>, Ic<R>) for the plan's G and R.
template <class Fn>
void with_vec_shape(const GatherPlan& p, Fn fn) {
  auto r = [&](auto g) {
    if (p.R == 4)
      fn(g, Ic<4>{});
    else
      fn(g, Ic<1>{});
  };
  switch (p.G) {
    case 4: r(Ic<4>{}); break;
    case 8: r(Ic<8>{}); break;
    case 16: r(Ic<16>{}); break;
    default: r(Ic<32>{});
  }
}

// occ4 of key k by a group of 4 lanes: lane c's count of base c into
// out[c], zeros for k < 0 and for a key past the table.
template <class TM, class FV>
BM_HD void occ4_group(const TM& tm, const FV& f, int64_t n_blocks,
                      int64_t k, int64_t* out) {
  constexpr int NL = TM::NL;
  const bool in = (k - (k >= f.primary ? 1 : 0)) >> 7 < n_blocks;
  int64_t p[4][NL];
  for (int l = 0; l < NL; ++l) {
    int64_t q[4] = {0, 0, 0, 0};
    if (in) fm_occ_chunk4(f, k, tm.lane(l), q);
    for (int c = 0; c < 4; ++c) p[c][l] = q[c];
  }
  // reduce-scatter, step 1: lane t keeps the two bases (t & 2) | j and
  // sends lane t ^ 2 the other two
  int64_t keep[2][NL], send[2][NL], got[2][NL];
  int src[NL];
  for (int l = 0; l < NL; ++l) {
    const int t = tm.lane(l);
    src[l] = t ^ 2;
    for (int j = 0; j < 2; ++j) {
      keep[j][l] = (t & 2) ? p[2 + j][l] : p[j][l];
      send[j][l] = (t & 2) ? p[j][l] : p[2 + j][l];
    }
  }
  for (int j = 0; j < 2; ++j) tm.shfl(send[j], src, got[j]);
  // step 2: lane t keeps base t and sends lane t ^ 1 the other
  int64_t mine[NL], other[NL], sum[NL];
  for (int l = 0; l < NL; ++l) {
    const int t = tm.lane(l);
    src[l] = t ^ 1;
    mine[l] = (t & 1) ? keep[1][l] + got[1][l] : keep[0][l] + got[0][l];
    other[l] = (t & 1) ? keep[0][l] + got[0][l] : keep[1][l] + got[1][l];
  }
  tm.shfl(other, src, sum);
  for (int l = 0; l < NL; ++l) out[tm.lane(l)] = mine[l] + sum[l];
}

#ifdef __CUDACC__
__device__ __forceinline__ int64_t warp_base(int64_t rows_a_warp) {
  return (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock
          + (threadIdx.x >> 5)) * rows_a_warp;
}

template <int G, int R>
__global__ void gather_vec_kernel(const int32_t* __restrict__ table,
                                  int64_t n_rows, int W,
                                  const int64_t* __restrict__ ids, int64_t B,
                                  int32_t* __restrict__ out) {
  const int64_t base = warp_base(32 / G * R);
  if (base >= B) return;
  gather_warp_vec<G, R>(DevTeam<32>(), table, n_rows, W, ids, B, out, base);
}

__global__ void gather_xpose_kernel(const int32_t* __restrict__ table,
                                    int64_t n_rows, int W,
                                    const int64_t* __restrict__ ids,
                                    int64_t B, int32_t* __restrict__ out) {
  __shared__ int32_t tiles[kWarpsPerBlock][kTile * (kTile + 1)];
  const int64_t base = warp_base(kTile);
  if (base >= B) return;
  gather_warp_xpose(DevTeam<32>(), table, n_rows, W, ids, B, out, base,
                    tiles[threadIdx.x >> 5]);
}

__global__ void gather_words_kernel(const int32_t* __restrict__ table,
                                    int64_t n_rows, int W,
                                    const int64_t* __restrict__ ids,
                                    int64_t B, int32_t* __restrict__ out) {
  const int64_t base = warp_base(32);
  if (base >= B) return;
  gather_warp_words(DevTeam<32>(), table, n_rows, W, ids, B, out, base);
}

template <class FV>
__global__ void occ4_kernel(FV f, int64_t n_blocks,
                            const int64_t* __restrict__ keys, int64_t n,
                            int64_t* __restrict__ out) {
  const int64_t i = (blockIdx.x * static_cast<int64_t>(blockDim.x)
                     + threadIdx.x) >> 2;
  if (i >= n) return;   // uniform in the group of 4
  occ4_group(DevTeam<4>(), f, n_blocks, keys[i], out + i * 4);
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" int bm_gather_rows(const void* table, int64_t n_rows, int W,
                              const void* ids, int64_t B, int transpose,
                              void* out, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(table) % 16 == 0
                       && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const GatherPlan p = gather_plan(W, B, transpose, aligned);
  if (B <= 0 || W <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>(
      (p.warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto t = static_cast<const int32_t*>(table);
  const auto k = static_cast<const int64_t*>(ids);
  const auto o = static_cast<int32_t*>(out);
  if (p.kind == 0)
    with_vec_shape(p, [&](auto g, auto r) {
      gather_vec_kernel<decltype(g)::value, decltype(r)::value>
          <<<blocks, 32 * kWarpsPerBlock, 0, st>>>(t, n_rows, W, k, B, o);
    });
  else if (p.kind == 1)
    gather_xpose_kernel<<<blocks, 32 * kWarpsPerBlock, 0, st>>>(
        t, n_rows, W, k, B, o);
  else
    gather_words_kernel<<<blocks, 32 * kWarpsPerBlock, 0, st>>>(
        t, n_rows, W, k, B, o);
  return static_cast<int>(cudaGetLastError());
}

// occ: the n_parts parts' addresses (a host array; one part is the whole
// table), part_rows the rows of each part but the last.
extern "C" int bm_occ4(const void* const* occ, int n_parts, int64_t part_rows,
                       int64_t n_blocks, int64_t primary, const void* keys,
                       int64_t n, void* out, void* stream) {
  const int threads = 32 * kWarpsPerBlock;   // 64 keys a block
  return with_fm_view(occ, n_parts, part_rows, primary, 0, kNoL2,
                      [&](const auto& f) {
    if (n > 0)
      occ4_kernel<<<static_cast<unsigned>((4 * n + threads - 1) / threads),
                    threads, 0, static_cast<cudaStream_t>(stream)>>>(
          f, n_blocks, static_cast<const int64_t*>(keys), n,
          static_cast<int64_t*>(out));
    return static_cast<int>(cudaGetLastError());
  });
}
#else
// The host emulations: the same arguments on host memory, no stream; the
// card's warps (groups for occ4) one after another.
extern "C" int bm_gather_rows_host(const void* table, int64_t n_rows, int W,
                                   const void* ids, int64_t B, int transpose,
                                   void* out) {
  const bool aligned = reinterpret_cast<uintptr_t>(table) % 16 == 0
                       && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const GatherPlan p = gather_plan(W, B, transpose, aligned);
  if (B <= 0 || W <= 0) return 0;
  const auto t = static_cast<const int32_t*>(table);
  const auto k = static_cast<const int64_t*>(ids);
  const auto o = static_cast<int32_t*>(out);
  const HostTeam<32> tm;
  for (int64_t w = 0; w < p.warps; ++w) {
    const int64_t base = w * p.rows_a_warp;
    if (p.kind == 0) {
      with_vec_shape(p, [&](auto g, auto r) {
        gather_warp_vec<decltype(g)::value, decltype(r)::value>(
            tm, t, n_rows, W, k, B, o, base);
      });
    } else if (p.kind == 1) {
      int32_t tile[kTile * (kTile + 1)];
      gather_warp_xpose(tm, t, n_rows, W, k, B, o, base, tile);
    } else {
      gather_warp_words(tm, t, n_rows, W, k, B, o, base);
    }
  }
  return 0;
}

extern "C" int bm_occ4_host(const void* const* occ, int n_parts,
                            int64_t part_rows, int64_t n_blocks,
                            int64_t primary, const void* keys, int64_t n,
                            void* out) {
  return with_fm_view(occ, n_parts, part_rows, primary, 0, kNoL2,
                      [&](const auto& f) {
    for (int64_t i = 0; i < n; ++i)
      occ4_group(HostTeam<4>(), f, n_blocks,
                 static_cast<const int64_t*>(keys)[i],
                 static_cast<int64_t*>(out) + i * 4);
    return 0;
  });
}

// The part lookup alone (fm.cuh row_at), for its tests: the part and the
// offset in it of each row r[i] of a table cut into n_parts parts of rows
// rows.  Returns kBadParts where make_parts refuses them.
extern "C" int bm_part_of_host(int64_t rows, int n_parts, const void* r,
                               int64_t n, void* part, void* off) {
  const void* base[kMaxParts];
  for (int i = 0; i < kMaxParts; ++i)   // part i at address i << 56
    base[i] = reinterpret_cast<const void*>(static_cast<uintptr_t>(i) << 56);
  Parts p;
  if (!make_parts(&p, base, n_parts, rows)) return kBadParts;
  for (int64_t i = 0; i < n; ++i) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(
        row_at(p, static_cast<const uint64_t*>(r)[i], 1));
    static_cast<int32_t*>(part)[i] = static_cast<int32_t>(at >> 56);
    static_cast<int64_t*>(off)[i] =
        static_cast<int64_t>(at & ((uintptr_t{1} << 56) - 1));
  }
  return 0;
}
#endif
