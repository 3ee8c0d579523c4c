// Lanes of a thread group, on the card and on the host.
//
// A device function written against a team runs the G lanes of a group
// (G = 4, 8 or 32 consecutive threads of one warp) one lane per thread on
// the card, DevTeam<G>, and all G lanes in one thread on the host,
// HostTeam<G>.  A per-lane value is an array of NL entries (NL = 1 on the
// card, G on the host) indexed by l in [0, NL); tm.lane(l) is that lane's
// index in the group.  A value that every lane of the group holds alike
// (a uniform value) is a plain scalar.  The collectives (broadcast,
// shuffle, ballot, sum, maximum, minimum, prefix maximum) are
// __shfl_sync, __ballot_sync and __reduce_*_sync over the group's lanes on
// the card and loops over the
// arrays on the host, so the same source gives the same results on both.
// Control flow that reaches a collective must be uniform in the group.
// g++ builds the host side: tests/test_torch_kernels_host.py holds each
// kernel's host emulation against its plain PyTorch version.
#pragma once

#include <cstdint>

#ifndef BM_HD
#ifdef __CUDACC__
#define BM_HD __host__ __device__ __forceinline__
#else
#define BM_HD inline
#endif
#endif

BM_HD int bm_clz32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __clz(x);
#else
  return x ? __builtin_clz(x) : 32;
#endif
}

BM_HD int bm_popc32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The highest set bit of a non-zero word.
BM_HD int bm_top_bit(uint32_t x) { return 31 - bm_clz32(x); }

template <class T>
BM_HD T bm_max(T a, T b) {
  return a > b ? a : b;
}

template <class T>
BM_HD T bm_min(T a, T b) {
  return a < b ? a : b;
}

template <int G>
struct HostTeam {
  static constexpr int NL = G;
  static constexpr int kG = G;

  int lane(int l) const { return l; }
  void sync() const {}

  template <class T>
  T bcast(const T (&v)[G], int src) const {
    return v[src];
  }
  // out[l] = v[src[l]]
  template <class T>
  void shfl(const T (&v)[G], const int (&src)[G], T (&out)[G]) const {
    for (int l = 0; l < G; ++l) out[l] = v[src[l]];
  }
  uint32_t ballot(const bool (&p)[G]) const {
    uint32_t r = 0;
    for (int l = 0; l < G; ++l) r |= static_cast<uint32_t>(p[l]) << l;
    return r;
  }
  template <class T>
  T max_all(const T (&v)[G]) const {
    T m = v[0];
    for (int l = 1; l < G; ++l) m = bm_max(m, v[l]);
    return m;
  }
  template <class T>
  T min_all(const T (&v)[G]) const {
    T m = v[0];
    for (int l = 1; l < G; ++l) m = v[l] < m ? v[l] : m;
    return m;
  }
  template <class T>
  T sum_all(const T (&v)[G]) const {
    T s = 0;
    for (int l = 0; l < G; ++l) s += v[l];
    return s;
  }
  // out[l] = the maximum of v over lanes below l; ident for lane 0
  template <class T>
  void scan_max_excl(const T (&v)[G], T ident, T (&out)[G]) const {
    T m = ident;
    for (int l = 0; l < G; ++l) {
      out[l] = m;
      m = bm_max(m, v[l]);
    }
  }
};

#ifdef __CUDACC__
// The card's side.  Its members are __host__ __device__ so that the
// shared device functions (__host__ __device__, for the g++ build) may
// call them; nvcc's host pass sees stubs that nothing calls.
template <int G>
struct DevTeam {
  static_assert(G == 4 || G == 8 || G == 32, "a group is 4, 8 or 32 lanes");
  static constexpr int NL = 1;
  static constexpr int kG = G;
  unsigned mask;  // the group's lanes in the warp
  int base;       // the group's first lane in the warp
  int t;          // this thread's lane in the group

  BM_HD DevTeam() {
#ifdef __CUDA_ARCH__
    const int w = threadIdx.x & 31;
#else
    const int w = 0;
#endif
    base = w & ~(G - 1);
    t = w - base;
    mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << base;
  }
  BM_HD int lane(int) const { return t; }
  BM_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp(mask);
#endif
  }

  template <class T>
  BM_HD T bcast(const T (&v)[1], int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(mask, v[0], src, G);
#else
    return v[0];
#endif
  }
  template <class T>
  BM_HD void shfl(const T (&v)[1], const int (&src)[1], T (&out)[1]) const {
#ifdef __CUDA_ARCH__
    out[0] = __shfl_sync(mask, v[0], src[0], G);
#else
    out[0] = v[0];
#endif
  }
  BM_HD uint32_t ballot(const bool (&p)[1]) const {
#ifdef __CUDA_ARCH__
    return (__ballot_sync(mask, p[0]) & mask) >> base;
#else
    return p[0];
#endif
  }
  // 32-bit maxima and minima: one redux.sync (sm_80 and later)
  BM_HD int32_t max_all(const int32_t (&v)[1]) const {
#ifdef __CUDA_ARCH__
    return __reduce_max_sync(mask, v[0]);
#else
    return v[0];
#endif
  }
  BM_HD int32_t min_all(const int32_t (&v)[1]) const {
#ifdef __CUDA_ARCH__
    return __reduce_min_sync(mask, v[0]);
#else
    return v[0];
#endif
  }
  template <class T>
  BM_HD T sum_all(const T (&v)[1]) const {
    T s = v[0];
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int d = G >> 1; d > 0; d >>= 1)
      s += static_cast<T>(__shfl_xor_sync(mask, s, d, G));
#endif
    return s;
  }
  template <class T>
  BM_HD void scan_max_excl(const T (&v)[1], T ident, T (&out)[1]) const {
    T m = v[0];
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const T y = __shfl_up_sync(mask, m, d, G);
      if (t >= d) m = bm_max(m, y);
    }
    m = __shfl_up_sync(mask, m, 1, G);
#endif
    out[0] = t == 0 ? ident : m;
  }
};
#endif
