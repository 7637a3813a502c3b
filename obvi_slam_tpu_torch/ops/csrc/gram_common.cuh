// Helpers shared by the gram kernels K3 (band_gram.cu) and K4 (syrk.cu).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gram {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }

// Lower pair index t -> (i, j), i >= j, row by row (ops/_gram.py::lower_pair).
__device__ __forceinline__ void lower_pair(int t, int* i_out, int* j_out) {
  int i = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  *i_out = i;
  *j_out = t - i * (i + 1) / 2;
}

// Pair rank t in diagonal-first order (i - j = 0, 1, ...) of the lower
// triangle of an n x n grid of tiles -> (i, j) (ops/_gram.py::diag_pair).
__device__ __forceinline__ void diag_pair(int t, int n, int* i_out, int* j_out) {
  int d = 0;
  while (t >= n - d) {
    t -= n - d;
    ++d;
  }
  *j_out = t;
  *i_out = t + d;
}

// 16-byte vectors: 4 floats or 2 doubles.
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

// In-order compaction across a block of kBlock threads: returns how many
// threads passed ok and sets *at, for such a thread, to the number of them
// before it in thread order (warp ballot + prefix over the warps). The
// caller writes its item at *at and synchronises before reading the list.
template <int kBlock>
__device__ __forceinline__ int compact(bool ok, int* at, int* warp_n) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned ballot = __ballot_sync(kFull, ok);
  if (lane == 0) warp_n[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, n = 0;
  for (int w = 0; w < kBlock / 32; ++w) {
    base += w < warp ? warp_n[w] : 0;
    n += warp_n[w];
  }
  *at = base + __popc(ballot & ((1u << lane) - 1u));
  return n;
}

// Four consecutive values with 16-byte accesses (p 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load4(const T* p, T out[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    const double2 u = *reinterpret_cast<const double2*>(p);
    const double2 v = *reinterpret_cast<const double2*>(p + 2);
    out[0] = u.x; out[1] = u.y; out[2] = v.x; out[3] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const T in[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(in[0], in[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(in[2], in[3]);
  }
}

}  // namespace gram
