// Helpers shared by the factor kernels K1 (reproj.cu) and K2 (bbox.cu):
// the pose rotation built per factor from the raw pose, and the block's
// staged write-back of its output slices.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace factor {

__device__ __forceinline__ int clamp_index(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// R^T and the right Jacobian Jr of the axis-angle w, with the formulas and
// branch of geometry.exp_so3 / right_jacobian_so3: with S = [w]x,
//   R^T = I - a S + b S^2,  Jr = I - b S + c S^2,
//   a = sin t / t,  b = (1 - cos t) / t^2,  c = (t - sin t) / t^3,
// and the Taylor terms 1 - t^2/6, 1/2 - t^2/24, 1/6 - t^2/120 when
// t^2 < SMALL_ANGLE^2 = 1e-16.
template <typename T>
__device__ __forceinline__ void pose_rotation(T wx, T wy, T wz, T rt[3][3], T jr[3][3]) {
  const T theta2 = wx * wx + wy * wy + wz * wz;
  T a, b, c;
  if (theta2 < T(1e-16)) {
    a = T(1) - theta2 / T(6);
    b = T(0.5) - theta2 / T(24);
    c = T(1) / T(6) - theta2 / T(120);
  } else {
    const T theta = sqrt(theta2);
    const T s = sin(theta);
    a = s / theta;
    b = (T(1) - cos(theta)) / theta2;
    c = (theta - s) / (theta2 * theta);
  }
  const T sk[3][3] = {{T(0), -wz, wy}, {wz, T(0), -wx}, {-wy, wx, T(0)}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const T s2 = sk[i][0] * sk[0][j] + sk[i][1] * sk[1][j] + sk[i][2] * sk[2][j];
      const T id = i == j ? T(1) : T(0);
      rt[i][j] = id - a * sk[i][j] + b * s2;
      jr[i][j] = id - b * sk[i][j] + c * s2;
    }
}

// 16-byte vectors: 4 floats or 2 doubles.
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

// Two consecutive values, with one 8- or 16-byte load where p allows it.
template <typename T>
__device__ __forceinline__ void load2(const T* __restrict__ p, T* x, T* y) {
  if (reinterpret_cast<uintptr_t>(p) % (2 * sizeof(T)) == 0) {
    if constexpr (sizeof(T) == 4) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      *x = v.x; *y = v.y;
    } else {
      const double2 v = *reinterpret_cast<const double2*>(p);
      *x = v.x; *y = v.y;
    }
  } else {
    *x = p[0];
    *y = p[1];
  }
}

// The block writes count staged values (src, shared memory) to dst[0,
// count): 16-byte stores over the whole vectors, neighbouring threads on
// neighbouring addresses, then one value per thread for the ragged tail.
// src and dst must be 16-byte aligned: dst is a block's slice of an output
// the wrapper allocates (torch.empty), at a multiple of 128 bytes. Mirrored
// by stage_store_model in tests/test_torch_kernels.py.
template <typename T>
__device__ __forceinline__ void store_slice(T* __restrict__ dst, const T* src, int count) {
  using V = typename Vec<T>::type;
  constexpr int kVec = Vec<T>::n;
  const int body = count / kVec;
  for (int v = threadIdx.x; v < body; v += blockDim.x)
    reinterpret_cast<V*>(dst)[v] = reinterpret_cast<const V*>(src)[v];
  for (int k = body * kVec + threadIdx.x; k < count; k += blockDim.x) dst[k] = src[k];
}

}  // namespace factor
