// K1: reprojection residual + Jacobian, one thread per factor, outputs
// staged per block and written back with coalesced 16-byte stores.
//
// Replaces the TPU kernel obvi_slam_tpu/ops/reproj_pallas.py::_kernel
// (entry reproj_residuals_and_jac_pallas). Plain PyTorch version:
// obvi_slam_tpu_torch/factors/reproj_fast.py::reproj_residuals_and_jac_fast.
//
//   p_r = R^T (x - t),  p_c = C_r p_r + C_t,  z = p_c.z (|z| < 1e-300 -> 1e-300)
//   r   = mult * (p_c.xy / z - obs)
//   J_point = dproj C_r R^T,  J_pose = [-J_point | dproj C_r [p_r]x Jr(w)]
//
// Bound on an H100: memory. Each live factor reads 3 int32 indices, a mask
// byte, obs and mult (4 values), gathers a 6-value pose row, a 3-value point
// and a 12-value camera row (the small tables stay in L2) and writes 20
// values: about 110 B in f32 against ~210 flops of the function, below the
// card's ~20 flop/B balance point for f32 CUDA-core math. At the local-BA
// window (~24.6k factors, ~2.7 MB, a 0.8 us byte bound) launch latency and
// one factor's chain of dependent loads dominate. Design: blocks of 64
// threads, so ~385 blocks spread over all 132 SMs; the factor columns are
// read once, coalesced (obs and mult as 2-vectors); R^T and Jr are built
// from the raw pose in registers (~100 flops, factor_common.cuh) instead of
// a pose table built by separate device ops; each thread stages its 20
// outputs in shared memory in the public layout, and the block writes its
// contiguous slices of r, J_pose and J_point with 16-byte stores (the ragged
// last block's tail one value at a time). A masked row stages exact zeros
// and skips the arithmetic. Indices are clamped to their tables, as the
// reference's gathers clamp.

#include <cstdint>
#include <cuda_runtime.h>

#include "factor_common.cuh"

namespace {

constexpr int kThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads) reproj_kernel(
    int n, int n_pose, int n_point, int n_cam,
    const T* __restrict__ poses,      // (P, 6): t | w
    const T* __restrict__ points,     // (M, 3)
    const T* __restrict__ cam_r,      // (C, 3, 3)
    const T* __restrict__ cam_t,      // (C, 3)
    const int32_t* __restrict__ pose_idx,
    const int32_t* __restrict__ point_idx,
    const int32_t* __restrict__ cam_idx,
    const T* __restrict__ obs,        // (F, 2)
    const T* __restrict__ mult,       // (F, 2)
    const uint8_t* __restrict__ mask, // (F,)
    T* __restrict__ r_out,            // (F, 2)
    T* __restrict__ jpose_out,        // (F, 2, 6)
    T* __restrict__ jpoint_out) {     // (F, 2, 3)
  // The block's outputs, in the public array-of-structs order.
  __shared__ __align__(16) T s_r[2 * kThreads];
  __shared__ __align__(16) T s_jp[12 * kThreads];
  __shared__ __align__(16) T s_jx[6 * kThreads];
  const int f0 = blockIdx.x * kThreads;
  const int nf = min(kThreads, n - f0);
  const int i = f0 + threadIdx.x;
  T* ro = s_r + 2 * threadIdx.x;
  T* jp = s_jp + 12 * threadIdx.x;
  T* jx = s_jx + 6 * threadIdx.x;
  if (i < n && !mask[i]) {
    for (int k = 0; k < 2; ++k) ro[k] = T(0);
    for (int k = 0; k < 12; ++k) jp[k] = T(0);
    for (int k = 0; k < 6; ++k) jx[k] = T(0);
  } else if (i < n) {
    const T* pt = poses + 6 * factor::clamp_index(pose_idx[i], n_pose);
    const T* xp = points + 3 * factor::clamp_index(point_idx[i], n_point);
    const int c = factor::clamp_index(cam_idx[i], n_cam);
    const T* a = cam_r + 9 * c;  // C_r, row-major
    const T* ct = cam_t + 3 * c;
    T mx, my, ox, oy;
    factor::load2(mult + 2 * i, &mx, &my);
    factor::load2(obs + 2 * i, &ox, &oy);
    T rt[3][3], g[3][3];  // R^T, Jr
    factor::pose_rotation(pt[3], pt[4], pt[5], rt, g);

    const T d0 = xp[0] - pt[0], d1 = xp[1] - pt[1], d2 = xp[2] - pt[2];
    T pr[3], pc[3];
    for (int k = 0; k < 3; ++k) pr[k] = rt[k][0] * d0 + rt[k][1] * d1 + rt[k][2] * d2;
    for (int k = 0; k < 3; ++k)
      pc[k] = a[3 * k] * pr[0] + a[3 * k + 1] * pr[1] + a[3 * k + 2] * pr[2] + ct[k];
    const T z = fabs(pc[2]) < T(1e-300) ? T(1e-300) : pc[2];  // 0 in f32: no guard
    const T iz = T(1) / z;
    ro[0] = mx * (pc[0] * iz - ox);
    ro[1] = my * (pc[1] * iz - oy);

    // dproj rows scaled by the multiplier; dproj[0][1] = dproj[1][0] = 0.
    const T dp00 = mx * iz, dp02 = -mx * pc[0] * iz * iz;
    const T dp11 = my * iz, dp12 = -my * pc[1] * iz * iz;

    // CR = C_r R^T;  M = C_r [p_r]x;  W = M Jr.
    T cr[9], m[9], w[9];
    for (int r = 0; r < 3; ++r) {
      for (int c2 = 0; c2 < 3; ++c2)
        cr[3 * r + c2] = a[3 * r] * rt[0][c2] + a[3 * r + 1] * rt[1][c2] + a[3 * r + 2] * rt[2][c2];
      m[3 * r + 0] = a[3 * r + 1] * pr[2] - a[3 * r + 2] * pr[1];
      m[3 * r + 1] = a[3 * r + 2] * pr[0] - a[3 * r + 0] * pr[2];
      m[3 * r + 2] = a[3 * r + 0] * pr[1] - a[3 * r + 1] * pr[0];
    }
    for (int r = 0; r < 3; ++r)
      for (int c2 = 0; c2 < 3; ++c2)
        w[3 * r + c2] = m[3 * r] * g[0][c2] + m[3 * r + 1] * g[1][c2] + m[3 * r + 2] * g[2][c2];

    for (int c2 = 0; c2 < 3; ++c2) {
      const T jp0 = dp00 * cr[c2] + dp02 * cr[6 + c2];
      const T jp1 = dp11 * cr[3 + c2] + dp12 * cr[6 + c2];
      const T jw0 = dp00 * w[c2] + dp02 * w[6 + c2];
      const T jw1 = dp11 * w[3 + c2] + dp12 * w[6 + c2];
      jx[c2] = jp0;
      jx[3 + c2] = jp1;
      jp[c2] = -jp0;
      jp[3 + c2] = jw0;
      jp[6 + c2] = -jp1;
      jp[9 + c2] = jw1;
    }
  }
  __syncthreads();
  factor::store_slice(r_out + 2 * f0, s_r, 2 * nf);
  factor::store_slice(jpose_out + 12 * f0, s_jp, 12 * nf);
  factor::store_slice(jpoint_out + 6 * f0, s_jx, 6 * nf);
}

template <typename T>
int launch(int n, int n_pose, int n_point, int n_cam, const void* poses,
           const void* points, const void* cam_r, const void* cam_t, const void* pose_idx,
           const void* point_idx, const void* cam_idx, const void* obs, const void* mult,
           const void* mask, void* r, void* j_pose, void* j_point, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  reproj_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, n_pose, n_point, n_cam, static_cast<const T*>(poses),
      static_cast<const T*>(points), static_cast<const T*>(cam_r),
      static_cast<const T*>(cam_t), static_cast<const int32_t*>(pose_idx),
      static_cast<const int32_t*>(point_idx), static_cast<const int32_t*>(cam_idx),
      static_cast<const T*>(obs), static_cast<const T*>(mult),
      static_cast<const uint8_t*>(mask), static_cast<T*>(r), static_cast<T*>(j_pose),
      static_cast<T*>(j_point));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPROJ_ENTRY(NAME, T)                                                              \
  extern "C" int NAME(int n, int n_pose, int n_point, int n_cam, const void* poses,        \
                      const void* points, const void* cam_r, const void* cam_t,            \
                      const void* pose_idx, const void* point_idx, const void* cam_idx,    \
                      const void* obs, const void* mult, const void* mask, void* r,        \
                      void* j_pose, void* j_point, void* stream) {                         \
    return launch<T>(n, n_pose, n_point, n_cam, poses, points, cam_r, cam_t, pose_idx,     \
                     point_idx, cam_idx, obs, mult, mask, r, j_pose, j_point, stream);     \
  }

REPROJ_ENTRY(reproj_f32, float)
REPROJ_ENTRY(reproj_f64, double)
