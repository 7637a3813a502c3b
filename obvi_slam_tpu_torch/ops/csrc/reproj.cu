// K1: reprojection residual + Jacobian, one thread per factor.
//
// Replaces the TPU kernel obvi_slam_tpu/ops/reproj_pallas.py::_kernel
// (entry reproj_residuals_and_jac_pallas). Plain PyTorch version:
// obvi_slam_tpu_torch/factors/reproj_fast.py::reproj_residuals_and_jac_fast.
//
//   p_r = R^T (x - t),  p_c = C_r p_r + C_t
//   r   = mult * (p_c.xy / p_c.z - obs)
//   J_point = dproj C_r R^T,  J_pose = [-J_point | dproj C_r [p_r]x Jr(w)]
//
// Bound on an H100: memory. Each live factor reads 3 int32 indices, obs and
// mult (4 values), a 21-value pose row, a 3-value point and a 12-value camera
// row (the small tables stay in L2), and writes 20 values: about 110 B/factor
// in f32 against ~210 flops, below the card's ~20 flop/B balance point for
// f32 CUDA-core math. At the local-BA window (~24.6k factors, ~2.7 MB, a
// 0.8 us byte bound) launch latency dominates.
// Design: the gathers that the TPU kernel left to separate XLA ops (and the
// (40, F) component packing) happen inside the kernel, so one pass reads the
// index columns and writes the public (F,2)/(F,2,6)/(F,2,3) layout directly.
// A masked row writes exact zeros and skips the arithmetic. Indices are
// clamped to their tables, as the reference's gathers clamp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

template <typename T>
__global__ void reproj_kernel(
    int n, int n_pose, int n_point, int n_cam,
    const T* __restrict__ pose_tab,   // (P, 21): t(3) | R^T(9) | Jr(9)
    const T* __restrict__ points,     // (M, 3)
    const T* __restrict__ cam_tab,    // (C, 12): C_r(9) | C_t(3)
    const int32_t* __restrict__ pose_idx,
    const int32_t* __restrict__ point_idx,
    const int32_t* __restrict__ cam_idx,
    const T* __restrict__ obs,        // (F, 2)
    const T* __restrict__ mult,       // (F, 2)
    const uint8_t* __restrict__ mask, // (F,)
    T* __restrict__ r_out,            // (F, 2)
    T* __restrict__ jpose_out,        // (F, 2, 6)
    T* __restrict__ jpoint_out) {     // (F, 2, 3)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T* ro = r_out + 2 * i;
  T* jp = jpose_out + 12 * i;
  T* jx = jpoint_out + 6 * i;
  if (!mask[i]) {
    for (int k = 0; k < 2; ++k) ro[k] = T(0);
    for (int k = 0; k < 12; ++k) jp[k] = T(0);
    for (int k = 0; k < 6; ++k) jx[k] = T(0);
    return;
  }
  const T* pt = pose_tab + 21 * clamp_index(pose_idx[i], n_pose);
  const T* xp = points + 3 * clamp_index(point_idx[i], n_point);
  const T* ct = cam_tab + 12 * clamp_index(cam_idx[i], n_cam);
  const T* rt = pt + 3;   // R^T, row-major
  const T* g = pt + 12;   // Jr, row-major
  const T* a = ct;        // C_r, row-major
  const T mx = mult[2 * i], my = mult[2 * i + 1];

  const T d0 = xp[0] - pt[0], d1 = xp[1] - pt[1], d2 = xp[2] - pt[2];
  T pr[3], pc[3];
  for (int k = 0; k < 3; ++k) pr[k] = rt[3 * k] * d0 + rt[3 * k + 1] * d1 + rt[3 * k + 2] * d2;
  for (int k = 0; k < 3; ++k)
    pc[k] = a[3 * k] * pr[0] + a[3 * k + 1] * pr[1] + a[3 * k + 2] * pr[2] + ct[9 + k];
  const T iz = T(1) / pc[2];
  ro[0] = mx * (pc[0] * iz - obs[2 * i]);
  ro[1] = my * (pc[1] * iz - obs[2 * i + 1]);

  // dproj rows scaled by the multiplier; dproj[0][1] = dproj[1][0] = 0.
  const T dp00 = mx * iz, dp02 = -mx * pc[0] * iz * iz;
  const T dp11 = my * iz, dp12 = -my * pc[1] * iz * iz;

  // CR = C_r R^T;  M = C_r [p_r]x;  W = M Jr.
  T cr[9], m[9], w[9];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c)
      cr[3 * r + c] = a[3 * r] * rt[c] + a[3 * r + 1] * rt[3 + c] + a[3 * r + 2] * rt[6 + c];
    m[3 * r + 0] = a[3 * r + 1] * pr[2] - a[3 * r + 2] * pr[1];
    m[3 * r + 1] = a[3 * r + 2] * pr[0] - a[3 * r + 0] * pr[2];
    m[3 * r + 2] = a[3 * r + 0] * pr[1] - a[3 * r + 1] * pr[0];
  }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      w[3 * r + c] = m[3 * r] * g[c] + m[3 * r + 1] * g[3 + c] + m[3 * r + 2] * g[6 + c];

  for (int c = 0; c < 3; ++c) {
    const T jp0 = dp00 * cr[c] + dp02 * cr[6 + c];
    const T jp1 = dp11 * cr[3 + c] + dp12 * cr[6 + c];
    const T jw0 = dp00 * w[c] + dp02 * w[6 + c];
    const T jw1 = dp11 * w[3 + c] + dp12 * w[6 + c];
    jx[c] = jp0;
    jx[3 + c] = jp1;
    jp[c] = -jp0;
    jp[3 + c] = jw0;
    jp[6 + c] = -jp1;
    jp[9 + c] = jw1;
  }
}

template <typename T>
int launch(int n, int n_pose, int n_point, int n_cam, const void* pose_tab,
           const void* points, const void* cam_tab, const void* pose_idx,
           const void* point_idx, const void* cam_idx, const void* obs,
           const void* mult, const void* mask, void* r, void* j_pose,
           void* j_point, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  reproj_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, n_pose, n_point, n_cam, static_cast<const T*>(pose_tab),
      static_cast<const T*>(points), static_cast<const T*>(cam_tab),
      static_cast<const int32_t*>(pose_idx), static_cast<const int32_t*>(point_idx),
      static_cast<const int32_t*>(cam_idx), static_cast<const T*>(obs),
      static_cast<const T*>(mult), static_cast<const uint8_t*>(mask),
      static_cast<T*>(r), static_cast<T*>(j_pose), static_cast<T*>(j_point));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int reproj_f32(int n, int n_pose, int n_point, int n_cam,
                          const void* pose_tab, const void* points,
                          const void* cam_tab, const void* pose_idx,
                          const void* point_idx, const void* cam_idx,
                          const void* obs, const void* mult, const void* mask,
                          void* r, void* j_pose, void* j_point, void* stream) {
  return launch<float>(n, n_pose, n_point, n_cam, pose_tab, points, cam_tab,
                       pose_idx, point_idx, cam_idx, obs, mult, mask, r, j_pose,
                       j_point, stream);
}

extern "C" int reproj_f64(int n, int n_pose, int n_point, int n_cam,
                          const void* pose_tab, const void* points,
                          const void* cam_tab, const void* pose_idx,
                          const void* point_idx, const void* cam_idx,
                          const void* obs, const void* mult, const void* mask,
                          void* r, void* j_pose, void* j_point, void* stream) {
  return launch<double>(n, n_pose, n_point, n_cam, pose_tab, points, cam_tab,
                        pose_idx, point_idx, cam_idx, obs, mult, mask, r, j_pose,
                        j_point, stream);
}
