// K2: bounding-box (dual-quadric) residual + analytic Jacobian, a half-warp
// of 16 lanes per factor, one lane per Jacobian column.
//
// Replaces the TPU kernel obvi_slam_tpu/ops/bbox_pallas.py::_kernel (entry
// bbox_residuals_and_jac_pallas). Plain PyTorch version:
// obvi_slam_tpu_torch/factors/residuals.py::bbox_residuals_and_jac.
//
//   Rwc = C_r R^T,  A = Rwc Re(yaw),  b = C_r R^T (t_e - t) + C_t
//   q_ij = sum_k A_ik d_k A_jk - b_i b_j,  d_k = (dims_k / 2)^2 + 1e-3
//   sx = sqrt(q13^2 - q11 q33),  sy = sqrt(q23^2 - q22 q33)
//   corners = [q13 + sx, q13 - sx, q23 + sy, q23 - sy] / q33
//   r = sqrt_inf (corners - obs); an inner term <= 0 gives invalid_error in
//   every entry and zero Jacobians.
// The 13 Jacobian columns (ellipsoid t_e, yaw, dims; pose t, w) follow the
// chain of the TPU kernel, with the same guarded sqrt/q33 branches; the
// rotation enters through d(R^T v)/dw = [R^T v]x Jr(w), with R^T and Jr
// built from the raw pose in registers (factor_common.cuh).
//
// Bound on an H100: memory on paper. Each live factor reads 3 int32 indices,
// 4 obs and 16 sqrt_inf values and gathers a 7-value object row, a 6-value
// pose row and a 12-value camera row, and writes 56 values: about 330 B in
// f32 against ~3.4k flops of the chain. At the local-BA window (~380
// factors) the byte bound is ~40 ns, below a kernel launch, so the time is
// launch latency plus one factor's dependency chain. Design: the group of 16
// lanes computes the shared part (pose rotation, A, b, d, the conic and its
// guards) redundantly, with the same loads (one transaction each) and the
// same branch; then lane k < 7 takes J_obj column k, lane 7 + m J_pose column
// m and lane 13 the residual, each one corner derivative and one whitening,
// so the chain is the conic plus one column (~500 flops) and no lane holds
// 13 columns in registers. Each lane writes its 4 values into the factor's
// record in shared memory; the block then writes its factors' slices of the
// three outputs contiguously with 16-byte stores. Masked and invalid rows go
// through the same records.

#include <cstdint>
#include <cuda_runtime.h>

#include "factor_common.cuh"

namespace {

constexpr int kLanes = 16;            // lanes per factor: a half-warp
constexpr int kFactorsPerBlock = 8;
constexpr int kThreads = kLanes * kFactorsPerBlock;
constexpr int kResidualLane = 13;     // lanes 0-6 J_obj, 7-12 J_pose, 13 r

// d(corners) from the dual-conic perturbation (dA columns, db, dd).
template <typename T>
__device__ __forceinline__ void corner_derivative(
    const T ac[3][3], const T b[3], const T d[3], T q11, T q13, T q22, T q23, T q33,
    T sx, T sy, T i33, T inv_sx, T inv_sy, T g33, const T da[3][3], const T db[3],
    const T dd[3], T out[4]) {
  auto term = [&](int i, int j) {
    T s = T(0);
    for (int k = 0; k < 3; ++k) s += (da[k][i] * ac[k][j] + ac[k][i] * da[k][j]) * d[k];
    for (int k = 0; k < 3; ++k) s += ac[k][i] * ac[k][j] * dd[k];
    return s - (db[i] * b[j] + b[i] * db[j]);
  };
  const T dq11 = term(0, 0), dq13 = term(0, 2), dq22 = term(1, 1);
  const T dq23 = term(1, 2), dq33 = term(2, 2);
  const T dsx = (q13 * dq13 - T(0.5) * (dq11 * q33 + q11 * dq33)) * inv_sx;
  const T dsy = (q23 * dq23 - T(0.5) * (dq22 * q33 + q22 * dq33)) * inv_sy;
  const T di33 = -(i33 * i33) * g33 * dq33;
  out[0] = (dq13 + dsx) * i33 + (q13 + sx) * di33;
  out[1] = (dq13 - dsx) * i33 + (q13 - sx) * di33;
  out[2] = (dq23 + dsy) * i33 + (q23 + sy) * di33;
  out[3] = (dq23 - dsy) * i33 + (q23 - sy) * di33;
}

template <typename T>
__device__ __forceinline__ void mat3_vec(const T m[3][3], const T v[3], T out[3]) {
  for (int i = 0; i < 3; ++i) out[i] = m[i][0] * v[0] + m[i][1] * v[1] + m[i][2] * v[2];
}

template <typename T>
__device__ __forceinline__ void cross3(const T a[3], const T b[3], T out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// Column m (0-2, a lane's runtime number) of a 3x3 matrix, by selects, so
// that the matrix stays in registers.
template <typename T>
__device__ __forceinline__ void column(const T m3[3][3], int m, T out[3]) {
  for (int i = 0; i < 3; ++i) out[i] = m == 0 ? m3[i][0] : (m == 1 ? m3[i][1] : m3[i][2]);
}

// The 4 values of one lane of a live factor: lane k < 7 column k of J_obj,
// lane 7 + m column m of J_pose, lanes >= 13 the residual.
template <typename T>
__device__ __forceinline__ void bbox_lane(
    int lane, T invalid_error, const T* __restrict__ e, const T* __restrict__ pose,
    const T* __restrict__ c_r, const T* __restrict__ c_t, const T* __restrict__ obs,
    const T* __restrict__ s_inf, T out[4]) {
  T rt[3][3], jr[3][3], cr[3][3], rwc[3][3];
  factor::pose_rotation(pose[3], pose[4], pose[5], rt, jr);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) cr[i][j] = c_r[3 * i + j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      rwc[i][j] = cr[i][0] * rt[0][j] + cr[i][1] * rt[1][j] + cr[i][2] * rt[2][j];

  const T yaw_c = cos(e[3]), yaw_s = sin(e[3]);
  T ac[3][3], b[3], d[3];  // ac[k][i] = A[i][k]: column k of A
  for (int i = 0; i < 3; ++i) {
    ac[0][i] = yaw_c * rwc[i][0] + yaw_s * rwc[i][1];
    ac[1][i] = -yaw_s * rwc[i][0] + yaw_c * rwc[i][1];
    ac[2][i] = rwc[i][2];
  }
  const T tmt[3] = {e[0] - pose[0], e[1] - pose[1], e[2] - pose[2]};
  T pr[3], cpr[3];
  mat3_vec(rt, tmt, pr);
  mat3_vec(cr, pr, cpr);
  for (int i = 0; i < 3; ++i) b[i] = cpr[i] + c_t[i];
  for (int k = 0; k < 3; ++k) d[k] = (e[4 + k] * T(0.5)) * (e[4 + k] * T(0.5)) + T(1e-3);

  auto q_entry = [&](int i, int j) {
    T s = T(0);
    for (int k = 0; k < 3; ++k) s += ac[k][i] * d[k] * ac[k][j];
    return s - b[i] * b[j];
  };
  const T q11 = q_entry(0, 0), q13 = q_entry(0, 2), q22 = q_entry(1, 1);
  const T q23 = q_entry(1, 2), q33 = q_entry(2, 2);
  const T x_inner = q13 * q13 - q11 * q33;
  const T y_inner = q23 * q23 - q22 * q33;
  if (!(x_inner > T(0) && y_inner > T(0))) {  // uniform over the factor's lanes
    const T v = lane >= kResidualLane ? invalid_error : T(0);
    for (int i = 0; i < 4; ++i) out[i] = v;
    return;
  }
  const T sx = sqrt(x_inner > T(1e-12) ? x_inner : T(1e-12));
  const T sy = sqrt(y_inner > T(1e-12) ? y_inner : T(1e-12));
  const T q33s = fabs(q33) < T(1e-12) ? T(1e-12) : q33;
  const T i33 = T(1) / q33s;
  const T g33 = fabs(q33) >= T(1e-12) ? T(1) : T(0);
  const T inv_sx = (x_inner >= T(1e-12) ? T(1) : T(0)) / sx;
  const T inv_sy = (y_inner >= T(1e-12) ? T(1) : T(0)) / sy;

  // This lane's perturbation of the conic's inputs.
  T da[3][3] = {{T(0), T(0), T(0)}, {T(0), T(0), T(0)}, {T(0), T(0), T(0)}};
  T db[3] = {T(0), T(0), T(0)}, dd[3] = {T(0), T(0), T(0)};
  T sign = T(1);
  if (lane < 3 || (lane >= 7 && lane < 10)) {
    // Ellipsoid centre t_e (object cols 0-2); the pose translation (pose
    // cols 0-2) is its negation.
    column(rwc, lane < 3 ? lane : lane - 7, db);
    sign = lane < 3 ? T(1) : T(-1);
  } else if (lane == 3) {
    // Yaw: dA[:,0] = A[:,1], dA[:,1] = -A[:,0].
    for (int i = 0; i < 3; ++i) {
      da[0][i] = ac[1][i];
      da[1][i] = -ac[0][i];
    }
  } else if (lane < 7) {
    // Dimensions (object cols 4-6): d(d_m)/d(dims_m) = dims_m / 2.
    for (int k = 0; k < 3; ++k) dd[k] = lane - 4 == k ? e[4 + k] * T(0.5) : T(0);
  } else if (lane < kResidualLane) {
    // Pose rotation w_m (pose cols 3-5): dA[:,j] = C_r (U[:,j] x g) and
    // db = C_r (p_r x g), with U = R^T Re and g = Jr[:, m].
    T g[3], tmp[3];
    column(jr, lane - 10, g);
    for (int j = 0; j < 3; ++j) {
      T u[3];  // column j of U
      for (int i = 0; i < 3; ++i)
        u[i] = j == 0 ? yaw_c * rt[i][0] + yaw_s * rt[i][1]
                      : (j == 1 ? -yaw_s * rt[i][0] + yaw_c * rt[i][1] : rt[i][2]);
      cross3(u, g, tmp);
      mat3_vec(cr, tmp, da[j]);
    }
    cross3(pr, g, tmp);
    mat3_vec(cr, tmp, db);
  }
  T dc[4];
  corner_derivative(ac, b, d, q11, q13, q22, q23, q33, sx, sy, i33, inv_sx, inv_sy, g33,
                    da, db, dd, dc);
  if (lane >= kResidualLane) {
    dc[0] = (q13 + sx) * i33 - obs[0];
    dc[1] = (q13 - sx) * i33 - obs[1];
    dc[2] = (q23 + sy) * i33 - obs[2];
    dc[3] = (q23 - sy) * i33 - obs[3];
  }
  for (int i = 0; i < 4; ++i) {
    T s = T(0);
    for (int j = 0; j < 4; ++j) s += s_inf[4 * i + j] * dc[j];
    out[i] = sign * s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bbox_kernel(
    int n, int n_obj, int n_pose, int n_cam, T invalid_error,
    const T* __restrict__ objects,       // (K, 7)
    const T* __restrict__ poses,         // (P, 6): t | w
    const T* __restrict__ cam_r,         // (C, 3, 3)
    const T* __restrict__ cam_t,         // (C, 3)
    const int32_t* __restrict__ obj_idx,
    const int32_t* __restrict__ pose_idx,
    const int32_t* __restrict__ cam_idx,
    const T* __restrict__ rect_corners,  // (B, 4)
    const T* __restrict__ sqrt_inf,      // (B, 4, 4)
    const uint8_t* __restrict__ mask,    // (B,)
    T* __restrict__ r_out,               // (B, 4)
    T* __restrict__ jobj_out,            // (B, 4, 7)
    T* __restrict__ jpose_out) {         // (B, 4, 6)
  // The block's records, in the outputs' own layout.
  __shared__ __align__(16) T s_r[kFactorsPerBlock * 4];
  __shared__ __align__(16) T s_jo[kFactorsPerBlock * 28];
  __shared__ __align__(16) T s_jp[kFactorsPerBlock * 24];
  const int slot = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int f0 = blockIdx.x * kFactorsPerBlock;
  const int nf = min(kFactorsPerBlock, n - f0);
  const int f = f0 + slot;
  if (f < n) {
    T out[4] = {T(0), T(0), T(0), T(0)};
    if (mask[f]) {
      const int c = factor::clamp_index(cam_idx[f], n_cam);
      bbox_lane(lane, invalid_error, objects + 7 * factor::clamp_index(obj_idx[f], n_obj),
                poses + 6 * factor::clamp_index(pose_idx[f], n_pose), cam_r + 9 * c,
                cam_t + 3 * c, rect_corners + 4 * f, sqrt_inf + 16 * f, out);
    }
    if (lane <= kResidualLane) {
      T* rec = lane < 7 ? s_jo + 28 * slot + lane
                        : (lane < kResidualLane ? s_jp + 24 * slot + (lane - 7) : s_r + 4 * slot);
      const int stride = lane < 7 ? 7 : (lane < kResidualLane ? 6 : 1);
      for (int i = 0; i < 4; ++i) rec[stride * i] = out[i];
    }
  }
  __syncthreads();
  factor::store_slice(r_out + 4 * f0, s_r, 4 * nf);
  factor::store_slice(jobj_out + 28 * f0, s_jo, 28 * nf);
  factor::store_slice(jpose_out + 24 * f0, s_jp, 24 * nf);
}

template <typename T>
int launch(int n, int n_obj, int n_pose, int n_cam, double invalid_error,
           const void* objects, const void* poses, const void* cam_r, const void* cam_t,
           const void* obj_idx, const void* pose_idx, const void* cam_idx,
           const void* rect_corners, const void* sqrt_inf, const void* mask,
           void* r, void* j_obj, void* j_pose, void* stream) {
  const int blocks = (n + kFactorsPerBlock - 1) / kFactorsPerBlock;
  bbox_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, n_obj, n_pose, n_cam, static_cast<T>(invalid_error),
      static_cast<const T*>(objects), static_cast<const T*>(poses),
      static_cast<const T*>(cam_r), static_cast<const T*>(cam_t),
      static_cast<const int32_t*>(obj_idx), static_cast<const int32_t*>(pose_idx),
      static_cast<const int32_t*>(cam_idx), static_cast<const T*>(rect_corners),
      static_cast<const T*>(sqrt_inf), static_cast<const uint8_t*>(mask),
      static_cast<T*>(r), static_cast<T*>(j_obj), static_cast<T*>(j_pose));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define BBOX_ENTRY(NAME, T)                                                              \
  extern "C" int NAME(int n, int n_obj, int n_pose, int n_cam, double invalid_error,     \
                      const void* objects, const void* poses, const void* cam_r,         \
                      const void* cam_t, const void* obj_idx, const void* pose_idx,      \
                      const void* cam_idx, const void* rect_corners,                     \
                      const void* sqrt_inf, const void* mask, void* r, void* j_obj,      \
                      void* j_pose, void* stream) {                                      \
    return launch<T>(n, n_obj, n_pose, n_cam, invalid_error, objects, poses, cam_r,      \
                     cam_t, obj_idx, pose_idx, cam_idx, rect_corners, sqrt_inf, mask, r, \
                     j_obj, j_pose, stream);                                             \
  }

BBOX_ENTRY(bbox_f32, float)
BBOX_ENTRY(bbox_f64, double)
