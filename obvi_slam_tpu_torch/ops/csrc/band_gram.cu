// K3: banded z build + group gram, one block per lower-triangle output tile.
//
// Replaces the TPU kernel obvi_slam_tpu/ops/band_gram_pallas.py::_kernel
// (entry band_zbuild_gram). Plain PyTorch version:
// obvi_slam_tpu_torch/ops/band_gram.py::band_zbuild_gram_plain.
//
// For each group g of the banded point gram (G groups, K = 3 Lg rows each):
//   z[g, k, c*128 + p] = sum over slots s with local_pose[g, k, s] == p of
//                        w_rows[g, k, 6 s + c]          (p < 128; dead = 128)
//   s[g] = z[g]^T z[g]                                  (768 x 768, c-major)
//
// Bound on an H100: operations. The dense gram does G K 768 769 flops (about
// 9.1e9 at 256 poses x 4096 points, G = 4, K = 3840) on CUDA cores in plain
// FP32 FFMA (FP64 in the double instantiation), against ~59 MB of bytes
// (inputs read once, z and s written once): ~135 us of flops at 67 TFLOP/s
// against ~18 us of bytes at 3.35 TB/s.
// TF32 tensor cores are not used: their 10-bit operands are the rejected
// HIGH grade of the reference (1.4e-2 step error).
// Design: the TPU kernel walked K sequentially and carried the gram in VMEM;
// here blocks run in parallel, so each block owns one 64 x 64 output tile of
// one group's gram (78 lower-triangle tiles x G groups) and loops over all K
// rows itself: no split-K, no atomics, and f32 results repeat bit for bit
// from run to run. Each block builds its two z column panels in shared memory
// straight from w_rows and local_pose, one (row, column) entry per thread
// summing its slots in slot order, so z is never read back from device
// memory. The diagonal-tile blocks also store their panel: the 12 diagonal
// tiles of a group cover its 768 z columns once. Strictly-lower tiles are
// mirrored on store, and a diagonal tile computes s[i][j] and s[j][i] with
// the same products in the same order, so s comes out exactly symmetric.
// The dense contraction multiplies mostly zeros (each z row has at most C
// non-zeros per component block); skipping them is work for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 128;           // local pose window
constexpr int kWband = 6 * kWidth;    // z columns / gram edge
constexpr int kTile = 64;             // output tile edge
constexpr int kTiles = kWband / kTile;
constexpr int kLowerTiles = kTiles * (kTiles + 1) / 2;
constexpr int kChunk = 32;            // z rows per shared-memory stage
constexpr int kThreads = 256;         // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }

// Lower-triangle tile index t -> (ti, tj), ti >= tj, row by row.
__device__ __forceinline__ void lower_tile(int t, int* ti, int* tj) {
  int i = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  *ti = i;
  *tj = t - i * (i + 1) / 2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) band_gram_kernel(
    int k_rows, int c_slots,
    const T* __restrict__ w_rows,          // (G, K, 6 C)
    const int32_t* __restrict__ local_pose,  // (G, K, C)
    T* __restrict__ z,                     // (G, K, 768)
    T* __restrict__ s) {                   // (G, 768, 768)
  __shared__ T a_s[kChunk][kTile];
  __shared__ T b_s[kChunk][kTile];
  const int g = blockIdx.y;
  int ti, tj;
  lower_tile(blockIdx.x, &ti, &tj);
  const bool diag = ti == tj;
  // Panel A is z column block ti: component ti / 2, local poses from pa.
  const int ca = ti / 2, pa = (ti % 2) * kTile;
  const int cb = tj / 2, pb = (tj % 2) * kTile;
  const T* w = w_rows + static_cast<size_t>(g) * k_rows * 6 * c_slots;
  const int32_t* lp = local_pose + static_cast<size_t>(g) * k_rows * c_slots;
  T* zg = z + static_cast<size_t>(g) * k_rows * kWband;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  T acc[4][4];
  for (int u = 0; u < 4; ++u)
    for (int v = 0; v < 4; ++v) acc[u][v] = T(0);

  for (int k0 = 0; k0 < k_rows; k0 += kChunk) {
    for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
      const int kk = e / kTile, col = e % kTile, k = k0 + kk;
      T va = T(0), vb = T(0);
      if (k < k_rows) {
        const int32_t* lrow = lp + static_cast<size_t>(k) * c_slots;
        const T* wrow = w + static_cast<size_t>(k) * 6 * c_slots;
        for (int sl = 0; sl < c_slots; ++sl) {
          const int p = lrow[sl];
          if (p == pa + col) va += wrow[6 * sl + ca];
          if (!diag && p == pb + col) vb += wrow[6 * sl + cb];
        }
        if (diag) zg[static_cast<size_t>(k) * kWband + ti * kTile + col] = va;
      }
      a_s[kk][col] = va;
      b_s[kk][col] = vb;
    }
    __syncthreads();
    const T(*bp)[kTile] = diag ? a_s : b_s;
#pragma unroll 4
    for (int kk = 0; kk < kChunk; ++kk) {
      T a[4], b[4];
      for (int u = 0; u < 4; ++u) {
        a[u] = a_s[kk][ty + 16 * u];
        b[u] = bp[kk][tx + 16 * u];
      }
      for (int u = 0; u < 4; ++u)
        for (int v = 0; v < 4; ++v) acc[u][v] = fmadd(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }

  T* sg = s + static_cast<size_t>(g) * kWband * kWband;
  for (int u = 0; u < 4; ++u) {
    for (int v = 0; v < 4; ++v) {
      const int i = ti * kTile + ty + 16 * u, j = tj * kTile + tx + 16 * v;
      sg[static_cast<size_t>(i) * kWband + j] = acc[u][v];
      if (!diag) sg[static_cast<size_t>(j) * kWband + i] = acc[u][v];
    }
  }
}

template <typename T>
int launch(int n_group, int k_rows, int c_slots, const void* w_rows,
           const void* local_pose, void* z, void* s, void* stream) {
  const dim3 grid(kLowerTiles, n_group);
  band_gram_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      k_rows, c_slots, static_cast<const T*>(w_rows),
      static_cast<const int32_t*>(local_pose), static_cast<T*>(z), static_cast<T*>(s));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int band_gram_f32(int n_group, int k_rows, int c_slots, const void* w_rows,
                             const void* local_pose, void* z, void* s, void* stream) {
  return launch<float>(n_group, k_rows, c_slots, w_rows, local_pose, z, s, stream);
}

extern "C" int band_gram_f64(int n_group, int k_rows, int c_slots, const void* w_rows,
                             const void* local_pose, void* z, void* s, void* stream) {
  return launch<double>(n_group, k_rows, c_slots, w_rows, local_pose, z, s, stream);
}
