// K4: symmetric gram S = C^T C of C (K, M), one block per lower-triangle tile.
//
// Replaces the TPU kernel obvi_slam_tpu/ops/syrk_pallas.py::_kernel (entry
// syrk_lower_split, with the mirror_lower epilogue). Plain PyTorch version:
// obvi_slam_tpu_torch/ops/syrk.py::syrk_gram_plain (c.T @ c).
//
// Bound on an H100: operations. The lower triangle takes K M (M + 1) flops
// (1.8e9 for the 64-pose window's point gram, K = 12288, M = 384) in plain
// FP32 FFMA (FP64 in the double instantiation) against K M + M^2 values of
// bytes (~19 MB in f32): ~27 us of flops at 67 TFLOP/s against ~6 us of
// bytes at 3.35 TB/s. TF32 tensor cores are not used: their 10-bit operands
// are the rejected HIGH grade of the reference (1.4e-2 step error); the
// TPU's bf16 split, its way to f32 accuracy, has no use here.
// Design: the TPU kernel accumulated each output tile over a sequential K
// grid axis. Here each block owns one 64 x 64 tile of the lower triangle and
// loops over all K rows itself, staging 32-row slices of its two column
// panels in shared memory (a diagonal tile stages one): no split-K, no
// atomics, results repeat bit for bit. It writes the tile and its mirror, so
// the whole symmetric S comes out of one launch (no mirror epilogue); a
// diagonal tile computes s[i][j] and s[j][i] from the same products in the
// same order, so S is exactly symmetric. At M = 384 the triangle is 21
// tiles: too few blocks to fill 132 SMs, which a split of K or smaller
// tiles would address in a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kChunk = 32;     // rows of C per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

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
__global__ void __launch_bounds__(kThreads) syrk_kernel(
    int k_rows, int m,
    const T* __restrict__ c,  // (K, M)
    T* __restrict__ s) {      // (M, M)
  __shared__ T a_s[kChunk][kTile];
  __shared__ T b_s[kChunk][kTile];
  int ti, tj;
  lower_tile(blockIdx.x, &ti, &tj);
  const bool diag = ti == tj;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  T acc[4][4];
  for (int u = 0; u < 4; ++u)
    for (int v = 0; v < 4; ++v) acc[u][v] = T(0);

  for (int k0 = 0; k0 < k_rows; k0 += kChunk) {
    for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
      const int kk = e / kTile, col = e % kTile, k = k0 + kk;
      const T* row = c + static_cast<size_t>(k) * m;
      a_s[kk][col] = (k < k_rows && i0 + col < m) ? row[i0 + col] : T(0);
      if (!diag) b_s[kk][col] = (k < k_rows && j0 + col < m) ? row[j0 + col] : T(0);
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

  for (int u = 0; u < 4; ++u) {
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + ty + 16 * u, j = j0 + tx + 16 * v;
      if (i < m && j < m) {
        s[static_cast<size_t>(i) * m + j] = acc[u][v];
        if (!diag) s[static_cast<size_t>(j) * m + i] = acc[u][v];
      }
    }
  }
}

template <typename T>
int launch(int k_rows, int m, const void* c, void* s, void* stream) {
  const int tiles = (m + kTile - 1) / kTile;
  syrk_kernel<T><<<tiles * (tiles + 1) / 2, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      k_rows, m, static_cast<const T*>(c), static_cast<T*>(s));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int syrk_f32(int k_rows, int m, const void* c, void* s, void* stream) {
  return launch<float>(k_rows, m, c, s, stream);
}

extern "C" int syrk_f64(int k_rows, int m, const void* c, void* s, void* stream) {
  return launch<double>(k_rows, m, c, s, stream);
}
