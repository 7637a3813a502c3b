// K4: symmetric gram S = C^T C of C (K, M), each output tile multiplying
// only the rows of C that touch it.
//
// Replaces the TPU kernel obvi_slam_tpu/ops/syrk_pallas.py::_kernel (entry
// syrk_lower_split, with the mirror_lower epilogue). Plain PyTorch version:
// obvi_slam_tpu_torch/ops/syrk.py::syrk_gram_plain (c.T @ c). The numpy
// model tests/test_torch_kernels.py::syrk_tile_walk_model mirrors the tile
// walk below on the CPU; it checks the wrapper's plan and the index
// arithmetic, not this code, which chip_smoke.py holds against the plain
// version on the card (edge operands included).
//
// Bound on an H100: bytes. C is the slot grid's z (solver/schur.py): a row
// (landmark, block column) holds at most 36 non-zeros (6 slot poses x 6
// components) of M. At the 64-pose window (K = 12288, M = 384, f32) the
// products of the rows' non-zeros are ~1e7 flops, while reading C and
// writing S move ~19.5 MB: ~5.8 us at 3.35 TB/s (C was just written by the
// caller and fits the 50 MB L2). A dense tile walk multiplies zeros: the
// 21 lower 64 x 64 tile pairs see a row non-zero in both of their panels
// for only 8% of (row, pair) combinations.
// Design, three launches on the caller's stream:
//  1. syrk_kernel_mask: one warp per row reads C once with 16-byte loads
//     and writes a bitmask of the 64-column panels where the row has a
//     non-zero (ceil(M / 64) bits in 32-bit words). Where M is not a
//     multiple of the 16-byte vector or C does not start on 16 bytes, this
//     pass and the staging in 2 fall back to 4- or 8-byte accesses.
//  2. syrk_kernel_gram: one block per (lower tile pair, split of 256 rows),
//     1008 blocks at the window's shapes, enough for 132 SMs. A pair's
//     splits lie side by side in the grid and the diagonal pairs come
//     first, so the heaviest tiles of a banded gram start first and spread
//     over many SMs instead of sharing a few. For each
//     chunk of 256 rows the block compacts, in row order, the rows whose
//     mask has both of its panels (warp ballot + prefix sum), stages their
//     two 64-wide panel slices in shared memory with 16-byte cp.async,
//     double-buffered, and accumulates the 64 x 64 tile in registers
//     (4 x 4 per thread, FFMA; DFMA in f64) in ascending row order. A block
//     with no such row writes only its flag; the others write their partial
//     tile to scratch.
//  3. syrk_kernel_reduce: sums the non-empty partials of each tile in split
//     order and writes the tile and its mirror, zeros included.
// Every sum runs in a fixed order, with no atomics, so two launches give
// the same bits. A diagonal tile computes s[i][j] and s[j][i] from the same
// products in the same order, so S is exactly symmetric. Skipping a row
// whose panel is all zero adds nothing for finite data; an Inf or NaN in C
// reaches only the tiles where its row has non-zeros in both panels (the
// plain product also spreads it through 0 * Inf). No TF32 or tensor cores:
// TF32 is the rejected HIGH grade (1.4e-2 step error), and arithmetic is
// not the limit once the zeros are skipped.

#include <cstdint>
#include <cuda_runtime.h>

#include "gram_common.cuh"

namespace {

using namespace gram;

constexpr int kTile = 64;           // output tile edge = panel width
constexpr int kThreads = 256;       // 16 x 16 threads, 4 x 4 outputs each
constexpr int kChunk = 256;         // rows tested per compaction round
constexpr int kMaskRows = 8;        // rows per mask block (a warp per row)
constexpr int kReduceRows = 8;      // tile rows per reduction block
constexpr int kReduceThreads = 128;

__device__ __forceinline__ bool any_nonzero(float4 v) {
  return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
}
__device__ __forceinline__ bool any_nonzero(double2 v) { return v.x != 0.0 || v.y != 0.0; }

// Asynchronous copy of Bytes (4, 8 or 16) from global to shared memory;
// with pred false the destination is zero-filled and nothing is read.
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? Bytes : 0;
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(Bytes), "r"(n));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Pass 1: mask[r * words + w] bit b <=> row r of C has a non-zero in
// columns [64 (32 w + b), 64 (32 w + b) + 64).
template <typename T>
__global__ void __launch_bounds__(kThreads) syrk_kernel_mask(
    int k_rows, int m, int words, bool vec, const T* __restrict__ c,
    uint32_t* __restrict__ mask) {
  using V = typename Vec<T>::type;
  constexpr int kV = Vec<T>::n;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kMaskRows + threadIdx.x / 32;
  if (r >= k_rows) return;
  const T* row = c + static_cast<size_t>(r) * m;
  for (int w = 0; w < words; ++w) {
    const int c0 = w * 32 * kTile, c1 = min(m, c0 + 32 * kTile);
    uint32_t bits = 0;
    if (vec) {
      for (int col = c0 + kV * lane; col < c1; col += kV * 32) {
        const V v = *reinterpret_cast<const V*>(row + col);
        if (any_nonzero(v)) bits |= 1u << ((col - c0) / kTile);
      }
    } else {
      for (int col = c0 + lane; col < c1; col += 32)
        if (row[col] != T(0)) bits |= 1u << ((col - c0) / kTile);
    }
    bits = __reduce_or_sync(kFull, bits);
    if (lane == 0) mask[static_cast<size_t>(r) * words + w] = bits;
  }
}

// Rows per shared-memory stage: 32 in f32, 16 in f64; kBuf stages in
// flight (32 KB of panel slices either way).
template <typename T> constexpr int kStageRows = 128 / static_cast<int>(sizeof(T));
constexpr int kBuf = 2;

// Issue the copies of one stage: the panel slices of rows list[0, n) into
// a[kk][0, 64) (and b, for two panels). Columns past m are zero-filled.
template <typename T, int kPanels>
__device__ __forceinline__ void stage_copy(
    const T* __restrict__ c, int m, bool vec, const int* list, int n, int ca, int cb,
    T (*a)[kTile], T (*b)[kTile]) {
  constexpr int kS = kStageRows<T>;
  if (vec) {
    constexpr int kV = Vec<T>::n, kRow = kTile / kV;  // vectors per panel slice
    for (int e = threadIdx.x; e < kS * kRow * kPanels; e += kThreads) {
      const int kk = e / (kRow * kPanels), pb = (e / kRow) % kPanels, col = (e % kRow) * kV;
      if (kk >= n) continue;
      const int c0 = (pb ? cb : ca) + col;
      const T* src = c + static_cast<size_t>(list[kk]) * m + (c0 < m ? c0 : 0);
      cp_async<16>(pb ? &b[kk][col] : &a[kk][col], src, c0 < m);
    }
  } else {
    for (int e = threadIdx.x; e < kS * kTile * kPanels; e += kThreads) {
      const int kk = e / (kTile * kPanels), pb = (e / kTile) % kPanels, col = e % kTile;
      if (kk >= n) continue;
      const int c0 = (pb ? cb : ca) + col;
      const T* src = c + static_cast<size_t>(list[kk]) * m + (c0 < m ? c0 : 0);
      cp_async<static_cast<int>(sizeof(T))>(pb ? &b[kk][col] : &a[kk][col], src, c0 < m);
    }
  }
}

// Shared memory of a gram block.
template <typename T>
struct GramSmem {
  T a[kBuf][kStageRows<T>][kTile];
  T b[kBuf][kStageRows<T>][kTile];
  int list[kChunk];          // contributing rows of the chunk, in order
  int warp_n[kThreads / 32];
};

// The rows [r_begin, r_end) of tile pair (ti, tj), added into acc (thread
// (ty, tx): tile rows 4 ty .. 4 ty + 3, columns 4 tx .. 4 tx + 3). Returns
// the rows multiplied.
template <typename T, bool kDiag>
__device__ __forceinline__ int gram_rows(
    int ti, int tj, int r_begin, int r_end, int m, int words, bool vec,
    const T* __restrict__ c, const uint32_t* __restrict__ mask, GramSmem<T>& sm,
    T (&acc)[4][4]) {
  constexpr int kS = kStageRows<T>, kPanels = kDiag ? 1 : 2;
  const int ca = ti * kTile, cb = tj * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const uint32_t bit_i = 1u << (ti % 32), bit_j = 1u << (tj % 32);
  int total = 0;
  for (int chunk = r_begin; chunk < r_end; chunk += kChunk) {
    // In-order compaction of this chunk's rows with a non-zero in both panels.
    const int r = chunk + threadIdx.x;
    bool ok = false;
    if (r < r_end) {
      const uint32_t* mr = mask + static_cast<size_t>(r) * words;
      ok = (mr[ti / 32] & bit_i) && (kDiag || (mr[tj / 32] & bit_j));
    }
    int at;
    const int n = compact<kThreads>(ok, &at, sm.warp_n);
    if (ok) sm.list[at] = r;
    __syncthreads();
    total += n;

    // Stage the listed rows' panel slices, kBuf stages in flight, and
    // multiply them in list (= row) order.
    const int stages = (n + kS - 1) / kS;
#pragma unroll
    for (int st = 0; st < kBuf - 1; ++st) {
      if (st < stages)
        stage_copy<T, kPanels>(c, m, vec, sm.list + st * kS, min(kS, n - st * kS), ca, cb,
                               sm.a[st], sm.b[st]);
      cp_async_commit();
    }
    for (int st = 0; st < stages; ++st) {
      const int nx = st + kBuf - 1, buf = st % kBuf;
      if (nx < stages)
        stage_copy<T, kPanels>(c, m, vec, sm.list + nx * kS, min(kS, n - nx * kS), ca, cb,
                               sm.a[nx % kBuf], sm.b[nx % kBuf]);
      cp_async_commit();
      cp_async_wait<kBuf - 1>();
      __syncthreads();
      const T(*ap)[kTile] = sm.a[buf];
      const T(*bp)[kTile] = kDiag ? sm.a[buf] : sm.b[buf];
      const int rows = min(kS, n - st * kS);
#pragma unroll 4
      for (int kk = 0; kk < rows; ++kk) {
        T a[4], b[4];
        load4(&ap[kk][ty * 4], a);
        load4(&bp[kk][tx * 4], b);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmadd(a[u], b[v], acc[u][v]);
      }
      __syncthreads();
    }
  }
  return total;
}

// Pass 2: block (pair, split) accumulates sum over its contributing rows
// of C[r, ti panel]^T C[r, tj panel] into partials[pair][split] (64 x 64,
// row-major), or writes flags[pair][split] = 0 when no row contributes.
template <typename T>
__global__ void __launch_bounds__(kThreads) syrk_kernel_gram(
    int k_rows, int m, int words, int split_rows, int splits, bool vec,
    const T* __restrict__ c, const uint32_t* __restrict__ mask,
    int* __restrict__ flags, T* __restrict__ partials) {
  __shared__ __align__(16) GramSmem<T> sm;
  // A pair's splits lie side by side, and pairs come diagonal first.
  const int split = blockIdx.x;
  int ti, tj;
  diag_pair(blockIdx.y, (m + kTile - 1) / kTile, &ti, &tj);
  const int pair = ti * (ti + 1) / 2 + tj;
  const int r_begin = split * split_rows;
  const int r_end = min(k_rows, r_begin + split_rows);
  T acc[4][4];
  for (int u = 0; u < 4; ++u)
    for (int v = 0; v < 4; ++v) acc[u][v] = T(0);
  const int total =
      ti == tj ? gram_rows<T, true>(ti, tj, r_begin, r_end, m, words, vec, c, mask, sm, acc)
               : gram_rows<T, false>(ti, tj, r_begin, r_end, m, words, vec, c, mask, sm, acc);

  const size_t slot = static_cast<size_t>(pair) * splits + split;
  if (threadIdx.x == 0) flags[slot] = total > 0;
  if (total == 0) return;
  T* out = partials + slot * kTile * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int u = 0; u < 4; ++u) store4(out + (ty * 4 + u) * kTile + tx * 4, acc[u]);
}

// Pass 3: block (pair, slice) sums the flagged partials of tile rows
// [8 slice, 8 slice + 8) in split order and writes them to s and, off the
// diagonal, to the mirror (through shared memory, for coalesced rows).
// Each thread sums 4 consecutive entries with 16-byte loads.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) syrk_kernel_reduce(
    int m, int splits, const int* __restrict__ flags, const T* __restrict__ partials,
    T* __restrict__ s) {
  __shared__ T tile[kReduceRows][kTile + 1];
  __shared__ int list[kReduceThreads];
  __shared__ int warp_n[kReduceThreads / 32];
  const int pair = blockIdx.x, r0 = blockIdx.y * kReduceRows;
  int ti, tj;
  lower_pair(pair, &ti, &tj);
  const int lr = threadIdx.x / (kTile / 4), lc = (threadIdx.x % (kTile / 4)) * 4;
  const int* fl = flags + static_cast<size_t>(pair) * splits;
  const T* base = partials + static_cast<size_t>(pair) * splits * kTile * kTile +
                  (r0 + lr) * kTile + lc;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  for (int s0 = 0; s0 < splits; s0 += kReduceThreads) {
    const int sp = s0 + threadIdx.x;
    const bool ok = sp < splits && fl[sp];
    int at;
    const int n = compact<kReduceThreads>(ok, &at, warp_n);
    if (ok) list[at] = sp;
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      T x[4];
      load4(base + static_cast<size_t>(list[k]) * kTile * kTile, x);
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += x[u];
    }
    __syncthreads();
  }
  const int i = ti * kTile + r0 + lr;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = tj * kTile + lc + u;
    if (i < m && j < m) s[static_cast<size_t>(i) * m + j] = acc[u];
    tile[lr][lc + u] = acc[u];
  }
  if (ti == tj) return;
  __syncthreads();
  constexpr int kPer = kReduceRows * kTile / kReduceThreads;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = threadIdx.x + q * kReduceThreads, mc = e / kReduceRows, mr = e % kReduceRows;
    const int i2 = ti * kTile + r0 + mr, j2 = tj * kTile + mc;
    if (i2 < m && j2 < m) s[static_cast<size_t>(j2) * m + i2] = tile[mr][mc];
  }
}

// Launches the three passes; blocks[0..2] receive the blocks launched for
// mask, gram and reduce (0 for a pass not launched).
template <typename T>
int launch(int k_rows, int m, int words, int split_rows, int splits, const void* c,
           void* mask, void* flags, void* partials, void* s, void* stream, int* blocks) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (m + kTile - 1) / kTile, pairs = tiles * (tiles + 1) / 2;
  // 16-byte paths need every row of C to start on a 16-byte boundary.
  const bool vec = m % Vec<T>::n == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  const T* ct = static_cast<const T*>(c);
  const dim3 mask_grid((k_rows + kMaskRows - 1) / kMaskRows), gram_grid(splits, pairs);
  const dim3 reduce_grid(pairs, kTile / kReduceRows);
  blocks[0] = blocks[1] = blocks[2] = 0;
  if (k_rows > 0) {
    syrk_kernel_mask<T><<<mask_grid, kThreads, 0, st>>>(k_rows, m, words, vec, ct,
                                                        static_cast<uint32_t*>(mask));
    int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    blocks[0] = static_cast<int>(mask_grid.x);
    syrk_kernel_gram<T><<<gram_grid, kThreads, 0, st>>>(
        k_rows, m, words, split_rows, splits, vec, ct, static_cast<const uint32_t*>(mask),
        static_cast<int*>(flags), static_cast<T*>(partials));
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    blocks[1] = static_cast<int>(gram_grid.x * gram_grid.y);
  }
  syrk_kernel_reduce<T><<<reduce_grid, kReduceThreads, 0, st>>>(
      m, k_rows > 0 ? splits : 0, static_cast<const int*>(flags),
      static_cast<const T*>(partials), static_cast<T*>(s));
  const int err = static_cast<int>(cudaGetLastError());
  if (!err) blocks[2] = static_cast<int>(reduce_grid.x * reduce_grid.y);
  return err;
}

}  // namespace

extern "C" int syrk_f32(int k_rows, int m, int words, int split_rows, int splits,
                        const void* c, void* mask, void* flags, void* partials, void* s,
                        void* stream, int* blocks) {
  return launch<float>(k_rows, m, words, split_rows, splits, c, mask, flags, partials, s,
                       stream, blocks);
}

extern "C" int syrk_f64(int k_rows, int m, int words, int split_rows, int splits,
                        const void* c, void* mask, void* flags, void* partials, void* s,
                        void* stream, int* blocks) {
  return launch<double>(k_rows, m, words, split_rows, splits, c, mask, flags, partials, s,
                        stream, blocks);
}
