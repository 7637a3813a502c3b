// K3: banded z build + group gram, each output tile multiplying only the z
// rows that touch it.
//
// Replaces the TPU kernel obvi_slam_tpu/ops/band_gram_pallas.py::_kernel
// (entry band_zbuild_gram). Plain PyTorch version:
// obvi_slam_tpu_torch/ops/band_gram.py::band_zbuild_gram_plain. The numpy
// model tests/test_torch_kernels.py::band_gram_tile_walk_model mirrors the
// tile walk below on the CPU; it checks the wrapper's plan and the index
// arithmetic, not this code, which chip_smoke.py holds against the plain
// version on the card (edge operands included).
//
// For each group g of the banded point gram (G groups, K = 3 Lg rows each):
//   z[g, k, c*128 + p] = sum over slots s with local_pose[g, k, s] == p of
//                        w_rows[g, k, 6 s + c]  (in slot order; p < 128,
//                        any other local pose is a dead slot)
//   s[g] = z[g]^T z[g]                          (768 x 768, c-major)
//
// Bound on an H100: bytes. Writing z is 47.2 MB of the ~59 MB the call
// must move at 256 poses x 4096 points (G = 4, K = 3840, C = 6, f32):
// ~17.7 us at 3.35 TB/s. A row of z has at most C live local poses (4.8 on
// average) and the band layout keeps them within ~70 consecutive poses, so
// the products the data needs are ~1.6e7 flops, not the dense gram's 9.1e9.
// Design, two launches on the caller's stream:
//  1. band_gram_kernel, with blocks of two roles in one grid:
//     - gram blocks, one per (group, lower pair of 16-pose panels, split of
//       512 rows): 36 x 8 x G. A panel covers 96 columns of s, c*128 + p
//       for 6 components and its 16 poses. For each chunk of 256 rows the
//       block compacts, in row order, the rows with a live slot in both of
//       its panels, reading only local_pose (warp ballot + prefix sum); it
//       builds those rows' 96-wide z slices in shared memory from w_rows
//       (never reading z back; slots are loaded 8 at a time); thread (p, q)
//       then accumulates the 6 x 6 block of pose pair (p, q) with FFMA
//       (DFMA in f64) in ascending row order. Each warp walks only the rows
//       with a slot at one of its two poses p (a ballot); the products it
//       adds for a pose that is not live are exact zeros of z. A block with
//       no such row writes only its flag; the others write their partial
//       96 x 96 tile to scratch.
//     - z blocks: one warp per z row writes the whole row exactly once,
//       zeros included, with 16-byte coalesced stores, after staging the
//       row's slots in shared memory. They overlap the gram blocks'
//       latency-bound work with the kernel's byte floor.
//  2. band_gram_kernel_reduce: sums each tile's flagged partials in split
//     order and writes the tile's c-major entries and, off the diagonal,
//     their mirror, zeros included.
// Every sum runs in a fixed order, with no atomics, so two launches give
// the same bits; z entries are summed over slots in the same order in both
// roles, so s is the gram of the z written. A diagonal tile computes
// s[i][j] and s[j][i] from the same products in the same order, so s comes
// out exactly symmetric. Skipped products are products with an exact zero
// of z (the one-hot plain version multiplies dead slots' w by 0, so a
// non-finite w of a dead slot reaches its z only there). No TF32 or tensor
// cores: TF32 is the rejected HIGH grade (1.4e-2 step error), and
// arithmetic is not the limit once the zeros are skipped.

#include <cstdint>
#include <cuda_runtime.h>

#include "gram_common.cuh"

namespace {

using namespace gram;

constexpr int kWidth = 128;              // local pose window
constexpr int kWband = 6 * kWidth;       // z columns / gram edge
constexpr int kPanel = 16;               // poses per panel
constexpr int kPanels = kWidth / kPanel;
constexpr int kPairs = kPanels * (kPanels + 1) / 2;
constexpr int kCols = 6 * kPanel;        // s columns per panel
constexpr int kThreads = 256;            // gram: thread (p, q) of 16 x 16
constexpr int kChunk = 256;              // rows tested per compaction round
constexpr int kZRows = 32;               // z rows per z block (a warp per row)
constexpr int kReduceThreads = 192;      // 8 entries each of a 16 x 96 slice

static_assert(kThreads == kPanel * kPanel, "one thread per pose pair of a panel pair");

// Rows per shared-memory stage of z slices: 32 in f32, 16 in f64 (24 KB).
template <typename T> constexpr int kStageRows = 128 / static_cast<int>(sizeof(T));

// Slots are read kBatch at a time, all loads issued before any is used.
constexpr int kBatch = 8;

// Bits of the live local poses of one row inside panels pi and pj
// ([16 P, 16 P + 16)).
__device__ __forceinline__ void panel_bits(const int32_t* lrow, int c_slots, int pi, int pj,
                                           uint32_t* bi, uint32_t* bj) {
  uint32_t a = 0, b = 0;
  for (int s0 = 0; s0 < c_slots; s0 += kBatch) {
    int v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = s0 + u < c_slots ? lrow[s0 + u] : -1;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int di = v[u] - pi * kPanel, dj = v[u] - pj * kPanel;
      if (di >= 0 && di < kPanel) a |= 1u << di;
      if (dj >= 0 && dj < kPanel) b |= 1u << dj;
    }
  }
  *bi = a;
  *bj = b;
}

// Shared memory of a gram block.
template <typename T>
struct GramSmem {
  T zs[kStageRows<T>][2 * kCols];  // z slices of a stage's rows
  int list[kChunk];                // contributing rows of the chunk, in order
  uint32_t lmask[kChunk];          // their live poses: panel pi | panel pj << 16
  int warp_n[kThreads / 32];
};

// Rows [r_begin, r_end) of one group (w, lp) for panel pair (pi, pj):
// thread (p, q) accumulates the 6 x 6 block of pose pair (16 pi + p,
// 16 pj + q) into acc. Returns the rows multiplied.
template <typename T, bool kDiag>
__device__ __forceinline__ int gram_rows(
    int pi, int pj, int r_begin, int r_end, int c_slots, const T* __restrict__ w,
    const int32_t* __restrict__ lp, GramSmem<T>& sm, T (&acc)[6][6]) {
  constexpr int kS = kStageRows<T>;
  constexpr int kSegs = kDiag ? 6 : 12;  // (panel, component) segments of a row
  constexpr int kQOff = kDiag ? 0 : kCols;
  const int p = threadIdx.x / kPanel, q = threadIdx.x % kPanel;  // warp w: p = 2w, 2w + 1
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int total = 0;
  for (int chunk = r_begin; chunk < r_end; chunk += kChunk) {
    // In-order compaction of the rows with a live slot in both panels.
    const int r = chunk + threadIdx.x;
    uint32_t bits = 0;
    if (r < r_end) {
      uint32_t bi, bj;
      panel_bits(lp + static_cast<size_t>(r) * c_slots, c_slots, pi, pj, &bi, &bj);
      if (bi && bj) bits = bi | (bj << 16);
    }
    int at;
    const int n = compact<kThreads>(bits != 0, &at, sm.warp_n);
    if (bits) {
      sm.list[at] = r;
      sm.lmask[at] = bits;
    }
    __syncthreads();
    total += n;

    for (int s0 = 0; s0 < n; s0 += kS) {
      const int rows = min(kS, n - s0);
      // z slices of the stage's rows: column sel*96 + c*16 + pl holds
      // z[r, c*128 + 16 P + pl] of panel P = (sel ? pj : pi). One task per
      // (row, panel, component) zeroes its 16 entries and adds the row's
      // slots into them in slot order; a thread's tasks load together.
      constexpr int kTasks = (kS * kSegs + kThreads - 1) / kThreads;
      for (int s1 = 0; s1 < c_slots; s1 += kBatch) {
        int v[kTasks][kBatch];
        T x[kTasks][kBatch];
#pragma unroll
        for (int t = 0; t < kTasks; ++t) {
          const int e = threadIdx.x + t * kThreads, kk = e / kSegs, c = e % 6;
          const bool task = e < rows * kSegs;
          const size_t r2 = task ? sm.list[s0 + kk] : 0;
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const bool in = task && s1 + u < c_slots;
            v[t][u] = in ? lp[r2 * c_slots + s1 + u] : -1;
            x[t][u] = in ? w[(r2 * c_slots + s1 + u) * 6 + c] : T(0);
          }
        }
#pragma unroll
        for (int t = 0; t < kTasks; ++t) {
          const int e = threadIdx.x + t * kThreads, kk = e / kSegs, sel = (e % kSegs) / 6;
          if (e >= rows * kSegs) continue;
          const int p0 = (sel ? pj : pi) * kPanel;
          T* seg = &sm.zs[kk][sel * kCols + (e % 6) * kPanel];
          if (s1 == 0) {
#pragma unroll
            for (int d = 0; d < kPanel; ++d) seg[d] = T(0);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int d = v[t][u] - p0;
            if (d >= 0 && d < kPanel) seg[d] += x[t][u];
          }
        }
      }
      __syncthreads();
      // The stage's rows with a live slot at one of this warp's two poses p,
      // in ascending order (a warp-uniform walk). A thread whose pose p or q
      // is not live in the row adds products with an exact zero of z.
      unsigned act = __ballot_sync(
          kFull, lane < rows && ((sm.lmask[s0 + lane] >> (2 * warp)) & 3u));
#pragma unroll 4
      for (; act; act &= act - 1u) {
        const int kk = __ffs(act) - 1;
        T zi[6], zj[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          zi[c] = sm.zs[kk][c * kPanel + p];
          zj[c] = sm.zs[kk][kQOff + c * kPanel + q];
        }
#pragma unroll
        for (int u = 0; u < 6; ++u)
#pragma unroll
          for (int v = 0; v < 6; ++v) acc[u][v] = fmadd(zi[u], zj[v], acc[u][v]);
      }
      __syncthreads();
    }
  }
  return total;
}

// Gram block b: (group, lower panel pair, split) with the pair fastest.
// Writes flags[g][pair][split] and, if any row contributed, its partial
// tile (tile row c*16 + p, column c'*16 + q).
template <typename T>
__device__ __forceinline__ void gram_block(
    int b, int k_rows, int c_slots, int split_rows, int splits,
    const T* __restrict__ w_rows, const int32_t* __restrict__ local_pose,
    int* __restrict__ flags, T* __restrict__ partials, GramSmem<T>& sm) {
  const int pair = b % kPairs, split = (b / kPairs) % splits, g = b / (kPairs * splits);
  int pi, pj;
  lower_pair(pair, &pi, &pj);
  const T* w = w_rows + static_cast<size_t>(g) * k_rows * 6 * c_slots;
  const int32_t* lp = local_pose + static_cast<size_t>(g) * k_rows * c_slots;
  const int r_begin = split * split_rows;
  const int r_end = min(k_rows, r_begin + split_rows);
  T acc[6][6];
  for (int u = 0; u < 6; ++u)
    for (int v = 0; v < 6; ++v) acc[u][v] = T(0);
  const int total =
      pi == pj ? gram_rows<T, true>(pi, pj, r_begin, r_end, c_slots, w, lp, sm, acc)
               : gram_rows<T, false>(pi, pj, r_begin, r_end, c_slots, w, lp, sm, acc);

  const size_t slot = (static_cast<size_t>(g) * kPairs + pair) * splits + split;
  if (threadIdx.x == 0) flags[slot] = total > 0;
  if (total == 0) return;
  T* out = partials + slot * kCols * kCols;
  const int p = threadIdx.x / kPanel, q = threadIdx.x % kPanel;
  for (int u = 0; u < 6; ++u)
    for (int v = 0; v < 6; ++v) out[(u * kPanel + p) * kCols + v * kPanel + q] = acc[u][v];
}

// One warp per z row, kZRows / 8 rows per warp. Lane l owns local poses
// [kV l + 32 kV h, kV l + 32 kV h + kV) of every component c, i.e. the
// 16-byte vector at column c*128 + kV l + 32 kV h. The warp stages kBatch
// slots of the row (local poses and w) in shared memory with one round of
// loads, then each lane adds the slots into its vectors in slot order.
template <typename T>
__device__ void z_block(int zb, int rows, int c_slots, const T* __restrict__ w_rows,
                        const int32_t* __restrict__ local_pose, T* __restrict__ z) {
  using V = typename Vec<T>::type;
  constexpr int kV = Vec<T>::n;
  constexpr int kHalves = kWidth / (32 * kV);  // 1 in f32, 2 in f64
  __shared__ int zl[kThreads / 32][kBatch];
  __shared__ T zw[kThreads / 32][6 * kBatch];
  const int lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  for (int rr = wp; rr < kZRows; rr += kThreads / 32) {
    const int r = zb * kZRows + rr;  // row of the flattened (G K) rows
    if (r >= rows) return;
    const int32_t* lrow = local_pose + static_cast<size_t>(r) * c_slots;
    const T* wrow = w_rows + static_cast<size_t>(r) * 6 * c_slots;
    T v[kHalves][6][kV];
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int c = 0; c < 6; ++c)
#pragma unroll
        for (int e = 0; e < kV; ++e) v[h][c][e] = T(0);
    for (int s0 = 0; s0 < c_slots; s0 += kBatch) {
      if (lane < kBatch) zl[wp][lane] = s0 + lane < c_slots ? lrow[s0 + lane] : -1;
      for (int e = lane; e < 6 * kBatch; e += 32)
        zw[wp][e] = s0 + e / 6 < c_slots ? wrow[6 * s0 + e] : T(0);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int pose = zl[wp][u];
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          const int d = pose - (kV * lane + 32 * kV * h);
          if (d < 0 || d >= kV) continue;
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            const T x = zw[wp][6 * u + c];
#pragma unroll
            for (int e = 0; e < kV; ++e)
              if (d == e) v[h][c][e] += x;
          }
        }
      }
      __syncwarp();
    }
    V* zrow = reinterpret_cast<V*>(z + static_cast<size_t>(r) * kWband);
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const int vi = (c * kWidth + kV * lane + 32 * kV * h) / kV;
        if constexpr (kV == 4) {
          zrow[vi] = make_float4(v[h][c][0], v[h][c][1], v[h][c][2], v[h][c][3]);
        } else {
          zrow[vi] = make_double2(v[h][c][0], v[h][c][1]);
        }
      }
    }
  }
}

// The first gram_blocks blocks multiply panel pairs; the rest write z.
template <typename T>
__global__ void __launch_bounds__(kThreads) band_gram_kernel(
    int n_group, int k_rows, int c_slots, int split_rows, int splits, int gram_blocks,
    const T* __restrict__ w_rows, const int32_t* __restrict__ local_pose,
    int* __restrict__ flags, T* __restrict__ partials, T* __restrict__ z) {
  __shared__ GramSmem<T> sm;
  const int b = blockIdx.x;
  if (b < gram_blocks) {
    gram_block<T>(b, k_rows, c_slots, split_rows, splits, w_rows, local_pose, flags, partials,
                  sm);
  } else {
    z_block<T>(b - gram_blocks, n_group * k_rows, c_slots, w_rows, local_pose, z);
  }
}

// Block (pair, c, g) sums the flagged partials of tile rows
// [16 c, 16 c + 16) in split order, 8 consecutive entries per thread with
// 16-byte loads; writes them to s[g] at rows c*128 + 16 pi + p, columns
// c'*128 + 16 pj + q, and, off the diagonal, the mirror (through shared
// memory, for coalesced rows).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) band_gram_kernel_reduce(
    int splits, const int* __restrict__ flags, const T* __restrict__ partials,
    T* __restrict__ s) {
  constexpr int kPer = kPanel * kCols / kReduceThreads;  // 8
  static_assert(kPer == 8, "two 4-wide loads per thread, inside one 16-pose run");
  __shared__ T tile[kPanel][kCols + 1];
  __shared__ int list[kReduceThreads];
  __shared__ int warp_n[kReduceThreads / 32];
  const int pair = blockIdx.x, c = blockIdx.y, g = blockIdx.z;
  int pi, pj;
  lower_pair(pair, &pi, &pj);
  const int lr = threadIdx.x / (kCols / kPer), lc = (threadIdx.x % (kCols / kPer)) * kPer;
  const size_t slot0 = (static_cast<size_t>(g) * kPairs + pair) * splits;
  const T* base = partials + slot0 * kCols * kCols + (c * kPanel + lr) * kCols + lc;
  T acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = T(0);
  for (int s0 = 0; s0 < splits; s0 += kReduceThreads) {
    const int sp = s0 + threadIdx.x;
    const bool ok = sp < splits && flags[slot0 + sp];
    int at;
    const int n = compact<kReduceThreads>(ok, &at, warp_n);
    if (ok) list[at] = sp;
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const T* part = base + static_cast<size_t>(list[k]) * kCols * kCols;
      T x[kPer];
      load4(part, x);
      load4(part + 4, x + 4);
#pragma unroll
      for (int u = 0; u < kPer; ++u) acc[u] += x[u];
    }
    __syncthreads();
  }
  T* sg = s + static_cast<size_t>(g) * kWband * kWband;
  const int row0 = c * kWidth + pi * kPanel;
  const int col0 = (lc / kPanel) * kWidth + pj * kPanel + lc % kPanel;
  store4(sg + static_cast<size_t>(row0 + lr) * kWband + col0, acc);
  store4(sg + static_cast<size_t>(row0 + lr) * kWband + col0 + 4, acc + 4);
  if (pi == pj) return;
#pragma unroll
  for (int u = 0; u < kPer; ++u) tile[lr][lc + u] = acc[u];
  __syncthreads();
  // Mirror: slice column mc lands in s row col, columns row0 + m4 .. + 3.
  for (int e = threadIdx.x; e < kCols * kPanel / 4; e += kReduceThreads) {
    const int mc = e / (kPanel / 4), m4 = (e % (kPanel / 4)) * 4;
    const int col = (mc / kPanel) * kWidth + pj * kPanel + mc % kPanel;
    const T v[4] = {tile[m4][mc], tile[m4 + 1][mc], tile[m4 + 2][mc], tile[m4 + 3][mc]};
    store4(sg + static_cast<size_t>(col) * kWband + row0 + m4, v);
  }
}

// Launches both kernels; blocks[0..2] receive the gram blocks and the z
// blocks of band_gram_kernel's grid and the reduction's blocks (0 for a
// kernel not launched).
template <typename T>
int launch(int n_group, int k_rows, int c_slots, int split_rows, int splits,
           const void* w_rows, const void* local_pose, void* flags, void* partials, void* z,
           void* s, void* stream, int* blocks) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gram_blocks = kPairs * splits * n_group;
  const int z_blocks = (n_group * k_rows + kZRows - 1) / kZRows;
  const dim3 reduce_grid(kPairs, 6, n_group);
  blocks[0] = blocks[1] = blocks[2] = 0;
  if (gram_blocks + z_blocks > 0) {
    band_gram_kernel<T><<<gram_blocks + z_blocks, kThreads, 0, st>>>(
        n_group, k_rows, c_slots, split_rows, splits, gram_blocks,
        static_cast<const T*>(w_rows), static_cast<const int32_t*>(local_pose),
        static_cast<int*>(flags), static_cast<T*>(partials), static_cast<T*>(z));
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    blocks[0] = gram_blocks;
    blocks[1] = z_blocks;
  }
  band_gram_kernel_reduce<T><<<reduce_grid, kReduceThreads, 0, st>>>(
      splits, static_cast<const int*>(flags), static_cast<const T*>(partials),
      static_cast<T*>(s));
  const int err = static_cast<int>(cudaGetLastError());
  if (!err) blocks[2] = static_cast<int>(reduce_grid.x * reduce_grid.y * reduce_grid.z);
  return err;
}

}  // namespace

extern "C" int band_gram_f32(int n_group, int k_rows, int c_slots, int split_rows, int splits,
                             const void* w_rows, const void* local_pose, void* flags,
                             void* partials, void* z, void* s, void* stream, int* blocks) {
  return launch<float>(n_group, k_rows, c_slots, split_rows, splits, w_rows, local_pose, flags,
                       partials, z, s, stream, blocks);
}

extern "C" int band_gram_f64(int n_group, int k_rows, int c_slots, int split_rows, int splits,
                             const void* w_rows, const void* local_pose, void* flags,
                             void* partials, void* z, void* s, void* stream, int* blocks) {
  return launch<double>(n_group, k_rows, c_slots, split_rows, splits, w_rows, local_pose, flags,
                        partials, z, s, stream, blocks);
}
