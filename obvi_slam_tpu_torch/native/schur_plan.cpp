// Native Schur-plan builder: the host-side graph-builder hot path.
//
// Twin of the numpy implementation in solver/plan.py::_build_pairs (which
// replaces the reference's per-frame Ceres problem mutation,
// object_pose_graph_optimizer.h:991-1155) for the per-window plan
// construction: unique (pose, landmark) pairs, per-landmark cross-pair
// enumeration, and destination dedup — rebuilt every frame as the window
// slides, so it sits on the critical path between the frontend and the
// device solve.
//
// Output ordering contract matches numpy exactly (np.unique lexicographic
// pair order; meshgrid cross order per landmark; stable sort of cross rows by
// destination id) so native and numpy plans are bit-identical and
// interchangeable.
//
// Built with g++ on first use by obvi_slam_tpu_torch/native/__init__.py.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

struct PairPlan {
  int64_t n_factors;
  int64_t n_pairs;
  int64_t n_cross;
  int64_t n_dest;
  int32_t* factor_pair;  // [n_factors] factor row -> pair row
  int32_t* pair_block;   // [n_pairs]
  int32_t* pair_land;    // [n_pairs]
  int32_t* cross_a;      // [n_cross] sorted by destination id (stable)
  int32_t* cross_b;      // [n_cross]
  int32_t* cross_dest;   // [n_cross]
  int32_t* dest_a;       // [n_dest] unique (block_a, block_b), lexicographic
  int32_t* dest_b;       // [n_dest]
};

static int32_t* alloc_i32(size_t n) {
  return static_cast<int32_t*>(std::malloc(sizeof(int32_t) * (n ? n : 1)));
}

int build_pair_plan(const int64_t* block_idx, const int64_t* land_idx,
                    const uint8_t* mask, int64_t n, PairPlan* out) {
  out->n_factors = n;

  // ---- unique (block, land) pairs, lexicographically sorted --------------
  std::vector<int64_t> keys;
  std::vector<int64_t> live_rows;
  keys.reserve(n);
  live_rows.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    keys.push_back((block_idx[i] << 32) | (land_idx[i] & 0xffffffffLL));
    live_rows.push_back(i);
  }
  std::vector<int64_t> sorted_keys(keys);
  std::sort(sorted_keys.begin(), sorted_keys.end());
  sorted_keys.erase(std::unique(sorted_keys.begin(), sorted_keys.end()),
                    sorted_keys.end());
  const int64_t n_pairs = static_cast<int64_t>(sorted_keys.size());
  std::unordered_map<int64_t, int32_t> pair_id;
  pair_id.reserve(n_pairs * 2);
  for (int64_t p = 0; p < n_pairs; ++p) pair_id[sorted_keys[p]] = (int32_t)p;

  out->n_pairs = n_pairs;
  out->factor_pair = alloc_i32(n);
  std::memset(out->factor_pair, 0, sizeof(int32_t) * (n ? n : 1));
  for (size_t k = 0; k < live_rows.size(); ++k) {
    out->factor_pair[live_rows[k]] = pair_id[keys[k]];
  }
  out->pair_block = alloc_i32(n_pairs);
  out->pair_land = alloc_i32(n_pairs);
  for (int64_t p = 0; p < n_pairs; ++p) {
    out->pair_block[p] = (int32_t)(sorted_keys[p] >> 32);
    out->pair_land[p] = (int32_t)(sorted_keys[p] & 0xffffffffLL);
  }

  // ---- cross pairs: all ordered (a, b) within each landmark's pair set ---
  // Pairs are already sorted by (block, land); group by land preserving the
  // numpy ordering (argsort by land, stable => block-sorted within land).
  std::unordered_map<int64_t, std::vector<int32_t>> pairs_by_land;
  pairs_by_land.reserve(n_pairs * 2);
  for (int64_t p = 0; p < n_pairs; ++p) {
    pairs_by_land[out->pair_land[p]].push_back((int32_t)p);
  }
  std::vector<int64_t> lands;
  lands.reserve(pairs_by_land.size());
  for (auto& kv : pairs_by_land) lands.push_back(kv.first);
  std::sort(lands.begin(), lands.end());

  int64_t n_cross = 0;
  for (int64_t l : lands) {
    int64_t g = (int64_t)pairs_by_land[l].size();
    n_cross += g * g;
  }
  out->n_cross = n_cross;
  std::vector<int32_t> ca(n_cross), cb(n_cross);
  {
    int64_t c = 0;
    for (int64_t l : lands) {
      const std::vector<int32_t>& g = pairs_by_land[l];
      for (int32_t a : g)
        for (int32_t b : g) {
          ca[c] = a;
          cb[c] = b;
          ++c;
        }
    }
  }

  // ---- destination dedup: unique (block_a, block_b), cross sorted by dest -
  std::vector<int64_t> dest_keys(n_cross);
  for (int64_t c = 0; c < n_cross; ++c) {
    dest_keys[c] = ((int64_t)out->pair_block[ca[c]] << 32) |
                   (uint32_t)out->pair_block[cb[c]];
  }
  std::vector<int64_t> sorted_dest(dest_keys);
  std::sort(sorted_dest.begin(), sorted_dest.end());
  sorted_dest.erase(std::unique(sorted_dest.begin(), sorted_dest.end()),
                    sorted_dest.end());
  const int64_t n_dest = (int64_t)sorted_dest.size();
  std::unordered_map<int64_t, int32_t> dest_id;
  dest_id.reserve(n_dest * 2);
  for (int64_t d = 0; d < n_dest; ++d) dest_id[sorted_dest[d]] = (int32_t)d;

  // Stable counting sort of cross rows by destination id.
  std::vector<int64_t> counts(n_dest + 1, 0);
  std::vector<int32_t> cd(n_cross);
  for (int64_t c = 0; c < n_cross; ++c) {
    cd[c] = dest_id[dest_keys[c]];
    counts[cd[c] + 1]++;
  }
  for (int64_t d = 0; d < n_dest; ++d) counts[d + 1] += counts[d];
  out->cross_a = alloc_i32(n_cross);
  out->cross_b = alloc_i32(n_cross);
  out->cross_dest = alloc_i32(n_cross);
  {
    std::vector<int64_t> pos(counts.begin(), counts.end() - 1);
    for (int64_t c = 0; c < n_cross; ++c) {
      int64_t at = pos[cd[c]]++;
      out->cross_a[at] = ca[c];
      out->cross_b[at] = cb[c];
      out->cross_dest[at] = cd[c];
    }
  }
  out->n_dest = n_dest;
  out->dest_a = alloc_i32(n_dest);
  out->dest_b = alloc_i32(n_dest);
  for (int64_t d = 0; d < n_dest; ++d) {
    out->dest_a[d] = (int32_t)(sorted_dest[d] >> 32);
    out->dest_b[d] = (int32_t)(sorted_dest[d] & 0xffffffffLL);
  }
  return 0;
}

void free_pair_plan(PairPlan* p) {
  std::free(p->factor_pair);
  std::free(p->pair_block);
  std::free(p->pair_land);
  std::free(p->cross_a);
  std::free(p->cross_b);
  std::free(p->cross_dest);
  std::free(p->dest_a);
  std::free(p->dest_b);
  std::memset(p, 0, sizeof(PairPlan));
}

}  // extern "C"
