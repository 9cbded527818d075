// Host-side voxel-grid subsampling for one-time dataset preprocessing: the
// port's copy of the repository's csrc/grid_subsample.cpp, the same code, so
// that both give the same bits.
//
// Per voxel: barycentre of the points, mean of the features, majority label
// (the reference's grid_subsampling.cpp semantics), as a flat-hash
// accumulator with a C ABI for ctypes. Voxels are emitted in ascending
// voxel-hash order, so results are deterministic; native.py holds the numpy
// twin of each entry.
//
// Built by kernels/build.py::build_host with the host compiler (not nvcc)
// into _build/<hash>/libcbl_native.so.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Acc {
  double px = 0, py = 0, pz = 0;
  double cnt = 0;
  std::vector<double> feat;
  std::vector<int32_t> votes;
};

}  // namespace

extern "C" {

// Returns the number of occupied voxels written (<= max_out), or -1 on
// overflow (more voxels than max_out).
//
// points   [n, 3] float32
// features [n, fdim] float32 (fdim may be 0 → ignored)
// labels   [n] int32 (may be null → ignored; negatives ignored in voting)
// cell     voxel edge length (the reference's sampleDl)
// out_*    caller-allocated buffers of capacity max_out
int64_t cbl_grid_subsample(const float* points, const float* features,
                           const int32_t* labels, int64_t n, int32_t fdim,
                           int32_t num_classes, float cell, float* out_points,
                           float* out_features, int32_t* out_labels,
                           int64_t max_out) {
  if (n <= 0 || cell <= 0) return 0;

  // origin at the min corner, like the reference
  float minx = points[0], miny = points[1], minz = points[2];
  for (int64_t i = 1; i < n; ++i) {
    minx = std::min(minx, points[3 * i + 0]);
    miny = std::min(miny, points[3 * i + 1]);
    minz = std::min(minz, points[3 * i + 2]);
  }

  constexpr uint64_t GRID = 1 << 21;  // 2M cells per axis
  std::unordered_map<uint64_t, Acc> voxels;
  voxels.reserve(static_cast<size_t>(n) / 4 + 16);

  for (int64_t i = 0; i < n; ++i) {
    const float x = points[3 * i + 0], y = points[3 * i + 1],
                z = points[3 * i + 2];
    uint64_t vx = static_cast<uint64_t>(std::floor((x - minx) / cell));
    uint64_t vy = static_cast<uint64_t>(std::floor((y - miny) / cell));
    uint64_t vz = static_cast<uint64_t>(std::floor((z - minz) / cell));
    uint64_t key = (vx * GRID + vy) * GRID + vz;

    Acc& a = voxels[key];
    if (a.feat.empty() && fdim > 0) a.feat.assign(fdim, 0.0);
    if (a.votes.empty() && labels && num_classes > 0)
      a.votes.assign(num_classes, 0);
    a.px += x;
    a.py += y;
    a.pz += z;
    a.cnt += 1;
    if (fdim > 0)
      for (int32_t d = 0; d < fdim; ++d)
        a.feat[d] += features[static_cast<int64_t>(fdim) * i + d];
    if (labels && num_classes > 0) {
      int32_t l = labels[i];
      if (l >= 0 && l < num_classes) a.votes[l] += 1;
    }
  }

  if (static_cast<int64_t>(voxels.size()) > max_out) return -1;

  std::vector<std::pair<uint64_t, const Acc*>> order;
  order.reserve(voxels.size());
  for (const auto& kv : voxels) order.emplace_back(kv.first, &kv.second);
  std::sort(order.begin(), order.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });

  int64_t m = 0;
  for (const auto& [key, a] : order) {
    out_points[3 * m + 0] = static_cast<float>(a->px / a->cnt);
    out_points[3 * m + 1] = static_cast<float>(a->py / a->cnt);
    out_points[3 * m + 2] = static_cast<float>(a->pz / a->cnt);
    if (fdim > 0)
      for (int32_t d = 0; d < fdim; ++d)
        out_features[static_cast<int64_t>(fdim) * m + d] =
            static_cast<float>(a->feat[d] / a->cnt);
    if (out_labels) {
      if (!a->votes.empty()) {
        int32_t best = 0;
        for (int32_t c = 1; c < num_classes; ++c)
          if (a->votes[c] > a->votes[best]) best = c;
        out_labels[m] = a->votes[best] > 0 ? best : -1;
      } else {
        out_labels[m] = -1;
      }
    }
    ++m;
  }
  return m;
}

// Train-mode voxelize: pick ONE member point index per occupied voxel
// (pytorch/util/voxelize.py mode 0), deterministic given `salt`.
// Returns count or -1 on overflow.
int64_t cbl_voxel_pick(const float* points, int64_t n, float cell,
                       uint64_t salt, int64_t* out_indices, int64_t max_out) {
  if (n <= 0 || cell <= 0) return 0;
  float minx = points[0], miny = points[1], minz = points[2];
  for (int64_t i = 1; i < n; ++i) {
    minx = std::min(minx, points[3 * i + 0]);
    miny = std::min(miny, points[3 * i + 1]);
    minz = std::min(minz, points[3 * i + 2]);
  }
  constexpr uint64_t GRID = 1 << 21;
  // keep, per voxel, the member with the smallest mixed hash → a uniform
  // pseudo-random pick that is reproducible from `salt`
  std::unordered_map<uint64_t, std::pair<uint64_t, int64_t>> best;
  best.reserve(static_cast<size_t>(n) / 4 + 16);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t vx =
        static_cast<uint64_t>(std::floor((points[3 * i] - minx) / cell));
    uint64_t vy =
        static_cast<uint64_t>(std::floor((points[3 * i + 1] - miny) / cell));
    uint64_t vz =
        static_cast<uint64_t>(std::floor((points[3 * i + 2] - minz) / cell));
    uint64_t key = (vx * GRID + vy) * GRID + vz;
    uint64_t h = (static_cast<uint64_t>(i) + salt) * 0x9E3779B97F4A7C15ull;
    h ^= h >> 29;
    auto it = best.find(key);
    if (it == best.end() || h < it->second.first)
      best[key] = {h, i};
  }
  if (static_cast<int64_t>(best.size()) > max_out) return -1;
  int64_t m = 0;
  for (const auto& kv : best) out_indices[m++] = kv.second.second;
  std::sort(out_indices, out_indices + m);
  return m;
}

}  // extern "C"
