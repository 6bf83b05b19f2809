// Host ops of the LiDAR ingest path: PointCloud2 blob decode, voxel-average
// downsampling and an azimuth field-of-view mask, as a C ABI that
// loner_tpu_torch/ops/scan_ops.py loads with ctypes.
//
// The port's copy of loner_tpu/ops/native/scan_ops.cpp, with the same
// arithmetic: host C++, not a device kernel. ops/build.py compiles it with the
// host compiler and the JAX package's flags (-O3 -shared -fPIC -std=c++17, no
// -march=native: that flag lets the compiler contract x*x + y*y + z*z into
// FMAs, and the ranges would then differ from the JAX package's library in
// their last bits). Runs at ingest rate (10 Hz x ~1e5 points): one pass, few
// allocations.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PointCloud2-style blob decode.
//
// Decodes an interleaved binary point blob (point_step-strided records with
// float32 x/y/z at byte offsets ox/oy/oz and an optional timestamp field of
// float32 (t_kind=0), float64 (t_kind=1), or uint32 nanoseconds (t_kind=2) at
// offset ot; t_kind=-1 means no per-point time). Computes unit directions,
// ranges, and timestamps; drops non-finite points and returns below min_range.
// Returns the number of valid points written.
int64_t decode_point_blob(
    const uint8_t* blob, int64_t n_points, int32_t point_step,
    int32_t ox, int32_t oy, int32_t oz,
    int32_t ot, int32_t t_kind,
    float min_range,
    float* dirs_out,      // (3, n) row-major: x row, y row, z row
    float* ranges_out,    // (n,)
    double* times_out) {  // (n,)
  int64_t m = 0;
  for (int64_t i = 0; i < n_points; ++i) {
    const uint8_t* rec = blob + i * point_step;
    float x, y, z;
    std::memcpy(&x, rec + ox, 4);
    std::memcpy(&y, rec + oy, 4);
    std::memcpy(&z, rec + oz, 4);
    float r2 = x * x + y * y + z * z;
    if (!std::isfinite(r2) || r2 <= min_range * min_range) continue;
    float r = std::sqrt(r2);
    float inv = 1.0f / r;
    dirs_out[m] = x * inv;
    dirs_out[n_points + m] = y * inv;
    dirs_out[2 * n_points + m] = z * inv;
    ranges_out[m] = r;
    double t = 0.0;
    if (t_kind == 0) {
      float tf;
      std::memcpy(&tf, rec + ot, 4);
      t = tf;
    } else if (t_kind == 1) {
      std::memcpy(&t, rec + ot, 8);
    } else if (t_kind == 2) {
      uint32_t tn;
      std::memcpy(&tn, rec + ot, 4);
      t = tn * 1e-9;
    } else if (t_kind == 3) {
      // Index mode: emit the pre-filter point index so callers can
      // reconstruct column-derived times after range filtering.
      t = static_cast<double>(i);
    }
    times_out[m] = t;
    ++m;
  }
  return m;
}

// ---------------------------------------------------------------------------
// Voxel-average downsampling (Open3D voxel_down_sample semantics).
// Returns number of output points; caller provides out buffer of size >= n.
int64_t voxel_downsample(
    const float* points,  // (n, 3) row-major
    int64_t n,
    float voxel_size,
    float* out) {         // (>= n_out, 3)
  struct Key {
    int64_t x, y, z;
    bool operator==(const Key& o) const { return x == o.x && y == o.y && z == o.z; }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      // xor-of-primes spatial hash (same family as the field encoding).
      return static_cast<size_t>(k.x * 73856093LL ^ k.y * 19349663LL ^
                                 k.z * 83492791LL);
    }
  };
  std::unordered_map<Key, int64_t, KeyHash> cells;
  cells.reserve(static_cast<size_t>(n));
  std::vector<double> sums;
  std::vector<int32_t> counts;
  const double inv = 1.0 / voxel_size;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = points + 3 * i;
    Key k{static_cast<int64_t>(std::floor(p[0] * inv)),
          static_cast<int64_t>(std::floor(p[1] * inv)),
          static_cast<int64_t>(std::floor(p[2] * inv))};
    auto it = cells.find(k);
    int64_t slot;
    if (it == cells.end()) {
      slot = static_cast<int64_t>(counts.size());
      cells.emplace(k, slot);
      sums.insert(sums.end(), {0.0, 0.0, 0.0});
      counts.push_back(0);
    } else {
      slot = it->second;
    }
    sums[3 * slot] += p[0];
    sums[3 * slot + 1] += p[1];
    sums[3 * slot + 2] += p[2];
    counts[slot] += 1;
  }
  const int64_t n_out = static_cast<int64_t>(counts.size());
  for (int64_t s = 0; s < n_out; ++s) {
    out[3 * s] = static_cast<float>(sums[3 * s] / counts[s]);
    out[3 * s + 1] = static_cast<float>(sums[3 * s + 1] / counts[s]);
    out[3 * s + 2] = static_cast<float>(sums[3 * s + 2] / counts[s]);
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// Azimuth-window FOV mask (cfg/defaults.yaml lidar_fov semantics):
// keep[i] = any(lo_j <= azimuth_deg(p_i) <= hi_j).
void fov_mask(
    const float* dirs,    // (3, n): x row, y row, z row
    int64_t n,
    const float* ranges_deg,  // (2 * n_ranges): lo0, hi0, lo1, hi1, ...
    int32_t n_ranges,
    uint8_t* keep_out) {  // (n,)
  constexpr double kRadToDeg = 57.29577951308232;
  for (int64_t i = 0; i < n; ++i) {
    double az = std::atan2(dirs[n + i], dirs[i]) * kRadToDeg;
    if (az < 0) az += 360.0;
    uint8_t keep = 0;
    for (int32_t j = 0; j < n_ranges; ++j) {
      if (az >= ranges_deg[2 * j] && az <= ranges_deg[2 * j + 1]) {
        keep = 1;
        break;
      }
    }
    keep_out[i] = keep;
  }
}

}  // extern "C"
