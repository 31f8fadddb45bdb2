// Copy of csrc/pcrl_native.cpp for the PyTorch port, which imports nothing
// of pointcloud_rl_tpu.
//
// Host-side native kernels of the observation pipeline, exposed through
// ctypes:
//
//   * unproject_depth: depth image -> camera-frame xyz, rotated into the
//     world orientation, with optional z offset (DMCEnv.get_xyz semantics).
//   * ground_body_split_sample: the DMC pointcloud sampler -- depth filter,
//     ground/body split by base-height epsilon, per-group random sample
//     with pad-by-tiling (dm_control_utils.py:349-420 semantics).
//   * seg_balanced_sample: the ManiSkill pcd_base sampler -- guaranteed
//     minimum per segmentation mask, proportional foreground split,
//     background fill, pad-by-tiling (observation_process.py:29-70).
//
// RNG: xorshift128+ seeded per call; deterministic per seed (the numpy and
// native paths are individually deterministic, not bit-identical to each
// other).
//
// Build: g++ -O3 -shared -fPIC pcrl_native.cpp -o libpcrl_native.so (ops/build.py)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct XorShift128 {
  uint64_t s0, s1;
  explicit XorShift128(uint64_t seed) {
    // splitmix64 expansion of the seed
    auto next = [&seed]() {
      seed += 0x9E3779B97f4A7C15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      return z ^ (z >> 31);
    };
    s0 = next();
    s1 = next();
  }
  uint64_t next() {
    uint64_t x = s0;
    const uint64_t y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // uniform integer in [0, n)
  uint64_t below(uint64_t n) { return n ? next() % n : 0; }
};

// Fisher-Yates partial shuffle: place a random sample of size k at the front.
void partial_shuffle(std::vector<int32_t>& idx, size_t k, XorShift128& rng) {
  const size_t n = idx.size();
  k = std::min(k, n);
  for (size_t i = 0; i < k; ++i) {
    size_t j = i + rng.below(n - i);
    std::swap(idx[i], idx[j]);
  }
}

// sample_and_pad semantics (reference array_ops.py:969): random subset of
// size `num` when n > num, tiled repetition when n < num.
void sample_and_pad(const std::vector<int32_t>& pool, size_t num,
                    XorShift128& rng, std::vector<int32_t>& out) {
  out.clear();
  out.reserve(num);
  const size_t n = pool.size();
  if (n == 0) {
    out.assign(num, 0);
    return;
  }
  if (n >= num) {
    std::vector<int32_t> tmp(pool);
    partial_shuffle(tmp, num, rng);
    out.assign(tmp.begin(), tmp.begin() + num);
  } else {
    for (size_t i = 0; i < num; ++i) out.push_back(pool[i % n]);
  }
}

}  // namespace

extern "C" {

// depth [h*w] row-major -> xyz [h*w*3]:
// xyz = ((u+.5, v+.5, 1) @ inv_K^T) * depth, then rotated by cam_rot (3x3,
// row-major, applied as x' = R x) with z_offset added to the last axis.
void unproject_depth(const float* depth, int32_t h, int32_t w,
                     const double* inv_k, const double* cam_rot,
                     float z_offset, float* out_xyz) {
  for (int32_t v = 0; v < h; ++v) {
    for (int32_t u = 0; u < w; ++u) {
      const double uu = u + 0.5, vv = v + 0.5;
      // cam = inv_K @ (uu, vv, 1)
      const double cx = inv_k[0] * uu + inv_k[1] * vv + inv_k[2];
      const double cy = inv_k[3] * uu + inv_k[4] * vv + inv_k[5];
      const double cz = inv_k[6] * uu + inv_k[7] * vv + inv_k[8];
      const double d = depth[v * w + u];
      const double px = cx * d, py = cy * d, pz = cz * d;
      float* o = out_xyz + (v * w + u) * 3;
      o[0] = static_cast<float>(cam_rot[0] * px + cam_rot[1] * py + cam_rot[2] * pz);
      o[1] = static_cast<float>(cam_rot[3] * px + cam_rot[4] * py + cam_rot[5] * pz);
      o[2] = static_cast<float>(cam_rot[6] * px + cam_rot[7] * py + cam_rot[8] * pz + z_offset);
    }
  }
}

// DMC pointcloud sampler. Inputs: xyz [n,3], rgb [n,3] (uint8), validity via
// depth <= max_depth already applied by the caller passing only valid points
// OR using the `valid` mask here. Outputs exactly n_body + n_ground points.
// Returns the number of valid input points considered.
int32_t ground_body_split_sample(const float* xyz, const uint8_t* rgb,
                                 const uint8_t* valid, int32_t n,
                                 float ground_eps, float fix_base_z,
                                 int32_t use_fix_base_z, int32_t n_body,
                                 int32_t n_ground, uint64_t seed,
                                 float* out_xyz, uint8_t* out_rgb) {
  XorShift128 rng(seed);
  std::vector<int32_t> ground, body;
  ground.reserve(n);
  body.reserve(n);
  float base_z = use_fix_base_z ? fix_base_z : 3.4e38f;
  int32_t n_valid = 0;
  if (!use_fix_base_z) {
    for (int32_t i = 0; i < n; ++i)
      if (!valid || valid[i]) base_z = std::min(base_z, xyz[i * 3 + 2]);
  }
  for (int32_t i = 0; i < n; ++i) {
    if (valid && !valid[i]) continue;
    ++n_valid;
    if (xyz[i * 3 + 2] <= base_z + ground_eps)
      ground.push_back(i);
    else
      body.push_back(i);
  }
  const int32_t total = n_body + n_ground;
  if (n_valid == 0) {
    std::memset(out_xyz, 0, sizeof(float) * total * 3);
    std::memset(out_rgb, 0, sizeof(uint8_t) * total * 3);
    return 0;
  }
  std::vector<int32_t> sel_body, sel_ground;
  sample_and_pad(body, n_body, rng, sel_body);
  sample_and_pad(ground, n_ground, rng, sel_ground);
  auto emit = [&](const std::vector<int32_t>& sel, bool zero, int32_t offset) {
    for (size_t k = 0; k < sel.size(); ++k) {
      const int32_t dst = offset + static_cast<int32_t>(k);
      if (zero) {
        out_xyz[dst * 3] = out_xyz[dst * 3 + 1] = out_xyz[dst * 3 + 2] = 0.f;
        out_rgb[dst * 3] = out_rgb[dst * 3 + 1] = out_rgb[dst * 3 + 2] = 0;
      } else {
        const int32_t src = sel[k];
        std::memcpy(out_xyz + dst * 3, xyz + src * 3, 3 * sizeof(float));
        std::memcpy(out_rgb + dst * 3, rgb + src * 3, 3);
      }
    }
  };
  // One side empty -> zero-fill that side (dm_control_utils.py:384-402).
  emit(sel_body, body.empty(), 0);
  emit(sel_ground, ground.empty(), n_body);
  return n_valid;
}

// ManiSkill pcd_base sampler: seg [n, k] boolean masks (uint8), points with
// xyz[2] <= 1e-3 dropped, per-mask minimum min_pts, proportional foreground
// budget fg_pts, background fill to n_points, pad-by-tiling.  Writes chosen
// source indices into out_index [n_points]; the caller gathers all keys.
int32_t seg_balanced_sample_indices(const float* xyz, const uint8_t* seg,
                                    int32_t n, int32_t k, int32_t n_points,
                                    int32_t min_pts, int32_t fg_pts,
                                    uint64_t seed, int32_t* out_index) {
  XorShift128 rng(seed);
  std::vector<int32_t> keep;
  keep.reserve(n);
  for (int32_t i = 0; i < n; ++i)
    if (xyz[i * 3 + 2] > 1e-3f) keep.push_back(i);

  // per-mask pools over kept points; background = no mask set
  std::vector<std::vector<int32_t>> pools(k + 1);
  std::vector<int64_t> counts(k, 0);
  for (int32_t idx : keep) {
    bool any = false;
    for (int32_t j = 0; j < k; ++j) {
      if (seg[idx * k + j]) {
        pools[j].push_back(idx);
        ++counts[j];
        any = true;
      }
    }
    if (!any) pools[k].push_back(idx);
  }
  // budgets (observation_process.py:41-51)
  std::vector<int64_t> base(k), remain(k), tgt(k + 1);
  int64_t base_sum = 0, remain_sum = 0;
  for (int32_t j = 0; j < k; ++j) {
    base[j] = std::min<int64_t>(counts[j], min_pts);
    base_sum += base[j];
    remain[j] = counts[j] - base[j];
    remain_sum += remain[j];
  }
  int64_t tgt_sum = 0;
  for (int32_t j = 0; j < k; ++j) {
    tgt[j] = base[j] + (remain_sum > 0 ? (fg_pts - base_sum) * remain[j] / remain_sum : 0);
    tgt_sum += tgt[j];
  }
  tgt[k] = n_points - tgt_sum;  // background budget

  std::vector<int32_t> chosen;
  chosen.reserve(n_points);
  std::vector<int32_t> sel;
  for (int32_t j = 0; j <= k; ++j) {
    if (pools[j].empty() || tgt[j] <= 0) continue;
    const size_t want = static_cast<size_t>(std::min<int64_t>(tgt[j], (int64_t)pools[j].size()));
    std::vector<int32_t> tmp(pools[j]);
    partial_shuffle(tmp, want, rng);
    chosen.insert(chosen.end(), tmp.begin(), tmp.begin() + want);
  }
  if (chosen.empty()) chosen.push_back(keep.empty() ? 0 : keep[0]);
  for (int32_t i = 0; i < n_points; ++i) out_index[i] = chosen[i % chosen.size()];
  return static_cast<int32_t>(keep.size());
}

}  // extern "C"
