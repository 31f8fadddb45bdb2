// Copy of csrc/pcrl_native.cpp (seg_balanced_sample_indices and its helpers
// only) for the PyTorch port, which imports nothing of pointcloud_rl_tpu.
//
// Host-side native kernel of the observation pipeline, exposed through
// ctypes: the ManiSkill pcd_base sampler -- guaranteed minimum per
// segmentation mask, proportional foreground split, background fill,
// pad-by-tiling (observation_process.py:29-70).
//
// RNG: xorshift128+ seeded per call; deterministic per seed (the numpy and
// native paths are individually deterministic, not bit-identical to each
// other).
//
// Build: g++ -O3 -shared -fPIC pcrl_native.cpp -o libpcrl_native.so (ops/build.py)

#include <algorithm>
#include <cstdint>
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

}  // namespace

extern "C" {

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
