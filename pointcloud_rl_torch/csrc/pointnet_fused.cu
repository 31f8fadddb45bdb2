// Fused PointNet body for Hopper (sm_90a): per-point 3-layer MLP with two
// row LayerNorms, then a max-pool over the points with an optional
// first-index argmax.
//
// Replaces the Pallas TPU kernel `_forward_pallas` in
// pointcloud_rl_tpu/ops/pointnet_fused.py (bodies `_fwd_kernel`, with the
// argmax, and `_fwd_kernel_max_only`).  Per point:
//     h1 = relu(x W1 + b1)
//     h2 = relu(LN(h1 W2 + b2))          LN eps 1e-6, statistics in f32
//     h3 = relu(LN(h2 W3 + b3))
// then pooled[b, c] = max_n h3[b, n, c] and idx[b, c] = the FIRST n that
// attains it.  With T = __nv_bfloat16 the rounding follows `_body_rows`:
// x and W are rounded to bf16, products accumulate in f32, the f32 bias is
// added, and h1/h2/h3 are stored rounded to bf16 (LN still in f32); the max
// runs over the bf16 h3 widened to f32.
//
// What bounds it.  At the training slice's shape (B=256, N=1200, C_in=8,
// widths 128/128/256) one encode is 2*B*N*(8*128 + 128*128 + 128*256) =
// 31 GFLOP against a 9.8 MB f32 read of x and a 262 KB write: about 3,000
// FLOP per byte, so the body is compute-bound, never bandwidth-bound.  The
// unfused PyTorch version instead writes and re-reads the [B*N, C]
// activations (h3 alone is 315 MB in f32).
//
// What the design does about it.  This first version keeps every
// activation on chip and touches device memory only for x, the weights and
// the pooled outputs:
//   * One CTA owns one batch row and walks its points in index order, in
//     tiles of kTileP points, carrying a running (max, idx) per output
//     channel in a register.  The update is a strict `>`, so the earliest
//     winner survives as in the TPU kernel, with no atomics and no
//     cross-CTA merge: the result is deterministic.
//   * The ragged tail (1200 is no multiple of a power-of-two tile) is
//     masked: rows past N are zero-filled, computed and never read.
//   * Each CTA computes whole rows of a2/a3, so LayerNorm statistics run
//     over the full C2/C3 row in f32.
//   * The matmuls are register-blocked on CUDA cores: each thread owns
//     kRowsPerThread points x up to 8 channels strided by 32, so a warp
//     reads one broadcast activation and 32 consecutive weights per k.
//   * f32 weights (196 KB at the slice's widths) do not fit in shared memory
//     beside the activation tiles; they are read through the read-only
//     cache and stay in L2.  bf16 weights (98 KB, 81 KB at the walker's
//     widths) are staged once per CTA in dynamic shared memory.
// Tensor cores (mma.sync / wgmma) with TMA-fed weight tiles are the next
// step; this version is the correct baseline they are measured against.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 32;                           // points per tile
constexpr int kLanes = 32;                           // output-column lanes
constexpr int kRowGroups = kThreads / kLanes;        // 8 warps
constexpr int kRowsPerThread = kTileP / kRowGroups;  // 4 points per thread
constexpr int kMaxNC = 8;                            // 8 x 32 = 256 channels
constexpr int kMaxWidth = kMaxNC * kLanes;
constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round to the storage precision of the compute type.
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
template <typename T>
__device__ __forceinline__ float round_as(float v) {
  return round_to(v, static_cast<T*>(nullptr));
}

__device__ __forceinline__ float load_w(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_w(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[p, j] = epilogue(sum_k in[p, k] * W[k, j] + bias[j]) for the tile's
// kTileP rows.  `in` and `out` are row-major in shared memory; W is [K, n_out]
// row-major (global f32 or shared bf16).  RELU_ROUND: apply relu and round
// to T (layer 1); otherwise store the f32 pre-LayerNorm value.
template <int NC, typename T, bool RELU_ROUND>
__device__ __forceinline__ void dense_tile(const float* __restrict__ in, int K,
                                           const T* __restrict__ W,
                                           const float* __restrict__ bias, int n_out,
                                           float* __restrict__ out) {
  const int lane = threadIdx.x % kLanes;
  const int grp = threadIdx.x / kLanes;
  float acc[kRowsPerThread][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int k = 0; k < K; ++k) {
    float a[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) a[r] = in[(grp + r * kRowGroups) * K + k];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = lane + c * kLanes;
      const float w = j < n_out ? load_w(W + k * n_out + j) : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r][c] = fmaf(a[r], w, acc[r][c]);
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = lane + c * kLanes;
    if (j >= n_out) continue;
    const float bj = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      float v = acc[r][c] + bj;
      if (RELU_ROUND) v = round_as<T>(fmaxf(v, 0.f));
      out[(grp + r * kRowGroups) * n_out + j] = v;
    }
  }
}

template <typename T, bool RELU_ROUND>
__device__ __forceinline__ void dense(const float* in, int K, const T* W, const float* bias,
                                      int n_out, float* out) {
  switch ((n_out + kLanes - 1) / kLanes) {
    case 1: dense_tile<1, T, RELU_ROUND>(in, K, W, bias, n_out, out); break;
    case 2: dense_tile<2, T, RELU_ROUND>(in, K, W, bias, n_out, out); break;
    case 3: dense_tile<3, T, RELU_ROUND>(in, K, W, bias, n_out, out); break;
    case 4: dense_tile<4, T, RELU_ROUND>(in, K, W, bias, n_out, out); break;
    case 5: dense_tile<5, T, RELU_ROUND>(in, K, W, bias, n_out, out); break;
    case 6: dense_tile<6, T, RELU_ROUND>(in, K, W, bias, n_out, out); break;
    case 7: dense_tile<7, T, RELU_ROUND>(in, K, W, bias, n_out, out); break;
    default: dense_tile<8, T, RELU_ROUND>(in, K, W, bias, n_out, out); break;
  }
}

// In place on the tile's kTileP rows of width C: relu(LN(row)) rounded to T.
// One warp per row; two-pass mean/variance in f32 as in `_ln_f32`.
template <typename T>
__device__ __forceinline__ void layer_norm_relu(float* buf, int C, const float* __restrict__ gamma,
                                                const float* __restrict__ beta) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float inv_c = 1.f / static_cast<float>(C);
  for (int p = warp; p < kTileP; p += kThreads / 32) {
    float* row = buf + p * C;
    float s = 0.f;
    for (int j = lane; j < C; j += 32) s += row[j];
    const float mu = warp_sum(s) * inv_c;
    float q = 0.f;
    for (int j = lane; j < C; j += 32) {
      const float d = row[j] - mu;
      q += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(q) * inv_c + kLnEps);
    for (int j = lane; j < C; j += 32)
      row[j] = round_as<T>(fmaxf((row[j] - mu) * rstd * __ldg(gamma + j) + __ldg(beta + j), 0.f));
  }
}

struct Params {
  const void* x;  // [B, N, c_in] of T
  int N, c_in, c1, c2, c3;
  const void* w1;  // [c_in, c1] of T
  const float* b1;
  const void* w2;  // [c1, c2] of T
  const float *b2, *g2, *be2;
  const void* w3;  // [c2, c3] of T
  const float *b3, *g3, *be3;
  float* pooled;    // [B, c3]
  int32_t* idx;     // [B, c3], WITH_IDX only
};

template <typename T, bool WITH_IDX>
__global__ void __launch_bounds__(kThreads) pointnet_fused_kernel(Params prm) {
  extern __shared__ float4 smem_f4[];
  const int width = max(max(prm.c_in, prm.c1), max(prm.c2, prm.c3));
  float* buf0 = reinterpret_cast<float*>(smem_f4);
  float* buf1 = buf0 + kTileP * width;

  const T* w1 = static_cast<const T*>(prm.w1);
  const T* w2 = static_cast<const T*>(prm.w2);
  const T* w3 = static_cast<const T*>(prm.w3);
  if (sizeof(T) == 2) {
    // bf16: stage the three weight matrices in shared memory once.
    T* ws = reinterpret_cast<T*>(buf1 + kTileP * width);
    const int n1 = prm.c_in * prm.c1, n2 = prm.c1 * prm.c2, n3 = prm.c2 * prm.c3;
    for (int i = threadIdx.x; i < n1; i += kThreads) ws[i] = w1[i];
    for (int i = threadIdx.x; i < n2; i += kThreads) ws[n1 + i] = w2[i];
    for (int i = threadIdx.x; i < n3; i += kThreads) ws[n1 + n2 + i] = w3[i];
    w1 = ws;
    w2 = ws + n1;
    w3 = ws + n1 + n2;
  }

  const int b = blockIdx.x;
  const int N = prm.N, c_in = prm.c_in, c3 = prm.c3;
  const T* xb = static_cast<const T*>(prm.x) + static_cast<size_t>(b) * N * c_in;
  float best = -INFINITY;
  int best_i = 0;

  for (int p0 = 0; p0 < N; p0 += kTileP) {
    const int valid = min(kTileP, N - p0);
    // x tile -> buf1 (rows past N zero-filled; they are never pooled)
    for (int i = threadIdx.x; i < kTileP * c_in; i += kThreads)
      buf1[i] = (i / c_in) < valid ? to_f32(xb[static_cast<size_t>(p0) * c_in + i]) : 0.f;
    __syncthreads();
    dense<T, true>(buf1, c_in, w1, prm.b1, prm.c1, buf0);  // h1
    __syncthreads();
    dense<T, false>(buf0, prm.c1, w2, prm.b2, prm.c2, buf1);  // a2
    __syncthreads();
    layer_norm_relu<T>(buf1, prm.c2, prm.g2, prm.be2);  // h2
    __syncthreads();
    dense<T, false>(buf1, prm.c2, w3, prm.b3, c3, buf0);  // a3
    __syncthreads();
    layer_norm_relu<T>(buf0, c3, prm.g3, prm.be3);  // h3
    __syncthreads();
    // Running max in point order; strict `>` keeps the earliest winner.
    // The next tile's x load writes buf1 only, and buf0 is next written
    // after a barrier, so no barrier is needed here.
    if (threadIdx.x < c3) {
      for (int p = 0; p < valid; ++p) {
        const float v = buf0[p * c3 + threadIdx.x];
        if (v > best) {
          best = v;
          best_i = p0 + p;
        }
      }
    }
  }
  if (threadIdx.x < c3) {
    prm.pooled[static_cast<size_t>(b) * c3 + threadIdx.x] = best;
    if (WITH_IDX) prm.idx[static_cast<size_t>(b) * c3 + threadIdx.x] = best_i;
  }
}

size_t smem_bytes(const Params& p, int bf16) {
  const int width = std::max(std::max(p.c_in, p.c1), std::max(p.c2, p.c3));
  size_t bytes = 2ull * kTileP * width * sizeof(float);
  if (bf16) bytes += sizeof(__nv_bfloat16) * (static_cast<size_t>(p.c_in) * p.c1 +
                                             static_cast<size_t>(p.c1) * p.c2 +
                                             static_cast<size_t>(p.c2) * p.c3);
  return bytes;
}

template <typename T, bool WITH_IDX>
int launch_typed(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p, sizeof(T) == 2);
  auto kernel = pointnet_fused_kernel<T, WITH_IDX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool WITH_IDX>
int launch(int bf16, const void* x, int B, int N, int c_in, const void* w1, const float* b1,
           int c1, const void* w2, const float* b2, const float* g2, const float* be2, int c2,
           const void* w3, const float* b3, const float* g3, const float* be3, int c3,
           float* pooled, int32_t* idx, void* stream) {
  if (B < 1 || N < 1 || c_in < 1 || c1 < 1 || c2 < 1 || c3 < 1 || c_in > kMaxWidth ||
      c1 > kMaxWidth || c2 > kMaxWidth || c3 > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, N, c_in, c1, c2, c3, w1, b1, w2, b2, g2, be2, w3, b3, g3, be3, pooled, idx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_typed<__nv_bfloat16, WITH_IDX>(p, B, s)
              : launch_typed<float, WITH_IDX>(p, B, s);
}

}  // namespace

// C entry points, bound with ctypes.  `bf16` selects the compute type of x
// and W1..W3 (0: float, 1: __nv_bfloat16); biases and LayerNorm parameters
// are always f32.  Each returns the cudaError_t of the launch (0 on success).
extern "C" int pointnet_fused_fwd_idx(int bf16, const void* x, int B, int N, int c_in,
                                      const void* w1, const float* b1, int c1, const void* w2,
                                      const float* b2, const float* g2, const float* be2, int c2,
                                      const void* w3, const float* b3, const float* g3,
                                      const float* be3, int c3, float* pooled, int32_t* idx,
                                      void* stream) {
  return launch<true>(bf16, x, B, N, c_in, w1, b1, c1, w2, b2, g2, be2, c2, w3, b3, g3, be3, c3,
                      pooled, idx, stream);
}

extern "C" int pointnet_fused_fwd_max(int bf16, const void* x, int B, int N, int c_in,
                                      const void* w1, const float* b1, int c1, const void* w2,
                                      const float* b2, const float* g2, const float* be2, int c2,
                                      const void* w3, const float* b3, const float* g3,
                                      const float* be3, int c3, float* pooled, void* stream) {
  return launch<false>(bf16, x, B, N, c_in, w1, b1, c1, w2, b2, g2, be2, c2, w3, b3, g3, be3, c3,
                       pooled, nullptr, stream);
}

extern "C" const char* pointnet_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
