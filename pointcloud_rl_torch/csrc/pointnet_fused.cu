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
// 30.8 GFLOP against a 9.8 MB read of x: about 3,000 FLOP per byte, so the
// body is bound by the matrix units, never by device memory.  In f32 the
// card has no f32 tensor-core product, so the two large layers run as
// 3xTF32 (below): 3 x 30.8 GFLOP at 495 TFLOP/s, a bound of 0.19 ms.  In
// bf16 the bound is 30.8 GFLOP at 989 TFLOP/s, 0.03 ms.  At the act shape
// (B=4) the bound is a few microseconds: there launch latency and filling
// the 132 SMs decide.
//
// What the design does about it.
//   * The point axis is split across CTAs.  The grid is (batch row x point
//     chunk); the wrapper picks the chunk count from B and N so that the
//     grid fills the SMs (many chunks per row at B=4, one at B=256).  A CTA
//     walks its chunk's tiles of 64 or 128 points in order and writes a
//     partial (max, first index) per channel to a scratch buffer; a second
//     small launch merges the partials in chunk order with a strict `>`, so
//     ties go to the earlier chunk.  Inside a CTA, ties between rows go to
//     the lower point index.  The result is exactly the first-index argmax
//     of one sequential pass, deterministic, with no atomics.
//   * Layers 2 and 3 run on tensor cores with `wgmma` (m64n64, one 64-row
//     warpgroup per 64 points of the tile).  bf16: bf16 operands, f32
//     accumulators, the exact semantics of `_body_rows`.  f32: 3xTF32 -- each
//     operand is split into a TF32 high part and a TF32 remainder and the
//     accumulator sums hi*hi + hi*lo + lo*hi in f32, which keeps f32
//     accuracy (a single TF32 pass would move outputs by ~1e-3).  Layer 1
//     (K = C_in, 8 or 9) stays on CUDA cores, register-blocked 4 rows x one
//     16-byte column group per thread.
//   * Operands live in shared memory in the no-swizzle K-major core-matrix
//     layout that the `wgmma` descriptors read (8 rows x 16 bytes per core
//     matrix).  Widths that are no multiple of 64 are zero-padded in the
//     staged weights, and the padding is left out of the LayerNorm
//     statistics.
//   * Weights: a prep launch writes W2/W3 once per call, already split (f32)
//     and in the core-matrix layout, as K-chunks of 16 rows, so a chunk is
//     one contiguous copy with 16-byte `cp.async`.  bf16 W2/W3 (96 KB at the
//     slice's widths) stay in shared memory for the whole CTA, loaded once,
//     beside the activation tiles.  f32 W2/W3 split into hi and lo take 384
//     KB and cannot stay beside a 128-point tile, so they stream chunk by
//     chunk through a double buffer from L2 (every CTA reads the same
//     weights; they stay L2 resident), the next chunk in flight while the
//     current one computes.  The plan picks residency when it fits.  The
//     next x tile is always in flight (4-byte `cp.async`) during the current
//     one.
//   * LayerNorm, ReLU, rounding, max and argmax run on the accumulator
//     fragments: a row's columns sit in the four lanes of a quad, so the row
//     statistics take two shuffles; the max over the tile's rows takes three
//     shuffles plus a per-warp running (max, idx) in shared memory, so h3
//     never goes to shared memory.
//   * The ragged tail is masked: rows past the chunk's end are computed on
//     zeros and never pooled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWG = 128;           // threads per warpgroup
constexpr int kMaxThreads = 256;   // two warpgroups per CTA at most
constexpr int kKChunk = 16;        // K rows of W per streamed chunk
constexpr int kNTile = 64;         // wgmma N per instruction
constexpr int kMaxWidth = 256;
constexpr int kMaxSmem = 232448;   // 227 KB of dynamic shared memory per block
constexpr float kLnEps = 1e-6f;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// Make generic-proxy writes to shared memory visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void warpgroup_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWG) : "memory");
}

// Shared-memory matrix descriptor, no swizzle (layout type 0).  K-major
// core matrices of 8 rows x 16 bytes; `lbo` = byte stride between core
// matrices along K, `sbo` = byte stride between 8-row groups.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

#define PCRL_WGMMA_D32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define PCRL_WGMMA_OUT32(d)                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// D[64 x 64] += A[64 x 16] * B[16 x 64], bf16 operands, f32 accumulators.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PCRL_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PCRL_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 8] * B[8 x 64], tf32 operands, f32 accumulators.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " PCRL_WGMMA_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : PCRL_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ------------------------------------------------------------------ plan
// Everything about a launch that follows from (dtype, widths): the tile,
// the padded widths, the shared-memory map and the scratch map.
struct Plan {
  int esz, parts, E;       // element bytes; 2 operand parts (hi, lo) for f32; elements per 16 B
  int wgs, rows;           // warpgroups per CTA, points per tile (64 * wgs)
  int kp1, kp2;            // K of layers 2 and 3, padded to 16
  int np2, np3;            // N of layers 2 and 3, padded to 64
  int nc2, nc3;            // streamed chunks per layer
  int chunk2, chunk3;      // bytes per chunk of W2 / W3 (all parts)
  int act_wg;              // bytes of one operand part of one warpgroup's activations
  int xbytes;              // bytes of one x tile buffer
  int resident;            // 1: all of W2/W3 stays in shared memory; 0: chunks stream through 2 buffers
  // shared-memory byte offsets
  int o_act, o_w, o_x, o_w1, o_b1, o_prm, o_run_v, o_run_i, smem;
};

__host__ __device__ inline size_t weights_bytes(const Plan& p) {
  return static_cast<size_t>(p.nc2) * p.chunk2 + static_cast<size_t>(p.nc3) * p.chunk3;
}

// Byte offset of chunk `s` of the per-tile sequence (W2's chunks, then
// W3's) in the prepared weights, and in shared memory when resident.
__host__ __device__ inline int chunk_offset(const Plan& p, int s) {
  return s < p.nc2 ? s * p.chunk2 : p.nc2 * p.chunk2 + (s - p.nc2) * p.chunk3;
}

bool make_plan(int bf16, int c_in, int c1, int c2, int c3, int wgs, int resident, Plan* p) {
  p->esz = bf16 ? 2 : 4;
  p->parts = bf16 ? 1 : 2;
  p->E = 16 / p->esz;
  p->wgs = wgs;
  p->rows = 64 * wgs;
  p->kp1 = round_up(c1, kKChunk);
  p->kp2 = round_up(c2, kKChunk);
  p->np2 = round_up(c2, kNTile);
  p->np3 = round_up(c3, kNTile);
  p->nc2 = p->kp1 / kKChunk;
  p->nc3 = p->kp2 / kKChunk;
  p->chunk2 = p->parts * p->np2 * kKChunk * p->esz;
  p->chunk3 = p->parts * p->np3 * kKChunk * p->esz;
  p->act_wg = 64 * std::max(p->kp1, p->kp2) * p->esz;
  p->xbytes = round_up(p->rows * c_in * p->esz + 8, 16);
  p->resident = resident;
  int o = 0;
  p->o_act = o;   o += p->parts * wgs * p->act_wg;
  p->o_w = o;     o += resident ? static_cast<int>(weights_bytes(*p)) : 2 * std::max(p->chunk2, p->chunk3);
  p->o_x = o;     o += 2 * p->xbytes;
  p->o_w1 = o;    o += round_up(c_in * p->kp1 * 4, 16);
  p->o_b1 = o;    o += p->kp1 * 4;
  p->o_prm = o;   o += 3 * (p->np2 + p->np3) * 4;
  p->o_run_v = o; o += round_up(p->rows / 16 * c3 * 4, 16);
  p->o_run_i = o; o += round_up(p->rows / 16 * c3 * 4, 16);
  p->smem = o;
  return o <= kMaxSmem;
}

// Two warpgroups (128-point tiles) when they fit in shared memory, else
// one; for each, the weights resident when they fit (bf16 at the main
// path's widths), else streamed (f32).
bool choose_plan(int bf16, int c_in, int c1, int c2, int c3, Plan* p) {
  if (c_in < 1 || c1 < 1 || c2 < 1 || c3 < 1 || c1 > kMaxWidth || c2 > kMaxWidth ||
      c3 > kMaxWidth || c_in > kMaxWidth)
    return false;
  for (int wgs = 2; wgs >= 1; --wgs)
    for (int resident = 1; resident >= 0; --resident)
      if (make_plan(bf16, c_in, c1, c2, c3, wgs, resident, p)) return true;
  return false;
}
size_t partials_offset(const Plan& p) { return round_up(static_cast<int>(weights_bytes(p)), 256); }

struct Params {
  const void* x;  // [B, N, c_in] of T
  int N, c_in, c1, c2, c3, chunks, tiles_per_chunk;
  const void* w1;  // [c_in, c1] of T
  const float *b1, *b2, *g2, *be2, *b3, *g3, *be3;
  const unsigned char* wprep;  // W2 / W3 chunks written by prep_weights_kernel
  float* part_v;               // [B, chunks, c3]
  int32_t* part_i;             // [B, chunks, c3]
  Plan plan;
};

// ----------------------------------------------------------- weight prep
// W [K, N] (row-major, T) -> K-chunks of 16 rows, each in the K-major
// core-matrix layout of a wgmma B operand: element (n, kk) at
// (n/8)*SBO + (kk/E)*128 + (n%8)*16 + (kk%E)*esz, SBO = (16/E)*128.  f32 is
// split into a TF32 high part and a TF32 remainder (the lo part follows the
// hi part inside each chunk).  Padding (k >= K or n >= N) is zero.
template <typename T>
__global__ void prep_weights_kernel(const T* __restrict__ w2, const T* __restrict__ w3, Plan p,
                                    int c1, int c2, int c3, unsigned char* __restrict__ out) {
  const int n2 = p.np2 * p.kp1, n3 = p.np3 * p.kp2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2 + n3) return;
  const bool l3 = i >= n2;
  const int j = l3 ? i - n2 : i;
  const int np = l3 ? p.np3 : p.np2;
  const int n = j % np, k = j / np;
  const int K = l3 ? c2 : c1, N = l3 ? c3 : c2;
  const T* w = l3 ? w3 : w2;
  const int chunk_bytes = l3 ? p.chunk3 : p.chunk2;
  unsigned char* base = out + (l3 ? static_cast<size_t>(p.nc2) * p.chunk2 : 0) +
                        static_cast<size_t>(k / kKChunk) * chunk_bytes;
  const int kk = k % kKChunk;
  const int sbo = (kKChunk / p.E) * 128;
  const int off = (n / 8) * sbo + (kk / p.E) * 128 + (n % 8) * 16 + (kk % p.E) * p.esz;
  const T zero = T(0.f);
  const T v = (k < K && n < N) ? w[static_cast<size_t>(k) * N + n] : zero;
  if (sizeof(T) == 2) {
    *reinterpret_cast<T*>(base + off) = v;
  } else {
    const float f = to_f32(v);
    const float hi = tf32_round(f);
    *reinterpret_cast<float*>(base + off) = hi;
    *reinterpret_cast<float*>(base + np * kKChunk * 4 + off) = tf32_round(f - hi);
  }
}

// ------------------------------------------------------------ main kernel
struct Smem {
  unsigned char* act;  // [parts][wgs][64 rows x kpmax], core-matrix layout
  unsigned char* w;    // two chunk buffers
  unsigned char* x;    // two x tile buffers
  float *w1, *b1, *prm, *run_v;
  int32_t* run_i;
};

// Copy chunk `s` of the per-tile weight stream into buffer `buf`; with
// resident weights, copy all of them once.
__device__ __forceinline__ void load_chunk(const Params& prm, const Smem& sm, int s, int buf) {
  const Plan& p = prm.plan;
  const unsigned char* src = prm.wprep + (p.resident ? 0 : chunk_offset(p, s));
  const int bytes = p.resident ? static_cast<int>(weights_bytes(p)) : s < p.nc2 ? p.chunk2 : p.chunk3;
  unsigned char* dst = sm.w + (p.resident ? 0 : buf * max(p.chunk2, p.chunk3));
  for (int o = threadIdx.x * 16; o < bytes; o += blockDim.x * 16) cp_async16(dst + o, src + o);
}

// Copy the x rows [p0, p0 + valid) of batch row b into x buffer `buf`, in
// 4-byte words over the 4-byte-aligned span that holds them.  Returns the
// byte offset of the tile's first element inside the buffer.
template <typename T>
__device__ __forceinline__ int load_x(const Params& prm, const Smem& sm, int b, int p0, int valid,
                                      int buf) {
  const size_t start = (static_cast<size_t>(b) * prm.N + p0) * prm.c_in * sizeof(T);
  const size_t end = start + static_cast<size_t>(valid) * prm.c_in * sizeof(T);
  const size_t a0 = start & ~size_t(3);
  const int words = static_cast<int>((end - a0 + 3) / 4);
  const unsigned char* src = static_cast<const unsigned char*>(prm.x) + a0;
  unsigned char* dst = sm.x + buf * prm.plan.xbytes;
  for (int i = threadIdx.x; i < words; i += blockDim.x) cp_async4(dst + 4 * i, src + 4 * i);
  return static_cast<int>(start - a0);
}

// Layer 1 on CUDA cores: h1 = relu(x W1 + b1), rounded to the operand type
// and written into the activation buffer in the core-matrix layout.  A
// thread computes 4 rows (8 apart) x one 16-byte column group (E columns),
// so the 8 lanes of a column group store one contiguous core matrix.
template <typename T>
__device__ __forceinline__ void layer1(const Params& prm, const Smem& sm, const unsigned char* xt,
                                       int valid) {
  constexpr int E = 16 / sizeof(T);
  const Plan& p = prm.plan;
  const int c_in = prm.c_in, kp1 = p.kp1;
  const int n_cc = kp1 / E;
  const int sbo = (kp1 / E) * 128;
  const int items = (p.rows / 32) * n_cc * 8;
  for (int id = threadIdx.x; id < items; id += blockDim.x) {
    const int r8 = id & 7, cc = (id >> 3) % n_cc, rg = (id >> 3) / n_cc;
    float acc[4][E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float bj = sm.b1[cc * E + e];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][e] = bj;
    }
    for (int k = 0; k < c_in; ++k) {
      float xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 32 + r8 + 8 * i;
        xv[i] = r < valid ? to_f32(reinterpret_cast<const T*>(xt)[r * c_in + k]) : 0.f;
      }
      const float4* wr = reinterpret_cast<const float4*>(sm.w1 + k * kp1 + cc * E);
#pragma unroll
      for (int e4 = 0; e4 < E / 4; ++e4) {
        const float4 w = wr[e4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * e4 + 0] = fmaf(xv[i], w.x, acc[i][4 * e4 + 0]);
          acc[i][4 * e4 + 1] = fmaf(xv[i], w.y, acc[i][4 * e4 + 1]);
          acc[i][4 * e4 + 2] = fmaf(xv[i], w.z, acc[i][4 * e4 + 2]);
          acc[i][4 * e4 + 3] = fmaf(xv[i], w.w, acc[i][4 * e4 + 3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 32 + r8 + 8 * i;
      const int g = r / 64, ri = r % 64;
      const int off = (ri / 8) * sbo + cc * 128 + (ri % 8) * 16;
      if (sizeof(T) == 2) {
        __align__(16) __nv_bfloat16 h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16(fmaxf(acc[i][e], 0.f));
        *reinterpret_cast<uint4*>(sm.act + g * p.act_wg + off) = *reinterpret_cast<uint4*>(h);
      } else {
        float4 hi, lo;
        float* hp = &hi.x;
        float* lp = &lo.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = fmaxf(acc[i][e], 0.f);
          hp[e] = tf32_round(v);
          lp[e] = tf32_round(v - hp[e]);
        }
        *reinterpret_cast<float4*>(sm.act + g * p.act_wg + off) = hi;
        *reinterpret_cast<float4*>(sm.act + (p.wgs + g) * p.act_wg + off) = lo;
      }
    }
  }
}

// One K-chunk of a layer for this warpgroup: acc[t] += A * Wchunk for the
// n-tiles t < nt.  `kc` is the chunk's index inside the layer, `kp` the
// layer's padded K (the A operand's row length).  `first`: the layer's
// first chunk (the accumulators were just written); `wait`: wait until
// every product issued so far is done.
template <typename T>
__device__ __forceinline__ void mma_chunk(float (&acc)[4][32], const Smem& sm, const Plan& p,
                                          int g, int kc, int kp, int np, int nt,
                                          const unsigned char* wchunk, bool first, bool wait) {
  constexpr int E = 16 / sizeof(T);
  const uint32_t sbo_a = (kp / E) * 128;
  const uint32_t sbo_w = (kKChunk / E) * 128;
  const uint32_t a_hi = smem_u32(sm.act + g * p.act_wg) + kc * (kKChunk / E) * 128;
  const uint32_t w0 = smem_u32(wchunk);
  if (first) wgmma_fence();
  if (sizeof(T) == 2) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t < nt)
        wgmma_bf16(acc[t], make_desc(a_hi, 128, sbo_a), make_desc(w0 + t * 8 * sbo_w, 128, sbo_w));
    }
  } else {
    const uint32_t a_lo = a_hi + p.wgs * p.act_wg;
    const uint32_t w_lo = w0 + np * kKChunk * 4;
#pragma unroll
    for (int s = 0; s < kKChunk / 8; ++s) {
      const uint64_t dah = make_desc(a_hi + s * 256, 128, sbo_a);
      const uint64_t dal = make_desc(a_lo + s * 256, 128, sbo_a);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < nt) {
          const uint32_t wo = t * 8 * sbo_w + s * 256;
          const uint64_t dbh = make_desc(w0 + wo, 128, sbo_w);
          const uint64_t dbl = make_desc(w_lo + wo, 128, sbo_w);
          wgmma_tf32(acc[t], dal, dbh);  // small terms first
          wgmma_tf32(acc[t], dah, dbl);
          wgmma_tf32(acc[t], dah, dbh);
        }
      }
    }
  }
  wgmma_commit();
  if (wait) wgmma_wait_all();
}

// Bias + LayerNorm + ReLU on the accumulator fragments of this thread's two
// rows (lane/4 and lane/4 + 8 of its warp's 16).  Fragment element 4j+h
// (h < 2) of n-tile t is row A, column 64t + 8j + 2q + h (q = lane % 4);
// 4j+2+h is row B.  A row's columns are spread over the 4 lanes of a quad.
// Padded columns (>= c) are left out of the statistics and come out as 0.
__device__ __forceinline__ void ln_relu(float (&acc)[4][32], int nt, int c, const float* bias,
                                        const float* gamma, const float* beta) {
  const int q = threadIdx.x % 4;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 64 * t + 8 * j + 2 * q + h;
        acc[t][4 * j + h] += bias[col];
        acc[t][4 * j + 2 + h] += bias[col];
        if (col < c) {
          s0 += acc[t][4 * j + h];
          s1 += acc[t][4 * j + 2 + h];
        }
      }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  const float inv_c = 1.f / static_cast<float>(c);
  const float mu0 = s0 * inv_c, mu1 = s1 * inv_c;
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 64 * t + 8 * j + 2 * q + h;
        if (col < c) {
          const float d0 = acc[t][4 * j + h] - mu0, d1 = acc[t][4 * j + 2 + h] - mu1;
          v0 += d0 * d0;
          v1 += d1 * d1;
        }
      }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, o);
    v1 += __shfl_xor_sync(0xffffffffu, v1, o);
  }
  const float r0 = 1.f / sqrtf(v0 * inv_c + kLnEps), r1 = 1.f / sqrtf(v1 * inv_c + kLnEps);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 64 * t + 8 * j + 2 * q + h;
        const bool ok = col < c;
        const float gj = gamma[col], bj = beta[col];
        acc[t][4 * j + h] = ok ? fmaxf((acc[t][4 * j + h] - mu0) * r0 * gj + bj, 0.f) : 0.f;
        acc[t][4 * j + 2 + h] = ok ? fmaxf((acc[t][4 * j + 2 + h] - mu1) * r1 * gj + bj, 0.f) : 0.f;
      }
  }
}

// h2 (the fragments after ln_relu) -> this warpgroup's activation buffer,
// as the A operand of layer 3 (columns < kp2, the padded K).
template <typename T>
__device__ __forceinline__ void store_h2(const float (&acc)[4][32], const Smem& sm, const Plan& p,
                                         int g, int nt) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x % 32, w = (threadIdx.x % kWG) / 32, q = lane % 4;
  const int sbo = (p.kp2 / E) * 128;
  unsigned char* hi = sm.act + g * p.act_wg;
  unsigned char* lo = sm.act + (p.wgs + g) * p.act_wg;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * t + 8 * j + 2 * q;
      if (col >= p.kp2) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * w + lane / 4 + 8 * half;
        const int off = (r / 8) * sbo + (col / E) * 128 + (r % 8) * 16 + (col % E) * (int)sizeof(T);
        const float a = acc[t][4 * j + 2 * half], b = acc[t][4 * j + 2 * half + 1];
        if (sizeof(T) == 2) {
          *reinterpret_cast<__nv_bfloat162*>(hi + off) = __floats2bfloat162_rn(a, b);
        } else {
          const float ah = tf32_round(a), bh = tf32_round(b);
          *reinterpret_cast<float2*>(hi + off) = make_float2(ah, bh);
          *reinterpret_cast<float2*>(lo + off) = make_float2(tf32_round(a - ah), tf32_round(b - bh));
        }
      }
    }
  }
}

// (v, i) <- the larger value; on equal values the lower point index.
template <bool WITH_IDX>
__device__ __forceinline__ void take_max(float& v, int& i, float ov, int oi) {
  if (WITH_IDX) {
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  } else {
    v = fmaxf(v, ov);
  }
}

// h3 fragments -> this warp's running (max, first index) per column.
// `rA` is the point index of the thread's row A (row B is rA + 8);
// rows at or past `end` are not pooled.
template <typename T, bool WITH_IDX>
__device__ __forceinline__ void pool_tile(const float (&acc)[4][32], const Smem& sm, int c3, int nt,
                                          int rA, int end) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, q = lane % 4;
  const bool okA = rA < end, okB = rA + 8 < end;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = acc[t][4 * j + h], b = acc[t][4 * j + 2 + h];
        if (sizeof(T) == 2) {
          a = __bfloat162float(__float2bfloat16(a));
          b = __bfloat162float(__float2bfloat16(b));
        }
        float v = okA ? a : -INFINITY;
        int i = rA;
        if (okB && b > v) {
          v = b;
          i = rA + 8;
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, o);
          const int oi = WITH_IDX ? __shfl_xor_sync(0xffffffffu, i, o) : 0;
          take_max<WITH_IDX>(v, i, ov, oi);
        }
        const int col = 64 * t + 8 * j + 2 * q + h;
        if (lane < 4 && col < c3) {
          // Later tiles hold later points: strict `>` keeps the earliest.
          float* rv = sm.run_v + warp * c3 + col;
          if (v > *rv) {
            *rv = v;
            if (WITH_IDX) sm.run_i[warp * c3 + col] = i;
          }
        }
      }
  }
}

template <typename T, bool WITH_IDX>
__device__ __forceinline__ void body(const Params& prm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = prm.plan;
  Smem sm;
  sm.act = smem + p.o_act;
  sm.w = smem + p.o_w;
  sm.x = smem + p.o_x;
  sm.w1 = reinterpret_cast<float*>(smem + p.o_w1);
  sm.b1 = reinterpret_cast<float*>(smem + p.o_b1);
  sm.prm = reinterpret_cast<float*>(smem + p.o_prm);
  sm.run_v = reinterpret_cast<float*>(smem + p.o_run_v);
  sm.run_i = reinterpret_cast<int32_t*>(smem + p.o_run_i);

  const int b = blockIdx.x / prm.chunks, ch = blockIdx.x % prm.chunks;
  const int N = prm.N, c1 = prm.c1, c2 = prm.c2, c3 = prm.c3;
  const int t0 = ch * prm.tiles_per_chunk;
  const int p_begin = t0 * p.rows;
  const int p_end = min(N, p_begin + prm.tiles_per_chunk * p.rows);
  const int ntiles = p_end > p_begin ? (p_end - p_begin + p.rows - 1) / p.rows : 0;
  const int seq = p.nc2 + p.nc3;  // weight chunks per tile
  const int max_chunk = max(p.chunk2, p.chunk3);

  // Prologue: the first weight chunk and x tile in flight, then the small
  // parameters and the running maxima.
  int x_off[2] = {0, 0};
  if (ntiles > 0) {
    load_chunk(prm, sm, 0, 0);
    x_off[0] = load_x<T>(prm, sm, b, p_begin, min(p.rows, p_end - p_begin), 0);
    cp_async_commit();
  }
  const T* w1 = static_cast<const T*>(prm.w1);
  for (int i = threadIdx.x; i < prm.c_in * p.kp1; i += blockDim.x) {
    const int k = i / p.kp1, n = i % p.kp1;
    sm.w1[i] = n < c1 ? to_f32(w1[k * c1 + n]) : 0.f;
  }
  for (int n = threadIdx.x; n < p.kp1; n += blockDim.x) sm.b1[n] = n < c1 ? prm.b1[n] : 0.f;
  float* b2s = sm.prm;
  float* g2s = b2s + p.np2;
  float* be2s = g2s + p.np2;
  float* b3s = be2s + p.np2;
  float* g3s = b3s + p.np3;
  float* be3s = g3s + p.np3;
  for (int n = threadIdx.x; n < p.np2; n += blockDim.x) {
    const bool ok = n < c2;
    b2s[n] = ok ? prm.b2[n] : 0.f;
    g2s[n] = ok ? prm.g2[n] : 0.f;
    be2s[n] = ok ? prm.be2[n] : 0.f;
  }
  for (int n = threadIdx.x; n < p.np3; n += blockDim.x) {
    const bool ok = n < c3;
    b3s[n] = ok ? prm.b3[n] : 0.f;
    g3s[n] = ok ? prm.g3[n] : 0.f;
    be3s[n] = ok ? prm.be3[n] : 0.f;
  }
  for (int i = threadIdx.x; i < p.rows / 16 * c3; i += blockDim.x) {
    sm.run_v[i] = -INFINITY;
    sm.run_i[i] = 0x7fffffff;
  }

  const int g = threadIdx.x / kWG;               // this thread's warpgroup
  const int wq = (threadIdx.x % kWG) / 32;        // warp inside the warpgroup
  const int lane = threadIdx.x % 32;
  const int nt2 = p.np2 / kNTile, nt3 = p.np3 / kNTile;
  float acc[4][32];
  int gc = 0;  // weight chunks consumed so far

  for (int t = 0; t < ntiles; ++t) {
    const int p0 = p_begin + t * p.rows;
    const int valid = min(p.rows, p_end - p0);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // x tile t and the next weight chunk have landed
    if (t + 1 < ntiles) {
      const int p1 = p0 + p.rows;
      x_off[(t + 1) & 1] = load_x<T>(prm, sm, b, p1, min(p.rows, p_end - p1), (t + 1) & 1);
      cp_async_commit();
    }
    layer1<T>(prm, sm, sm.x + (t & 1) * p.xbytes + x_off[t & 1], valid);
    fence_proxy_async();
    if (p.resident) __syncthreads();  // h1 rows of both warpgroups written

    for (int layer = 2; layer <= 3; ++layer) {
      const int nc = layer == 2 ? p.nc2 : p.nc3;
      const int kp = layer == 2 ? p.kp1 : p.kp2;
      const int np = layer == 2 ? p.np2 : p.np3;
      const int nt = layer == 2 ? nt2 : nt3;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[a][e] = 0.f;
      for (int kc = 0; kc < nc; ++kc, ++gc) {
        if (p.resident) {
          mma_chunk<T>(acc, sm, p, g, kc, kp, np, nt,
                       sm.w + chunk_offset(p, layer == 2 ? kc : p.nc2 + kc), kc == 0, kc == nc - 1);
          continue;
        }
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();  // chunk gc in its buffer; every wgmma on the other buffer is done
        const bool more = t + 1 < ntiles || (gc + 1) % seq != 0;
        if (more) {
          load_chunk(prm, sm, (gc + 1) % seq, (gc + 1) & 1);
          cp_async_commit();
        }
        mma_chunk<T>(acc, sm, p, g, kc, kp, np, nt, sm.w + (gc & 1) * max_chunk, kc == 0, true);
      }
      warpgroup_barrier(1 + g);  // every warp's wgmma on this warpgroup's A is done
      if (layer == 2) {
        ln_relu(acc, nt, c2, b2s, g2s, be2s);
        store_h2<T>(acc, sm, p, g, nt);
        fence_proxy_async();
        if (p.resident) warpgroup_barrier(1 + g);  // all of h2 written before layer 3 reads it
      } else {
        ln_relu(acc, nt, c3, b3s, g3s, be3s);
        pool_tile<T, WITH_IDX>(acc, sm, c3, nt, p0 + 64 * g + 16 * wq + lane / 4, p_end);
      }
    }
  }

  // Merge the warps' running maxima (ties: lower point index) and write
  // this chunk's partial.
  __syncthreads();
  const size_t base = (static_cast<size_t>(b) * prm.chunks + ch) * c3;
  for (int c = threadIdx.x; c < c3; c += blockDim.x) {
    float v = sm.run_v[c];
    int i = sm.run_i[c];
    for (int w = 1; w < p.rows / 16; ++w)
      take_max<true>(v, i, sm.run_v[w * c3 + c], sm.run_i[w * c3 + c]);
    prm.part_v[base + c] = v;
    if (WITH_IDX) prm.part_i[base + c] = i;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) pointnet_body_idx_kernel(__grid_constant__ const Params prm) {
  body<T, true>(prm);
}
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) pointnet_body_max_kernel(__grid_constant__ const Params prm) {
  body<T, false>(prm);
}

// Partials [B, chunks, c3] -> pooled (and idx), in chunk order with a
// strict `>`: ties go to the earlier chunk, i.e. the lower point index.
template <bool WITH_IDX>
__global__ void merge_chunks_kernel(const float* __restrict__ part_v,
                                    const int32_t* __restrict__ part_i, int B, int chunks, int c3,
                                    float* __restrict__ pooled, int32_t* __restrict__ idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * c3) return;
  const int b = i / c3, c = i % c3;
  const size_t row = static_cast<size_t>(b) * chunks * c3 + c;
  float best = part_v[row];
  int best_i = WITH_IDX ? part_i[row] : 0;
  for (int ch = 1; ch < chunks; ++ch) {
    const float v = part_v[row + static_cast<size_t>(ch) * c3];
    if (v > best) {
      best = v;
      if (WITH_IDX) best_i = part_i[row + static_cast<size_t>(ch) * c3];
    }
  }
  pooled[i] = best;
  if (WITH_IDX) idx[i] = best_i;
}

template <typename T, bool WITH_IDX>
int launch_typed(Params prm, const void* w2, const void* w3, int B, unsigned char* scratch,
                 float* pooled, int32_t* idx, cudaStream_t stream) {
  const Plan& p = prm.plan;
  const int n_prep = p.np2 * p.kp1 + p.np3 * p.kp2;
  prep_weights_kernel<T><<<(n_prep + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(w2), static_cast<const T*>(w3), p, prm.c1, prm.c2, prm.c3, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kernel = WITH_IDX ? pointnet_body_idx_kernel<T> : pointnet_body_max_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * prm.chunks, p.wgs * kWG, p.smem, stream>>>(prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n = B * prm.c3;
  merge_chunks_kernel<WITH_IDX><<<(n + 255) / 256, 256, 0, stream>>>(
      prm.part_v, prm.part_i, B, prm.chunks, prm.c3, pooled, idx);
  return static_cast<int>(cudaGetLastError());
}

template <bool WITH_IDX>
int launch(int bf16, const void* x, int B, int N, int c_in, const void* w1, const float* b1,
           int c1, const void* w2, const float* b2, const float* g2, const float* be2, int c2,
           const void* w3, const float* b3, const float* g3, const float* be3, int c3, int chunks,
           void* scratch, float* pooled, int32_t* idx, void* stream) {
  Plan plan;
  if (B < 1 || N < 1 || chunks < 1 || !choose_plan(bf16, c_in, c1, c2, c3, &plan)) return -1;
  const int n_tiles = (N + plan.rows - 1) / plan.rows;
  const int tpc = (n_tiles + chunks - 1) / chunks;
  unsigned char* s = static_cast<unsigned char*>(scratch);
  float* part_v = reinterpret_cast<float*>(s + partials_offset(plan));
  int32_t* part_i = reinterpret_cast<int32_t*>(part_v + static_cast<size_t>(B) * chunks * c3);
  const Params prm{x, N, c_in, c1, c2, c3, chunks, tpc, w1, b1, b2, g2, be2, b3, g3, be3,
                   s, part_v, part_i, plan};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_typed<__nv_bfloat16, WITH_IDX>(prm, w2, w3, B, s, pooled, idx, st)
              : launch_typed<float, WITH_IDX>(prm, w2, w3, B, s, pooled, idx, st);
}

}  // namespace

// C entry points, bound with ctypes.  `bf16` selects the compute type of x
// and W1..W3 (0: float, 1: __nv_bfloat16); biases and LayerNorm parameters
// are always f32.  `chunks` is the number of point chunks per batch row and
// `scratch` a device buffer of pointnet_fused_scratch_bytes(...) bytes.  The
// launchers return -1 for a shape the kernel does not take, else the
// cudaError_t of the launches (0 on success).

// Points per tile for these widths, or 0 if the kernel does not take them.
extern "C" int pointnet_fused_tile_rows(int bf16, int c_in, int c1, int c2, int c3) {
  Plan p;
  return choose_plan(bf16, c_in, c1, c2, c3, &p) ? p.rows : 0;
}

extern "C" long long pointnet_fused_scratch_bytes(int bf16, int c_in, int c1, int c2, int c3, int B,
                                                  int chunks) {
  Plan p;
  if (!choose_plan(bf16, c_in, c1, c2, c3, &p)) return -1;
  return static_cast<long long>(partials_offset(p)) + 8ll * B * chunks * c3;
}

extern "C" int pointnet_fused_fwd_idx(int bf16, const void* x, int B, int N, int c_in,
                                      const void* w1, const float* b1, int c1, const void* w2,
                                      const float* b2, const float* g2, const float* be2, int c2,
                                      const void* w3, const float* b3, const float* g3,
                                      const float* be3, int c3, int chunks, void* scratch,
                                      float* pooled, int32_t* idx, void* stream) {
  return launch<true>(bf16, x, B, N, c_in, w1, b1, c1, w2, b2, g2, be2, c2, w3, b3, g3, be3, c3,
                      chunks, scratch, pooled, idx, stream);
}

extern "C" int pointnet_fused_fwd_max(int bf16, const void* x, int B, int N, int c_in,
                                      const void* w1, const float* b1, int c1, const void* w2,
                                      const float* b2, const float* g2, const float* be2, int c2,
                                      const void* w3, const float* b3, const float* g3,
                                      const float* be3, int c3, int chunks, void* scratch,
                                      float* pooled, void* stream) {
  return launch<false>(bf16, x, B, N, c_in, w1, b1, c1, w2, b2, g2, be2, c2, w3, b3, g3, be3, c3,
                       chunks, scratch, pooled, nullptr, stream);
}

extern "C" const char* pointnet_fused_error_string(int err) {
  return err == -1 ? "shape not supported by the kernel"
                   : cudaGetErrorString(static_cast<cudaError_t>(err));
}
