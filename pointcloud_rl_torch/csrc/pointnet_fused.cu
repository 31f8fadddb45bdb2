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
// products are bound by the matrix units, never by device memory.  In f32
// the card has no f32 tensor-core product, so the two large layers run as
// 3xTF32 (below): 3 x 30.8 GFLOP at 495 TFLOP/s, a bound of 0.19 ms.  In
// bf16 the bound is 30.8 GFLOP at 989 TFLOP/s, 0.03 ms, and what binds the
// kernel is the per-point work on the CUDA cores around the products: a
// 64-point tile's products take under 1 us of one SM's tensor cores, its
// epilogues some 2,000 instructions a thread.  On the H100, of a
// warpgroup's ~11.8k cycles a 64-point tile (the two warpgroups at once)
// the two LayerNorms take ~48%, the layer-3 product's window ~19%, the
// max-pool keys ~11%.  At the act shape (B=4) the bound is a few
// microseconds: there launch latency and filling the 132 SMs decide.
//
// The bf16 body (the persistent design; widths whose weights fit in
// shared memory, all of the main path's).
//   * Persistent CTAs.  The (batch row, 64-point tile) pairs are cut, in
//     row-major order, into one contiguous run per CTA (the wrapper's
//     `choose_runs`: one wave of CTAs, one an SM; at the act shapes a row's
//     tiles spread over many CTAs).  A CTA loads W1, W2, W3 (bf16, in the
//     wgmma layout, zero-padded to 256 columns: 104-136 KB at the main
//     path's widths) and the small parameters once and walks its run, the
//     next x tile in flight.
//   * Two warpgroups, each on its own 64-point tile: warpgroup w takes the
//     run's tiles w, w + 2, ...  A tile: x -> layer 1 as wgmma k16 steps
//     (C_in padded to 16) -> bias + ReLU -> h1 (bf16, shared memory) ->
//     layer 2 -> LN + ReLU -> h2 -> layer 3 -> LN + ReLU -> keys.  The two
//     take turns at the layer-3 product (named barriers), so one's
//     LayerNorm and keys run on the CUDA cores while the other's product is
//     on the tensor cores; a warpgroup stages its next x tile while its own
//     layer-3 product runs.  Every product is 256 wide, so the wgmma issue
//     has no branch, and the body is a kernel of its own: the compiler
//     would otherwise wait for each wgmma before the next.  LayerNorm reads
//     its parameters as float2 and float4 (a thread's columns come in
//     adjacent pairs) and sums in two chains.
//   * The max-pool in registers, as packed keys.  After the ReLU every h3
//     value is >= +0 and is rounded to bf16; with the sign bit cleared (-0
//     as +0) its 16 bits order as an unsigned integer, so
//         key = bf16 bits << 16 | (0xFFFF - the point's index in the partial)
//     gives the larger value by one unsigned max, and of equal values the
//     lower index: the first-index argmax.  A thread keeps one key for each
//     of its 64 columns over all its tiles of a row (its two rows folded
//     in); no shuffle and no shared memory per tile.  The max-only kernel
//     keeps the bf16 values alone, two a register, under a bf16 max.
//   * Where a run leaves a batch row, each warpgroup reduces its keys over
//     the 8 lanes of a column (shuffles) and its 4 warps (shared memory)
//     and writes its partial (max, first index) for that row.  A run spans
//     at most 1024 tiles (65,536 points), so the index fits 16 bits for
//     any N.  The merge launch takes a row's partials from the CTAs whose
//     runs touch it, ties to the lower index: deterministic, no atomics.
//
// The chunked body (f32, and bf16 too wide for the persistent one).
//   * The point axis is split across CTAs.  The grid is (batch row x point
//     chunk); the wrapper picks the chunk count from B and N so that the
//     grid fills the SMs (many chunks per row at B=4, one at B=256).  A CTA
//     walks its chunk's tiles of 64 or 128 points in order and writes a
//     partial (max, first index) per channel to a scratch buffer; the merge
//     launch takes them in chunk order, so ties go to the earlier chunk.
//     Inside a CTA, ties between rows go to the lower point index.
//   * Layers 2 and 3 run on tensor cores with `wgmma` (m64n64, one 64-row
//     warpgroup per 64 points of the tile).  bf16: bf16 operands, f32
//     accumulators.  f32: 3xTF32 -- each operand is split into a TF32 high
//     part and a TF32 remainder and the accumulator sums hi*hi + hi*lo +
//     lo*hi in f32, which keeps f32 accuracy (a single TF32 pass would move
//     outputs by ~1e-3).  Layer 1 (K = C_in, 8 or 9) stays on CUDA cores,
//     register-blocked 4 rows x one 16-byte column group per thread.
//   * Weights: a prep launch writes W2/W3 once per call, already split (f32)
//     and in the core-matrix layout, as K-chunks of 16 rows, so a chunk is
//     one contiguous copy with 16-byte `cp.async`.  f32 W2/W3 split into hi
//     and lo take 384 KB and cannot stay beside a 128-point tile, so they
//     stream chunk by chunk through a double buffer from L2 (every CTA reads
//     the same weights; they stay L2 resident), the next chunk in flight
//     while the current one computes.  The plan picks residency when it
//     fits.  The next x tile is always in flight (4-byte `cp.async`).
//   * LayerNorm, ReLU, rounding, max and argmax run on the accumulator
//     fragments: a row's columns sit in the four lanes of a quad, so the row
//     statistics take two shuffles; the max over the tile's rows takes three
//     shuffles plus a per-warp running (max, idx) in shared memory.
//   * The ragged tail is masked: rows past the chunk's end are computed on
//     zeros and never pooled.
//
// Both: operands live in shared memory in the no-swizzle K-major
// core-matrix layout that the `wgmma` descriptors read (8 rows x 16 bytes
// per core matrix); widths that are no multiple of 64 are zero-padded in
// the staged weights, and the padding is left out of the LayerNorm
// statistics.  The rounding is `_body_rows`': bf16 operands, f32 sums and
// bias, LN statistics in f32, h1/h2/h3 stored as bf16, the max over the
// bf16 h3.

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

// D[64 x 256] (+)= A[64 x 16] * B[16 x 256] (the bf16 persistent body): bf16 operands, f32
// accumulators, n-tile t's fragment at d[32 t].  `accumulate` 0: D = A * B, the old d is not read.
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Pin the accumulators at this point of the program: the compiler may not
// move their reads or writes across it (the wgmma wait binds no register,
// and a read moved above it makes the compiler serialize the products).
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
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
  int wgs, rows;           // warpgroups per CTA, points per tile (64 * wgs; 64 when persistent)
  int kp1, kp2;            // K of layers 2 and 3, padded to 16
  int np2, np3;            // N of layers 2 and 3, padded to 64
  int nc2, nc3;            // streamed chunks per layer
  int chunk2, chunk3;      // bytes per chunk of W2 / W3 (all parts)
  int kp0, np1, nc1, chunk1;  // layer 1 as a wgmma (persistent only, else nc1 = 0): K, N, chunks, bytes
  int nt1, nt2, nt3;       // persistent: n-tiles of 64 that hold layer 1-3's columns (its products are 256 wide)
  int act_wg;              // bytes of one operand part of one warpgroup's activations
  int xbytes;              // bytes of one x tile buffer
  int resident;            // 1: all of W2/W3 stays in shared memory; 0: chunks stream through 2 buffers
  int persistent;          // 1: the bf16 persistent body (below); 0: the chunked body
  // shared-memory byte offsets
  int o_act, o_w, o_x, o_w1, o_b1, o_prm, o_run_v, o_run_i, o_a1, o_red, smem;
};

__host__ __device__ inline size_t weights_bytes(const Plan& p) {
  return static_cast<size_t>(p.nc1) * p.chunk1 + static_cast<size_t>(p.nc2) * p.chunk2 +
         static_cast<size_t>(p.nc3) * p.chunk3;
}

// Byte offset of chunk `s` of the per-tile sequence (W2's chunks, then
// W3's) in the prepared weights, and in shared memory when resident; W1's
// chunks, when there are any, come first.
__host__ __device__ inline int chunk_offset(const Plan& p, int s) {
  return p.nc1 * p.chunk1 + (s < p.nc2 ? s * p.chunk2 : p.nc2 * p.chunk2 + (s - p.nc2) * p.chunk3);
}

bool make_plan(int bf16, int c_in, int c1, int c2, int c3, int wgs, int resident, Plan* p) {
  *p = Plan{};
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

// The bf16 persistent body: two warpgroups, a 64-point tile each, every
// weight resident (W1 too, as the B operand of layer 1's wgmma, C_in
// padded to 16), and a warpgroup's running keys reduced through shared
// memory where a row's run ends.  Every product is 256 wide (the weights
// zero-padded): a width fixed at compile time keeps the wgmma issue free
// of branches, which the compiler would otherwise serialize.
bool make_persistent_plan(int c_in, int c1, int c2, int c3, Plan* p) {
  *p = Plan{};
  p->esz = 2;
  p->parts = 1;
  p->E = 8;
  p->wgs = 2;
  p->rows = 64;
  p->resident = 1;
  p->persistent = 1;
  p->kp0 = round_up(c_in, kKChunk);
  p->kp1 = round_up(c1, kKChunk);
  p->kp2 = round_up(c2, kKChunk);
  p->nc2 = p->kp1 / kKChunk;
  p->nc3 = p->kp2 / kKChunk;
  p->act_wg = 64 * std::max(p->kp1, p->kp2) * 2;
  p->np1 = p->np2 = p->np3 = kMaxWidth;
  p->nt1 = round_up(p->kp1, kNTile) / kNTile;
  p->nt2 = round_up(c2, kNTile) / kNTile;
  p->nt3 = round_up(c3, kNTile) / kNTile;
  p->nc1 = p->kp0 / kKChunk;
  p->chunk1 = p->chunk2 = p->chunk3 = kMaxWidth * kKChunk * 2;
  p->xbytes = round_up(64 * c_in * 2 + 8, 16);
  int o = 0;
  p->o_w = o;   o += static_cast<int>(weights_bytes(*p));
  p->o_act = o; o += 2 * p->act_wg;
  p->o_a1 = o;  o += 2 * 64 * p->kp0 * 2;
  p->o_x = o;   o += 2 * p->xbytes;
  p->o_b1 = o;  o += p->np1 * 4;
  p->o_prm = o; o += 3 * (p->np2 + p->np3) * 4;
  p->o_red = o; o += 2 * 4 * p->np3 * 4;
  p->smem = o;
  return p->kp0 <= 64 && o <= kMaxSmem;
}

// bf16: the persistent body when its weights fit in shared memory.
// Otherwise (f32, and bf16 too wide for it) the chunked body: two
// warpgroups (128-point tiles) when they fit in shared memory, else one;
// for each, the weights resident when they fit, else streamed.
bool choose_plan(int bf16, int c_in, int c1, int c2, int c3, Plan* p) {
  if (c_in < 1 || c1 < 1 || c2 < 1 || c3 < 1 || c1 > kMaxWidth || c2 > kMaxWidth ||
      c3 > kMaxWidth || c_in > kMaxWidth)
    return false;
  if (bf16 && make_persistent_plan(c_in, c1, c2, c3, p)) return true;
  for (int wgs = 2; wgs >= 1; --wgs)
    for (int resident = 1; resident >= 0; --resident)
      if (make_plan(bf16, c_in, c1, c2, c3, wgs, resident, p)) return true;
  return false;
}
size_t partials_offset(const Plan& p) { return round_up(static_cast<int>(weights_bytes(p)), 256); }

struct Params {
  const void* x;  // [B, N, c_in] of T
  int N, c_in, c1, c2, c3, chunks, tiles_per_chunk;
  // persistent: B rows of T tiles, `per` (batch row, tile) pairs a CTA, a
  // CTA's run touching at most R rows
  int B, T, per, R;
  const void* w1;  // [c_in, c1] of T
  const float *b1, *b2, *g2, *be2, *b3, *g3, *be3;
  const unsigned char* wprep;  // (W1,) W2, W3 chunks written by prep_weights_kernel
  float* part_v;               // [slots, c3]: chunked [B, chunks], persistent [CTAs, R, 2]
  int32_t* part_i;             // [slots, c3]
  Plan plan;
};

// ----------------------------------------------------------- weight prep
// W [K, N] (row-major, T) -> K-chunks of 16 rows, each in the K-major
// core-matrix layout of a wgmma B operand: element (n, kk) at
// (n/8)*SBO + (kk/E)*128 + (n%8)*16 + (kk%E)*esz, SBO = (16/E)*128.  f32 is
// split into a TF32 high part and a TF32 remainder (the lo part follows the
// hi part inside each chunk).  Padding (k >= K or n >= N) is zero.  W1
// comes first when the plan runs layer 1 as a wgmma (nc1 > 0).
template <typename T>
__global__ void prep_weights_kernel(const T* __restrict__ w1, const T* __restrict__ w2,
                                    const T* __restrict__ w3, Plan p, int c_in, int c1, int c2, int c3,
                                    unsigned char* __restrict__ out) {
  const int n1 = p.nc1 > 0 ? p.np1 * p.kp0 : 0, n2 = p.np2 * p.kp1, n3 = p.np3 * p.kp2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n1 + n2 + n3) return;
  const int l = i < n1 ? 1 : i < n1 + n2 ? 2 : 3;
  const int j = l == 1 ? i : l == 2 ? i - n1 : i - n1 - n2;
  const int np = l == 1 ? p.np1 : l == 2 ? p.np2 : p.np3;
  const int n = j % np, k = j / np;
  const int K = l == 1 ? c_in : l == 2 ? c1 : c2, N = l == 1 ? c1 : l == 2 ? c2 : c3;
  const T* w = l == 1 ? w1 : l == 2 ? w2 : w3;
  const int chunk_bytes = l == 1 ? p.chunk1 : l == 2 ? p.chunk2 : p.chunk3;
  const size_t first = l == 1 ? 0 : l == 2 ? static_cast<size_t>(p.nc1) * p.chunk1 : chunk_offset(p, p.nc2);
  unsigned char* base = out + first + static_cast<size_t>(k / kKChunk) * chunk_bytes;
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

// Copy the x rows [p0, p0 + valid) of batch row b into `dst`, in 4-byte
// words over the 4-byte-aligned span that holds them, by `n` threads of
// which this is thread `i`.  Returns the byte offset of the tile's first
// element inside the buffer.
template <typename T>
__device__ __forceinline__ int load_x(const Params& prm, unsigned char* dst, int b, int p0, int valid, int i,
                                      int n) {
  const size_t start = (static_cast<size_t>(b) * prm.N + p0) * prm.c_in * sizeof(T);
  const size_t end = start + static_cast<size_t>(valid) * prm.c_in * sizeof(T);
  const size_t a0 = start & ~size_t(3);
  const int words = static_cast<int>((end - a0 + 3) / 4);
  const unsigned char* src = static_cast<const unsigned char*>(prm.x) + a0;
  for (; i < words; i += n) cp_async4(dst + 4 * i, src + 4 * i);
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
    x_off[0] = load_x<T>(prm, sm.x, b, p_begin, min(p.rows, p_end - p_begin), threadIdx.x, blockDim.x);
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
      x_off[(t + 1) & 1] = load_x<T>(prm, sm.x + ((t + 1) & 1) * p.xbytes, b, p1, min(p.rows, p_end - p1),
                                    threadIdx.x, blockDim.x);
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

// ------------------------------------------------- bf16 persistent body
constexpr int kOrderBar = 3;       // named barriers 3 + w: warpgroup w's turn at the layer-3 product
constexpr int kMaxRunTiles = 1024;  // tiles of 64 points a run at most: a partial's index fits 16 bits

__device__ __forceinline__ void order_wait(int w) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kOrderBar + w), "n"(2 * kWG) : "memory");
}
__device__ __forceinline__ void order_pass(int w) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(kOrderBar + w), "n"(2 * kWG) : "memory");
}

// {relu(hi), relu(lo)} rounded to bf16 and packed as {hi << 16 | lo}: the
// conversion clamps, which is the same as rounding after the ReLU.
__device__ __forceinline__ uint32_t bf16x2_relu_bits(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// Copy the x rows of (batch row, tile) pair `gt` into `dst`, by the threads
// of one warpgroup; returns the tile's offset inside the buffer.
__device__ __forceinline__ int load_x_wg(const Params& prm, int gt, unsigned char* dst) {
  const int b = gt / prm.T, p0 = 64 * (gt - b * prm.T);
  return load_x<__nv_bfloat16>(prm, dst, b, p0, min(64, prm.N - p0), threadIdx.x % kWG, kWG);
}

// x rows [0, valid) of a tile (c_in bf16 a row at `xt`) -> the warpgroup's
// layer-1 A operand [64 x kp0] in the K-major core-matrix layout, zero past
// the valid rows and past c_in.  A thread writes one core-matrix row.
__device__ __forceinline__ void stage_x(const unsigned char* xt, int valid, int c_in, unsigned char* a1,
                                        int kp0) {
  const int groups = kp0 / 8;
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(xt);
  for (int item = threadIdx.x % kWG; item < 64 * groups; item += kWG) {
    const int r8 = item & 7, kg = (item >> 3) % groups, rg = (item >> 3) / groups;
    const int r = 8 * rg + r8;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 8 * kg + 2 * e;
      const uint32_t lo = r < valid && k < c_in ? xs[r * c_in + k] : 0u;
      const uint32_t hi = r < valid && k + 1 < c_in ? xs[r * c_in + k + 1] : 0u;
      v[e] = lo | hi << 16;
    }
    *reinterpret_cast<uint4*>(a1 + rg * groups * 128 + kg * 128 + r8 * 16) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// ReLU of the fragments of n-tiles t < nt (columns < kp), rounded to bf16
// -> the warpgroup's A operand `act` [64 x kp] in the K-major core-matrix
// layout.
// A thread's fragment element 4j+h (h < 2) of n-tile t is row A (lane/4 of
// its warp's 16), column 64t + 8j + 2q + h (q = lane % 4); 4j+2+h is row B.
__device__ __forceinline__ void store_act(const float (&acc)[128], int nt, unsigned char* act, int kp) {
  const int lane = threadIdx.x % 32, wq = (threadIdx.x % kWG) / 32, q = lane % 4;
  const int sbo = (kp / 8) * 128;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * t + 8 * j + 2 * q;
      if (col >= kp) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * wq + lane / 4 + 8 * half;
        const int off = (r / 8) * sbo + (8 * t + j) * 128 + (r % 8) * 16 + 4 * q;
        const float* f = acc + 32 * t + 4 * j + 2 * half;
        *reinterpret_cast<uint32_t*>(act + off) = bf16x2_relu_bits(f[0], f[1]);
      }
    }
  }
}

// acc + b1 on the fragments (padded columns: zero weights and bias); the
// ReLU comes with the rounding in store_act.
__device__ __forceinline__ void add_bias(float (&acc)[128], int nt, const float* bias) {
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + 64 * t + 8 * j + 2 * q);
      float* f = acc + 32 * t + 4 * j;
      f[0] += bb.x;
      f[1] += bb.y;
      f[2] += bb.x;
      f[3] += bb.y;
    }
  }
}

// Sum of squares of the row-A and row-B fragments (already less their means);
// with PAD the columns >= c are left out.
template <bool PAD>
__device__ __forceinline__ void sum_squares(const float (&acc)[128], int nt, int c, float& va, float& vb) {
  const int q = threadIdx.x % 4;
  float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* f = acc + 32 * t + 4 * j;
      const int col = 64 * t + 8 * j + 2 * q;
      const bool ok0 = !PAD || col < c, ok1 = !PAD || col + 1 < c;
      a0 = ok0 ? fmaf(f[0], f[0], a0) : a0;
      a1 = ok1 ? fmaf(f[1], f[1], a1) : a1;
      b0 = ok0 ? fmaf(f[2], f[2], b0) : b0;
      b1 = ok1 ? fmaf(f[3], f[3], b1) : b1;
    }
  }
  va = a0 + a1;
  vb = b0 + b1;
}

// Bias + LayerNorm on the fragments of the thread's rows A and B; the ReLU
// comes with the rounding to bf16 that follows.  A thread's columns come in
// adjacent pairs, so it reads the bias as float2 and gamma and beta as one
// float4, (g, g', b, b') at `gb + 2 * column`.  Padded columns (>= c) hold
// exactly 0 after the product and the bias, so they add nothing to the
// sums; they are left out of the squares, and their zero gamma and beta
// give them 0.
__device__ __forceinline__ void bias_ln_pairs(float (&acc)[128], int nt, int c, const float* bias,
                                              const float* gb) {
  const int q = threadIdx.x % 4;
  float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + 64 * t + 8 * j + 2 * q);
      float* f = acc + 32 * t + 4 * j;
      f[0] += bb.x;
      f[1] += bb.y;
      f[2] += bb.x;
      f[3] += bb.y;
      sa0 += f[0];
      sa1 += f[1];
      sb0 += f[2];
      sb1 += f[3];
    }
  }
  float sa = sa0 + sa1, sb = sb0 + sb1;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, o);
    sb += __shfl_xor_sync(0xffffffffu, sb, o);
  }
  const float inv_c = 1.f / static_cast<float>(c);
  const float mua = sa * inv_c, mub = sb * inv_c;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* f = acc + 32 * t + 4 * j;
      f[0] -= mua;
      f[1] -= mua;
      f[2] -= mub;
      f[3] -= mub;
    }
  }
  float va, vb;
  if (c < 64 * nt)
    sum_squares<true>(acc, nt, c, va, vb);
  else
    sum_squares<false>(acc, nt, c, va, vb);
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    va += __shfl_xor_sync(0xffffffffu, va, o);
    vb += __shfl_xor_sync(0xffffffffu, vb, o);
  }
  const float ra = 1.f / sqrtf(va * inv_c + kLnEps), rb = 1.f / sqrtf(vb * inv_c + kLnEps);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 g = *reinterpret_cast<const float4*>(gb + 2 * (64 * t + 8 * j + 2 * q));
      float* f = acc + 32 * t + 4 * j;
      f[0] = f[0] * ra * g.x + g.z;
      f[1] = f[1] * ra * g.y + g.w;
      f[2] = f[2] * rb * g.x + g.z;
      f[3] = f[3] * rb * g.y + g.w;
    }
  }
}

// LN3's fragments -> h3 = their ReLU rounded to bf16 -> the thread's
// running keys, one a column.  With the argmax a key is (bf16 bits of h3 <<
// 16) | (0xFFFF - the point's index in the partial): h3 >= 0 (its sign bit
// cleared, so -0 is +0), so one
// unsigned max keeps the larger value and, of equal values, the lower
// index.  Key kk = 16t + 2j + h is column 64t + 8j + 2q + h.  Without it,
// bf16 pairs (key kk/2 holds columns 64t + 8j + 2q and + 1) under a bf16
// max.  `ia` / `ib`: 0xFFFF less the partial index of rows A and B; a row
// past the tile's valid rows gives key 0, which no pooled row loses to.
template <bool WITH_IDX>
__device__ __forceinline__ void update_keys(const float (&acc)[128], int nt, uint32_t (&keys)[64], bool okA,
                                            bool okB, uint32_t ia, uint32_t ib) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* f = acc + 32 * t + 4 * j;
      const uint32_t pa = okA ? bf16x2_relu_bits(f[0], f[1]) & 0x7FFF7FFFu : 0u;
      const uint32_t pb = okB ? bf16x2_relu_bits(f[2], f[3]) & 0x7FFF7FFFu : 0u;
      const int kk = 16 * t + 2 * j;
      if (WITH_IDX) {
        keys[kk] = __vimax3_u32(keys[kk], __byte_perm(pa, ia, 0x1054), __byte_perm(pb, ib, 0x1054));
        keys[kk + 1] = __vimax3_u32(keys[kk + 1], __byte_perm(pa, ia, 0x3254), __byte_perm(pb, ib, 0x3254));
      } else {
        keys[kk / 2] = bf16x2_max(keys[kk / 2], bf16x2_max(pa, pb));
      }
    }
  }
}

// One halving exchange with the lane `mask` away: the lower lane keeps keys
// [0, HALF), the upper [HALF, 2 HALF), each reduced with its partner's, in
// keys [0, HALF).
template <bool WITH_IDX, int HALF>
__device__ __forceinline__ void halve_keys(uint32_t (&keys)[64], bool upper, int mask) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const uint32_t send = upper ? keys[i] : keys[i + HALF];
    const uint32_t keep = upper ? keys[i + HALF] : keys[i];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, mask);
    keys[i] = WITH_IDX ? max(keep, got) : bf16x2_max(keep, got);
  }
}

// A warpgroup's keys of one (CTA, batch row) run -> its partial `pv` / `pi`
// over the c3 channels, decoded to (max, first point index), the index
// counted from `seg_start`; (-inf, INT_MAX) where the warpgroup took no tile
// of the run (`had` false).  The 8 lanes that share q hold the same columns:
// three halving exchanges (lane bits 4, 3, 2) leave each lane the 8 keys
// (idx) or 4 pairs (max) of 1/8 of the columns, reduced over those lanes;
// the 4 warps then meet in shared memory.  Clears the keys.
template <bool WITH_IDX>
__device__ __forceinline__ void flush_keys(uint32_t (&keys)[64], bool had, int c3, int np3, uint32_t* red, int w,
                                           int wq, int seg_start, float* pv, int32_t* pi) {
  const int tw = threadIdx.x % kWG, lane = threadIdx.x % 32, q = lane % 4;
  constexpr int kKeys = WITH_IDX ? 64 : 32;
  if (had) {
    halve_keys<WITH_IDX, kKeys / 2>(keys, (lane >> 4) & 1, 16);
    halve_keys<WITH_IDX, kKeys / 4>(keys, (lane >> 3) & 1, 8);
    halve_keys<WITH_IDX, kKeys / 8>(keys, (lane >> 2) & 1, 4);
    // this lane's keys: original key (lane bits 4, 3, 2) * kKeys / 8 + i
    const int base = ((lane >> 2) & 7) * (kKeys / 8);
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i) {
      const int kk = base + i;
      if (WITH_IDX) {  // key kk = 16t + 2j + h is column 64t + 8j + 2q + h
        red[wq * np3 + 64 * (kk / 16) + 8 * ((kk % 16) / 2) + 2 * q + kk % 2] = keys[i];
      } else {  // pair kk = 8t + j holds columns 64t + 8j + 2q and + 1: their f32 bits, -0 as +0
        const int col = 64 * (kk / 8) + 8 * (kk % 8) + 2 * q;
        const uint32_t k = keys[i] & 0x7FFF7FFFu;
        red[wq * np3 + col] = k << 16;
        red[wq * np3 + col + 1] = k & 0xFFFF0000u;
      }
    }
  }
  warpgroup_barrier(1 + w);
  for (int c = tw; c < c3; c += kWG) {
    float v = -INFINITY;
    int32_t i = 0x7fffffff;
    if (had) {
      uint32_t k = red[c];
#pragma unroll
      for (int r = 1; r < 4; ++r) k = max(k, red[r * np3 + c]);
      v = __uint_as_float(WITH_IDX ? k & 0xFFFF0000u : k);
      i = seg_start + 0xFFFF - static_cast<int>(k & 0xFFFFu);
    }
    pv[c] = v;
    if (WITH_IDX) pi[c] = i;
  }
  warpgroup_barrier(1 + w);  // red is free again
#pragma unroll
  for (int kk = 0; kk < 64; ++kk) keys[kk] = 0u;
}

// Flush this warpgroup's partials of the rows [row, to) of the CTA's run:
// `row` with its keys (if it took a tile of it), the others as empty.
template <bool WITH_IDX>
__device__ __forceinline__ void flush_rows(const Params& prm, uint32_t (&keys)[64], int row, int to, bool had,
                                           int run0, int r_first, uint32_t* red, int w, int wq) {
  for (int r = row; r < to; ++r) {
    const size_t slot = (static_cast<size_t>(blockIdx.x) * prm.R + (r - r_first)) * 2 + w;
    const int seg_start = 64 * (max(run0, r * prm.T) - r * prm.T);
    flush_keys<WITH_IDX>(keys, had && r == row, prm.c3, prm.plan.np3, red, w, wq, seg_start,
                         prm.part_v + slot * prm.c3, prm.part_i + slot * prm.c3);
  }
}

// The bf16 body as one persistent CTA per SM.  CTA `blockIdx.x` takes the
// run of (batch row, tile) pairs [blockIdx.x * per, + per) of the B * T in
// row-major order, tiles of 64 points.  Warpgroup w takes the run's pairs
// w, w + 2, ..., each through: layer 1 (one wgmma k16 step a 16 channels of
// C_in, on the x tile staged in the wgmma layout) -> bias + ReLU -> h1,
// layer 2 -> LN + ReLU -> h2, layer 3 -> LN, the keys.  The two warpgroups
// take turns at the layer-3 product (named barriers), so that one's
// LayerNorm and keys run while the other's product is in flight; while its
// own product runs a warpgroup stages its next x tile and asks for the one
// after.  Where the run leaves a batch row each warpgroup writes its
// partial for that row.
template <bool WITH_IDX>
__device__ __forceinline__ void body_persistent(const Params& prm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = prm.plan;
  // the warpgroup and the warp inside it, broadcast so that the compiler
  // sees them warp-uniform (it serializes wgmma behind branches it cannot)
  const int w = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / kWG), 0);
  const int wq = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x % kWG / 32), 0);
  const int lane = threadIdx.x % 32;
  const int T = prm.T;
  const int run0 = blockIdx.x * prm.per;
  const int n_run = min(prm.B * T - run0, prm.per);
  const int r_first = run0 / T, r_last = (run0 + n_run - 1) / T;
  unsigned char* wsm = smem + p.o_w;
  unsigned char* act = smem + p.o_act + w * p.act_wg;
  unsigned char* a1 = smem + p.o_a1 + w * 64 * p.kp0 * 2;
  unsigned char* xb = smem + p.o_x + w * p.xbytes;
  float* b1s = reinterpret_cast<float*>(smem + p.o_b1);
  float* b2s = reinterpret_cast<float*>(smem + p.o_prm);  // then gamma2 / beta2 interleaved, b3, gamma3 / beta3
  float *gb2 = b2s + p.np2, *b3s = gb2 + 2 * p.np2, *gb3 = b3s + p.np3;
  uint32_t* red = reinterpret_cast<uint32_t*>(smem + p.o_red) + w * 4 * p.np3;
  const uint32_t w_u32 = smem_u32(wsm), act_u32 = smem_u32(act), a1_u32 = smem_u32(a1);
  auto valid_of = [&](int gt) { return min(64, prm.N - 64 * (gt % T)); };

  // Prologue: every weight, once for the whole run; each warpgroup's first
  // x tile, staged; the small parameters.
  const int wbytes = static_cast<int>(weights_bytes(p));
  for (int o = threadIdx.x * 16; o < wbytes; o += blockDim.x * 16) cp_async16(wsm + o, prm.wprep + o);
  int x_off = 0;
  if (w < n_run) x_off = load_x_wg(prm, run0 + w, xb);
  cp_async_commit();
  for (int n = threadIdx.x; n < p.np1; n += blockDim.x) b1s[n] = n < prm.c1 ? prm.b1[n] : 0.f;
  for (int n = threadIdx.x; n < p.np2; n += blockDim.x) {
    const bool ok = n < prm.c2;
    const int pair = 2 * (n & ~1) + (n & 1);
    b2s[n] = ok ? prm.b2[n] : 0.f;
    gb2[pair] = ok ? prm.g2[n] : 0.f;
    gb2[pair + 2] = ok ? prm.be2[n] : 0.f;
  }
  for (int n = threadIdx.x; n < p.np3; n += blockDim.x) {
    const bool ok = n < prm.c3;
    const int pair = 2 * (n & ~1) + (n & 1);
    b3s[n] = ok ? prm.b3[n] : 0.f;
    gb3[pair] = ok ? prm.g3[n] : 0.f;
    gb3[pair + 2] = ok ? prm.be3[n] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();  // weights, parameters, first x tiles
  if (w < n_run) stage_x(xb + x_off, valid_of(run0 + w), prm.c_in, a1, p.kp0);
  fence_proxy_async();
  __syncthreads();
  if (w + 2 < n_run) {
    x_off = load_x_wg(prm, run0 + w + 2, xb);
    cp_async_commit();
  }

  uint32_t keys[64];
#pragma unroll
  for (int kk = 0; kk < 64; ++kk) keys[kk] = 0u;
  float acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.f;
  const int turns = (n_run + 1) / 2;  // layer-3 turns of each warpgroup: warpgroup 1's last may have no tile
  const int sbo0 = (p.kp0 / 8) * 128, sbo1 = (p.kp1 / 8) * 128, sbo2 = (p.kp2 / 8) * 128;
  int turn = 0, row = r_first;
  bool had = false;
  if (w == 1) order_pass(0);  // warpgroup 0 takes the first turn
  for (int k = w; k < n_run; k += 2, ++turn) {
    const int gt = run0 + k, b = gt / T, t = gt - b * T;
    const int valid = valid_of(gt);
    if (b != row) {
      flush_rows<WITH_IDX>(prm, keys, row, b, had, run0, r_first, red, w, wq);
      row = b;
      had = false;
    }

    fence_acc(acc);
    wgmma_fence();
    for (int kc = 0; kc < p.nc1; ++kc)
      wgmma_bf16_n256(acc, make_desc(a1_u32 + kc * 256, 128, sbo0), make_desc(w_u32 + kc * p.chunk1, 128, 256), kc);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    add_bias(acc, p.nt1, b1s);
    store_act(acc, p.nt1, act, p.kp1);
    fence_proxy_async();
    warpgroup_barrier(1 + w);  // h1 written

    fence_acc(acc);
    wgmma_fence();
    for (int kc = 0; kc < p.nc2; ++kc)
      wgmma_bf16_n256(acc, make_desc(act_u32 + kc * 256, 128, sbo1), make_desc(w_u32 + chunk_offset(p, kc), 128, 256),
                      kc);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    bias_ln_pairs(acc, p.nt2, prm.c2, b2s, gb2);
    warpgroup_barrier(1 + w);  // every warp's product has read h1
    store_act(acc, p.nt2, act, p.kp2);
    fence_proxy_async();
    warpgroup_barrier(1 + w);  // h2 written

    order_wait(w);
    fence_acc(acc);
    wgmma_fence();
    for (int kc = 0; kc < p.nc3; ++kc)
      wgmma_bf16_n256(acc, make_desc(act_u32 + kc * 256, 128, sbo2),
                      make_desc(w_u32 + chunk_offset(p, p.nc2 + kc), 128, 256), kc);
    wgmma_commit();
    if (w == 0 || turn + 1 < turns) order_pass(1 - w);
    if (k + 2 < n_run) {  // while the product runs: stage the next x tile, ask for the one after
      cp_async_wait_all();
      warpgroup_barrier(1 + w);
      stage_x(xb + x_off, valid_of(gt + 2), prm.c_in, a1, p.kp0);
      fence_proxy_async();
      warpgroup_barrier(1 + w);
      if (k + 4 < n_run) {
        x_off = load_x_wg(prm, gt + 4, xb);
        cp_async_commit();
      }
    }
    wgmma_wait_all();
    fence_acc(acc);
    bias_ln_pairs(acc, p.nt3, prm.c3, b3s, gb3);
    const int rA = 16 * wq + lane / 4;
    const uint32_t ia = 0xFFFFu - static_cast<uint32_t>(64 * (t - (max(run0, b * T) - b * T)) + rA);
    update_keys<WITH_IDX>(acc, p.nt3, keys, rA < valid, rA + 8 < valid, rA < valid ? ia : 0u,
                          rA + 8 < valid ? ia - 8 : 0u);
    had = true;
  }
  flush_rows<WITH_IDX>(prm, keys, row, r_last + 1, had, run0, r_first, red, w, wq);
  if (turn < turns) order_wait(w);  // warpgroup 1's last turn, with no tile
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) pointnet_body_idx_kernel(__grid_constant__ const Params prm) {
  body<T, true>(prm);
}
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) pointnet_body_max_kernel(__grid_constant__ const Params prm) {
  body<T, false>(prm);
}
// The persistent body, a kernel of its own (T = __nv_bfloat16 only): the
// compiler decides per function whether it may keep several wgmma in
// flight, and the chunked body's products would make it serialize these.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    pointnet_body_idx_kernel_persistent(__grid_constant__ const Params prm) {
  body_persistent<true>(prm);
}
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    pointnet_body_max_kernel_persistent(__grid_constant__ const Params prm) {
  body_persistent<false>(prm);
}

// Partials -> pooled (and idx).  Row b's are those of the CTAs whose runs
// of `per` units (a row has `units`) touch it, in CTA order, W of them a
// CTA, at slot (CTA * R + the row's place in the CTA's run) * W + w.  The
// chunked body's [B, chunks] are units = chunks, per = R = W = 1.  Ties go
// to the lower point index.
template <bool WITH_IDX>
__global__ void merge_chunks_kernel(const float* __restrict__ part_v, const int32_t* __restrict__ part_i,
                                    int B, int c3, int units, int per, int R, int W,
                                    float* __restrict__ pooled, int32_t* __restrict__ idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * c3) return;
  const int b = i / c3, c = i % c3;
  const long long u0 = static_cast<long long>(b) * units;
  const int first = static_cast<int>(u0 / per), last = static_cast<int>((u0 + units - 1) / per);
  float best = -INFINITY;
  int best_i = 0x7fffffff;
  for (int cta = first; cta <= last; ++cta) {
    const int j = b - static_cast<int>(static_cast<long long>(cta) * per / units);
    for (int w = 0; w < W; ++w) {
      const size_t at = ((static_cast<size_t>(cta) * R + j) * W + w) * c3 + c;
      const float v = part_v[at];
      if (WITH_IDX) {
        const int vi = part_i[at];
        if (v > best || (v == best && vi < best_i)) {
          best = v;
          best_i = vi;
        }
      } else {
        best = fmaxf(best, v);
      }
    }
  }
  pooled[i] = best;
  if (WITH_IDX) idx[i] = best_i;
}

template <typename T, bool WITH_IDX>
int launch_typed(Params prm, unsigned char* scratch, float* pooled, int32_t* idx, const void* w1,
                 const void* w2, const void* w3, cudaStream_t stream) {
  const Plan& p = prm.plan;
  const int n_prep = (p.nc1 > 0 ? p.np1 * p.kp0 : 0) + p.np2 * p.kp1 + p.np3 * p.kp2;
  prep_weights_kernel<T><<<(n_prep + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(w1), static_cast<const T*>(w2), static_cast<const T*>(w3), p, prm.c_in, prm.c1,
      prm.c2, prm.c3, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kernel = WITH_IDX ? pointnet_body_idx_kernel<T> : pointnet_body_max_kernel<T>;
  if constexpr (sizeof(T) == 2) {
    if (p.persistent)
      kernel = WITH_IDX ? pointnet_body_idx_kernel_persistent<T> : pointnet_body_max_kernel_persistent<T>;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.persistent ? prm.chunks : prm.B * prm.chunks, p.wgs * kWG, p.smem, stream>>>(prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n = prm.B * prm.c3;
  merge_chunks_kernel<WITH_IDX><<<(n + 255) / 256, 256, 0, stream>>>(
      prm.part_v, prm.part_i, prm.B, prm.c3, p.persistent ? prm.T : prm.chunks, p.persistent ? prm.per : 1,
      p.persistent ? prm.R : 1, p.persistent ? 2 : 1, pooled, idx);
  return static_cast<int>(cudaGetLastError());
}

// The launch's split, checked: the chunked body's `chunks` chunks a row, or
// the persistent body's `chunks` CTAs of `per` tiles, each with work and
// none over kMaxRunTiles.  Fills the split's part of `prm`; returns the
// partial slots (of c3 channels), or -1.
long long set_split(const Plan& plan, int B, int N, int chunks, int per, Params* prm) {
  if (B < 1 || N < 1 || chunks < 1) return -1;
  prm->B = B;
  prm->chunks = chunks;
  if (!plan.persistent) {
    const int n_tiles = (N + plan.rows - 1) / plan.rows;
    prm->tiles_per_chunk = (n_tiles + chunks - 1) / chunks;
    return static_cast<long long>(B) * chunks;
  }
  const int T = (N + 63) / 64;
  const long long total = static_cast<long long>(B) * T;
  if (per < 1 || per > kMaxRunTiles || total > 0x7fffffff || static_cast<long long>(chunks) * per < total ||
      static_cast<long long>(chunks - 1) * per >= total)
    return -1;
  prm->T = T;
  prm->per = per;
  prm->R = (per + T - 2) / T + 1;
  return static_cast<long long>(chunks) * prm->R * 2;
}

template <bool WITH_IDX>
int launch(int bf16, const void* x, int B, int N, int c_in, const void* w1, const float* b1,
           int c1, const void* w2, const float* b2, const float* g2, const float* be2, int c2,
           const void* w3, const float* b3, const float* g3, const float* be3, int c3, int chunks,
           int per, void* scratch, float* pooled, int32_t* idx, void* stream) {
  Plan plan;
  if (!choose_plan(bf16, c_in, c1, c2, c3, &plan)) return -1;
  Params prm{};
  const long long slots = set_split(plan, B, N, chunks, per, &prm);
  if (slots < 0) return -1;
  unsigned char* s = static_cast<unsigned char*>(scratch);
  prm.x = x;
  prm.N = N;
  prm.c_in = c_in;
  prm.c1 = c1;
  prm.c2 = c2;
  prm.c3 = c3;
  prm.w1 = w1;
  prm.b1 = b1;
  prm.b2 = b2;
  prm.g2 = g2;
  prm.be2 = be2;
  prm.b3 = b3;
  prm.g3 = g3;
  prm.be3 = be3;
  prm.wprep = s;
  prm.part_v = reinterpret_cast<float*>(s + partials_offset(plan));
  prm.part_i = reinterpret_cast<int32_t*>(prm.part_v + slots * c3);
  prm.plan = plan;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_typed<__nv_bfloat16, WITH_IDX>(prm, s, pooled, idx, w1, w2, w3, st)
              : launch_typed<float, WITH_IDX>(prm, s, pooled, idx, w1, w2, w3, st);
}

}  // namespace

// C entry points, bound with ctypes.  `bf16` selects the compute type of x
// and W1..W3 (0: float, 1: __nv_bfloat16); biases and LayerNorm parameters
// are always f32.  The split: for the chunked body `chunks` point chunks a
// batch row (`per` unused); for the persistent body (bf16 where its weights
// fit) `chunks` CTAs, each a run of `per` (batch row, tile) pairs, at most
// 1024.  `scratch` is a device buffer of pointnet_fused_scratch_bytes(...)
// bytes.  The launchers return -1 for a shape or split the kernel does not
// take, else the cudaError_t of the launches (0 on success).

// Points per tile for these widths, or 0 if the kernel does not take them.
extern "C" int pointnet_fused_tile_rows(int bf16, int c_in, int c1, int c2, int c3) {
  Plan p;
  return choose_plan(bf16, c_in, c1, c2, c3, &p) ? p.rows : 0;
}

// 1 where these widths run the persistent body, else 0.
extern "C" int pointnet_fused_persistent(int bf16, int c_in, int c1, int c2, int c3) {
  Plan p;
  return choose_plan(bf16, c_in, c1, c2, c3, &p) ? p.persistent : 0;
}

extern "C" long long pointnet_fused_scratch_bytes(int bf16, int c_in, int c1, int c2, int c3, int B, int N,
                                                  int chunks, int per) {
  Plan p;
  Params prm{};
  if (!choose_plan(bf16, c_in, c1, c2, c3, &p)) return -1;
  const long long slots = set_split(p, B, N, chunks, per, &prm);
  return slots < 0 ? -1 : static_cast<long long>(partials_offset(p)) + 8ll * slots * c3;
}

extern "C" int pointnet_fused_fwd_idx(int bf16, const void* x, int B, int N, int c_in,
                                      const void* w1, const float* b1, int c1, const void* w2,
                                      const float* b2, const float* g2, const float* be2, int c2,
                                      const void* w3, const float* b3, const float* g3,
                                      const float* be3, int c3, int chunks, int per, void* scratch,
                                      float* pooled, int32_t* idx, void* stream) {
  return launch<true>(bf16, x, B, N, c_in, w1, b1, c1, w2, b2, g2, be2, c2, w3, b3, g3, be3, c3,
                      chunks, per, scratch, pooled, idx, stream);
}

extern "C" int pointnet_fused_fwd_max(int bf16, const void* x, int B, int N, int c_in,
                                      const void* w1, const float* b1, int c1, const void* w2,
                                      const float* b2, const float* g2, const float* be2, int c2,
                                      const void* w3, const float* b3, const float* g3,
                                      const float* be3, int c3, int chunks, int per, void* scratch,
                                      float* pooled, void* stream) {
  return launch<false>(bf16, x, B, N, c_in, w1, b1, c1, w2, b2, g2, be2, c2, w3, b3, g3, be3, c3,
                       chunks, per, scratch, pooled, nullptr, stream);
}

extern "C" const char* pointnet_fused_error_string(int err) {
  return err == -1 ? "shape not supported by the kernel"
                   : cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ===================================================================== backward
// The winner backward (sm_90a).  Replaces the plain `_winner_backward` of
// pointcloud_rl_torch/ops/pointnet_fused.py on CUDA tensors, which follows
// the JAX package's `_fused_bwd` (pointcloud_rl_tpu/ops/pointnet_fused.py;
// the TPU runs it as XLA ops, no Pallas kernel).  The max-pool routes the
// cotangent of output (b, k) through ONE winner point, so the gradient needs
// the body on R = B * K winner rows only (K = c3): per row (b, k) the
// kernel gathers x[b, idx[b, k]], recomputes a1, h1, a2, xhat2, n2, h2, a3,
// xhat3, n3 in f32 with the f32 weights, and walks back to the ten
// parameter gradients (and the row's dx when asked).  The row's cotangent is
// g[b, k] on channel k only, so LayerNorm 3's backward is written in closed
// form (no one-hot matrix):
//     dy_k = g * gamma3_k * [n3_k > 0],  m1 = dy_k / c3,  m2 = dy_k * xhat3_k / c3
//     da3_j = rstd3 * (dy_k [j == k] - m1 - xhat3_j * m2)
// Layers 2 and 1 are the ordinary per-row backwards.
//
// What bounds it.  Per winner row 2 (C_in c1 + c1 c2 + c2 c3) FLOP forward
// and about twice that backward; at the walker's shape (512 x 256 rows,
// widths 64/128/256) 32.7 GFLOP, 0.49 ms at the card's 67 TFLOP/s of f32
// FMA.  Everything is f32 FMA on the CUDA cores, as the JAX package's
// backward is f32: no TF32 pass anywhere.  (A 3xTF32 `mma.sync` version of
// the products was no faster on the H100 and moved the gradients by up to
// 1e-3 from the plain backward's: products a few ulps apart flip relu masks
// of pre-activations near 0.)
//
// What the design does about it.
//   * A CTA owns a contiguous run of tiles of M winner rows (64 where the
//     tile fits in shared memory, else 32).  Every per-row value of a
//     tile stays in shared memory: x rows, h1 (later a3/xhat3/da3, then h1
//     again and da1 in the same buffer), h2 (later dn2), xhat2 (later da2).
//     h1 is recomputed from x for the layer-2 weight gradient rather than
//     kept, which is what lets a 64-row tile fit.
//   * The products are register-blocked FFMA tiles: a thread computes 8x8,
//     8x4 or 4x4 outputs, a warp's lanes 4 x 8 of them (a 32 x 64 block at
//     8x8), picked from the product's shape so that every warp has a block.
//     A warp's loads of either operand then touch at most 128 bytes each,
//     side by side; the activation rows are padded by 4 floats so that the
//     lanes' rows fall in different banks.  W2, W3 and their transposes
//     (written once per call by winner_bwd_prep_kernel, zero-padded to
//     multiples of 4) stream from L2 in 16 KB chunks through four buffers:
//     the chunks of a tile's four products form one sequence (a table in
//     shared memory), three chunks of it in flight while one computes.
//   * The LayerNorm passes give each row 256 / M threads that reduce with
//     shuffles inside their group.
//   * Parameter gradients are deterministic: each CTA sums its tiles in
//     order into its own slice of scratch (weight gradients read, added and
//     written back by the thread that owns the element; vector gradients in
//     shared memory, written at the end), and winner_bwd_reduce_kernel adds
//     the slices in CTA order.  No float atomics, so repeated calls and a
//     CUDA graph's replays are bitwise equal.
//   * dx, when asked: each row's dx is written to scratch and
//     winner_bwd_dx_kernel adds them into dx in k order, one thread per
//     (batch row, channel), so duplicate winners add deterministically.

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdChunk = 4096;  // floats in each weight-chunk buffer (16 KB)
constexpr int kBwdBufs = 4;      // weight-chunk buffers: kBwdBufs - 1 chunks in flight
constexpr int kMaxChunks = 256;  // weight chunks a tile may read

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A thread tile of a product: tm x tn outputs a thread, lanes lr x (32 / lr).
struct TileCfg {
  int tm, tn, lr;
};
__host__ __device__ inline TileCfg tile_cfg(int k) {
  return k == 0 ? TileCfg{8, 8, 4} : k == 1 ? TileCfg{8, 4, 4} : TileCfg{4, 4, 4};
}
__host__ __device__ inline int warp_tiles(int rows, int cols, int k) {
  const TileCfg t = tile_cfg(k);
  return cdiv(rows, t.lr * t.tm) * cdiv(cols, (32 / t.lr) * t.tn);
}
// The largest thread tile whose warp blocks still give every warp one;
// `rows_exact`: the block's rows must divide the product's.
__host__ __device__ inline int pick_tile(int rows, int cols, bool rows_exact) {
  for (int k = 0; k < 2; ++k) {
    const TileCfg t = tile_cfg(k);
    if (rows_exact && rows % (t.lr * t.tm) != 0) continue;
    if (warp_tiles(rows, cols, k) >= kBwdWarps) return k;
  }
  return 2;
}

// A prepared weight [kdp][np] as the B operand of a product, in chunks of
// kc rows.
struct WSpec {
  int off, kdp, np, kc, nch;  // off: float offset in the prepared weights
};
__host__ __device__ inline WSpec wspec(int off, int kdp, int np) {
  const int kc = imin(kdp, imax(4, kBwdChunk / np / 4 * 4));
  return WSpec{off, kdp, np, kc, cdiv(kdp, kc)};
}

// Everything about a backward launch that follows from the widths: the
// tile, the padded widths and row strides, the shared-memory map, the
// prepared weights, their chunks, and the layout of the ten gradients.
struct BwdPlan {
  int c_in, c1, c2, c3;      // widths
  int cinp, c1p, c2p, c3p;   // padded to multiples of 4
  int ld1, ld2, ld3;         // shared-memory row strides of the width-c1, c2, c3 buffers
  int M;                     // winner rows per tile
  // shared-memory offsets in floats; `smem` in bytes
  int o_w, o_tab, o_w1, o_xs, o_a, o_h2, o_x2, o_vec, o_acc, o_row, smem;
  // prepared weights (float offsets in scratch): W2 [c1p][c2p], W3 [c2p][c3p], W3^T, W2^T
  WSpec ws[4];
  int wfloats;
  int reps[4], per_tile;     // passes of each product over its chunks; chunks a tile reads
  // gradients (float offsets): dW1 [c_in][c1], db1, dW2 [c1][c2], db2, dg2, dbe2, dW3 [c2][c3], db3, dg3, dbe3
  int g_w1, g_b1, g_w2, g_b2, g_g2, g_be2, g_w3, g_b3, g_g3, g_be3, P;
  int pstride;               // floats between two CTAs' partials (P rounded up to 4)
};

bool make_bwd_plan(int c_in, int c1, int c2, int c3, int M, BwdPlan* p) {
  p->c_in = c_in; p->c1 = c1; p->c2 = c2; p->c3 = c3;
  p->cinp = round_up(c_in, 4); p->c1p = round_up(c1, 4); p->c2p = round_up(c2, 4); p->c3p = round_up(c3, 4);
  p->ld1 = p->c1p + 4; p->ld2 = p->c2p + 4; p->ld3 = p->c3p + 4;
  p->M = M;
  int w = 0;
  p->ws[0] = wspec(w, p->c1p, p->c2p); w += p->c1p * p->c2p;  // W2
  p->ws[1] = wspec(w, p->c2p, p->c3p); w += p->c2p * p->c3p;  // W3
  p->ws[2] = wspec(w, p->c3p, p->c2p); w += p->c3p * p->c2p;  // W3^T
  p->ws[3] = wspec(w, p->c2p, p->c1p); w += p->c2p * p->c1p;  // W2^T
  p->wfloats = w;
  p->per_tile = 0;
  for (int k = 0; k < 4; ++k) {
    p->reps[k] = cdiv(warp_tiles(M, p->ws[k].np, pick_tile(M, p->ws[k].np, true)), kBwdWarps);
    p->per_tile += p->reps[k] * p->ws[k].nch;
  }
  const int nv = p->c1p + 3 * p->c2p + 3 * p->c3p;
  int o = 0;
  p->o_w = o;   o += kBwdBufs * kBwdChunk;
  p->o_tab = o; o += 2 * kMaxChunks;
  p->o_w1 = o;  o += p->cinp * p->c1p;
  p->o_xs = o;  o += M * p->cinp;
  p->o_a = o;   o += M * std::max(p->ld1, p->ld3);
  p->o_h2 = o;  o += M * p->ld2;
  p->o_x2 = o;  o += M * p->ld2;
  p->o_vec = o; o += nv;
  p->o_acc = o; o += nv;
  p->o_row = o; o += 8 * M;
  p->smem = 4 * o;
  int g = 0;
  p->g_w1 = g; g += c_in * c1;
  p->g_b1 = g; g += c1;
  p->g_w2 = g; g += c1 * c2;
  p->g_b2 = g; g += c2;
  p->g_g2 = g; g += c2;
  p->g_be2 = g; g += c2;
  p->g_w3 = g; g += c2 * c3;
  p->g_b3 = g; g += c3;
  p->g_g3 = g; g += c3;
  p->g_be3 = g; g += c3;
  p->P = g;
  p->pstride = round_up(g, 4);
  return p->smem <= kMaxSmem && p->per_tile <= kMaxChunks;
}

// The larger tile (64 or 32 rows) whose buffers fit in shared memory:
// every width up to 256 fits at 32, and c2 = c3 = 256 (64/256/256) needs it.
bool choose_bwd_plan(int c_in, int c1, int c2, int c3, BwdPlan* p) {
  if (c_in < 1 || c1 < 1 || c2 < 1 || c3 < 1 || c_in > kMaxWidth || c1 > kMaxWidth || c2 > kMaxWidth ||
      c3 > kMaxWidth)
    return false;
  return make_bwd_plan(c_in, c1, c2, c3, 64, p) || make_bwd_plan(c_in, c1, c2, c3, 32, p);
}

// Scratch: the prepared weights, then a partial of the gradients per CTA,
// then (with dx) each winner row's dx.
size_t bwd_partials_offset(const BwdPlan& p) { return round_up(p.wfloats, 64); }
size_t bwd_dxw_offset(const BwdPlan& p, int ctas) {
  return bwd_partials_offset(p) + round_up(ctas * p.pstride, 64);
}

struct BwdParams {
  const void* x;         // [B, N, c_in] of T
  const int32_t* idx;    // [B, K] winner point per output channel
  const float* g;        // [B, K] pooled-output cotangent
  const float *w1, *b1, *b2, *g2, *be2, *b3, *g3, *be3;
  const float* wprep;    // written by winner_bwd_prep_kernel
  float* part;           // [ctas][pstride]
  float* dxw;            // [rows][c_in], or null without dx
  int N, K, rows, tiles, per;  // per: tiles per CTA
  BwdPlan plan;
};

// W [K, N] -> zero-padded W2 [c1p][c2p] and W3 [c2p][c3p], and the
// transposes W3^T [c3p][c2p] and W2^T [c2p][c1p] that the backward products
// stream.
__global__ void winner_bwd_prep_kernel(const float* __restrict__ w2, const float* __restrict__ w3, BwdPlan p,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.wfloats) return;
  float v = 0.f;
  if (i < p.ws[1].off) {
    const int r = i / p.c2p, c = i % p.c2p;
    if (r < p.c1 && c < p.c2) v = w2[r * p.c2 + c];
  } else if (i < p.ws[2].off) {
    const int j = i - p.ws[1].off, r = j / p.c3p, c = j % p.c3p;
    if (r < p.c2 && c < p.c3) v = w3[r * p.c3 + c];
  } else if (i < p.ws[3].off) {
    const int j = i - p.ws[2].off, r = j / p.c2p, c = j % p.c2p;
    if (r < p.c3 && c < p.c2) v = w3[c * p.c3 + r];
  } else {
    const int j = i - p.ws[3].off, r = j / p.c1p, c = j % p.c1p;
    if (r < p.c2 && c < p.c1) v = w2[c * p.c2 + r];
  }
  out[i] = v;
}

// The weight chunks a CTA reads, in the order its products read them: per
// tile the chunks of W2, W3, W3^T and W2^T (each once per pass of its
// product), listed in `tab` as (float offset, 16-byte copies).  `requested`
// chunks have been asked for; chunk i goes to buffer i % kBwdBufs.
struct WStream {
  const float* w;
  const int* tab;
  float* buf;
  int per_tile, total, requested;
};

// Ask for the next chunk (an empty group past the last): one commit group a chunk.
__device__ __forceinline__ void stream_request(WStream& st) {
  if (st.requested < st.total) {
    const int e = st.requested % st.per_tile;
    const float* src = st.w + st.tab[2 * e];
    const int n16 = st.tab[2 * e + 1];
    float* dst = st.buf + (st.requested % kBwdBufs) * kBwdChunk;
    for (int i = threadIdx.x; i < n16; i += kBwdThreads) cp_async16(dst + 4 * i, src + 4 * i);
  }
  cp_async_commit();
  ++st.requested;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// The products read their operands unguarded: a block that overhangs the
// product's columns reads past a row's end (into the next row or the next
// buffer of shared memory), and the outputs those reads feed are never
// stored.
//
// C [M x np] = A [M x kdp] (shared memory, row stride lda) * the stream's
// next weight `s`; `epi(r, n, float4)` stores outputs n..n+3 of row r.
// A warp computes blocks of LR * TM rows x (32 / LR) * TN columns; a
// thread the rows m0 + i LR + lr and the column groups n0 + g 4 LC + 4 lc.
// `gc` counts the chunks this CTA consumed.
template <int TM, int TN, int LR, class Epi>
__device__ __forceinline__ void gemm_w_t(const float* A, int lda, int M, const WSpec s, WStream& st, int& gc,
                                         Epi epi) {
  constexpr int LC = 32 / LR, G = TN / 4, WM = LR * TM, WN = LC * TN;
  const int np = s.np, kc = s.kc, kdp = s.kdp, nch = s.nch;
  const int wtn = cdiv(np, WN), tiles = (M / WM) * wtn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, lr = lane / LC, lc = lane % LC;
  for (int rd = 0; rd < cdiv(tiles, kBwdWarps); ++rd) {
    const int wt = rd * kBwdWarps + warp;
    const bool active = wt < tiles;
    const int m0 = active ? wt / wtn * WM : 0, n0 = active ? wt % wtn * WN : 0;
    bool ok[G];
#pragma unroll
    for (int g = 0; g < G; ++g) ok[g] = n0 + g * 4 * LC + 4 * lc < np;
    float acc[TM][G][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][g][j] = 0.f;
    for (int c = 0; c < nch; ++c, ++gc) {
      cp_async_wait_group<kBwdBufs - 2>();
      __syncthreads();  // chunk gc landed; every thread is done with chunk gc - 1's buffer
      stream_request(st);  // chunk gc + kBwdBufs - 1, into that buffer
      if (!active) continue;
      const float* B = st.buf + (gc % kBwdBufs) * kBwdChunk + n0 + 4 * lc;
      const float* Ar = A + (m0 + lr) * lda + c * kc;
      const int kn = imin(kc, kdp - c * kc);
#pragma unroll 1
      for (int kk = 0; kk < kn; kk += 4) {
        float4 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = ld4(Ar + i * LR * lda + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4 b[G];
#pragma unroll
          for (int g = 0; g < G; ++g)
            b[g] = ld4(B + (kk + q) * np + g * 4 * LC);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int g = 0; g < G; ++g) fma4(acc[i][g], comp(a[i], q), b[g]);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (ok[g])
            epi(m0 + i * LR + lr, n0 + g * 4 * LC + 4 * lc,
                make_float4(acc[i][g][0], acc[i][g][1], acc[i][g][2], acc[i][g][3]));
    }
  }
}

template <class Epi>
__device__ __forceinline__ void gemm_w(const float* A, int lda, int M, const WSpec s, WStream& st, int& gc, Epi epi) {
  switch (pick_tile(M, s.np, true)) {
    case 0: gemm_w_t<8, 8, 4>(A, lda, M, s, st, gc, epi); break;
    case 1: gemm_w_t<8, 4, 4>(A, lda, M, s, st, gc, epi); break;
    default: gemm_w_t<4, 4, 4>(A, lda, M, s, st, gc, epi);
  }
}

// out [n1 x n2] (this CTA's partial, row-major) += A^T B over the tile's M
// rows: A [M x n1p] and B [M x n2p] in shared memory.  A warp computes
// blocks of LR * TM x (32 / LR) * TN outputs; a thread the output rows
// m0 + ga 4 LR + 4 lr + e and columns n0 + gb 4 LC + 4 lc + e.  `first`: the
// CTA's first tile, whose sum is written without reading.
template <int TM, int TN, int LR>
__device__ __forceinline__ void gemm_dw_t(const float* A, int lda, int n1p, const float* Bm, int ldb, int n2p,
                                          int M, float* out, int n1, int n2, bool first) {
  constexpr int LC = 32 / LR, GA = TM / 4, GB = TN / 4, WM = LR * TM, WN = LC * TN;
  const int wtn = cdiv(n2p, WN), tiles = cdiv(n1p, WM) * wtn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, lr = lane / LC, lc = lane % LC;
  const bool vec = n2 % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int wt = warp; wt < tiles; wt += kBwdWarps) {
    const int m0 = wt / wtn * WM + 4 * lr, n0 = wt % wtn * WN + 4 * lc;
    float acc[TM][GB][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][g][j] = 0.f;
#pragma unroll 1
    for (int r = 0; r < M; ++r) {
      float4 a[GA], b[GB];
#pragma unroll
      for (int g = 0; g < GA; ++g) a[g] = ld4(A + r * lda + m0 + g * 4 * LR);
#pragma unroll
      for (int g = 0; g < GB; ++g) b[g] = ld4(Bm + r * ldb + n0 + g * 4 * LC);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int g = 0; g < GB; ++g) fma4(acc[i][g], comp(a[i / 4], i % 4), b[g]);
    }
    // Read every old value first, then write: the loads are all in flight at once.
    if (vec) {
      float4 old[TM][GB];
      if (!first) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            const int ii = m0 + i / 4 * 4 * LR + i % 4, jj = n0 + g * 4 * LC;
            if (ii < n1 && jj < n2) old[i][g] = ld4(out + static_cast<size_t>(ii) * n2 + jj);
          }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const int ii = m0 + i / 4 * 4 * LR + i % 4, jj = n0 + g * 4 * LC;
          if (ii >= n1 || jj >= n2) continue;
          float4 v = make_float4(acc[i][g][0], acc[i][g][1], acc[i][g][2], acc[i][g][3]);
          if (!first) v = make_float4(old[i][g].x + v.x, old[i][g].y + v.y, old[i][g].z + v.z, old[i][g].w + v.w);
          st4(out + static_cast<size_t>(ii) * n2 + jj, v);
        }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ii = m0 + i / 4 * 4 * LR + i % 4, jj = n0 + g * 4 * LC + j;
            if (ii < n1 && jj < n2) {
              float* o = out + static_cast<size_t>(ii) * n2 + jj;
              *o = first ? acc[i][g][j] : *o + acc[i][g][j];
            }
          }
    }
  }
}

__device__ __forceinline__ void gemm_dw(const float* A, int lda, int n1p, const float* Bm, int ldb, int n2p, int M,
                                        float* out, int n1, int n2, bool first) {
  switch (pick_tile(n1p, n2p, false)) {
    case 0: gemm_dw_t<8, 8, 4>(A, lda, n1p, Bm, ldb, n2p, M, out, n1, n2, first); break;
    case 1: gemm_dw_t<8, 4, 4>(A, lda, n1p, Bm, ldb, n2p, M, out, n1, n2, first); break;
    default: gemm_dw_t<4, 4, 4>(A, lda, n1p, Bm, ldb, n2p, M, out, n1, n2, first);
  }
}

// o[0..3] <- v where o > 0 (the relu's mask: h > 0 exactly where its input is), else 0.
__device__ __forceinline__ void mask4(float* o, const float4& v) {
  const float4 h = ld4(o);
  st4(o, make_float4(h.x > 0.f ? v.x : 0.f, h.y > 0.f ? v.y : 0.f, h.z > 0.f ? v.z : 0.f, h.w > 0.f ? v.w : 0.f));
}

// h1 = relu(x W1 + b1) on the tile's rows, [M][ld1]; a thread computes 4
// columns of a row (W1 and b1 zero-padded in shared memory).
__device__ __forceinline__ void bwd_layer1(const BwdPlan& p, const float* xs, const float* w1s, const float* b1,
                                           float* h1) {
  const int q = p.c1p / 4;
  for (int i = threadIdx.x; i < p.M * q; i += kBwdThreads) {
    const int r = i / q, j = 4 * (i % q);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < p.c_in; ++c) fma4(acc, xs[r * p.cinp + c], ld4(w1s + c * p.c1p + j));
    const float4 bias = ld4(b1 + j);
    st4(h1 + r * p.ld1 + j, make_float4(fmaxf(acc[0] + bias.x, 0.f), fmaxf(acc[1] + bias.y, 0.f),
                                        fmaxf(acc[2] + bias.z, 0.f), fmaxf(acc[3] + bias.w, 0.f)));
  }
}

// The LayerNorm passes: a row has `tpr` = kBwdThreads / M threads, aligned
// lanes of one warp; thread `sub` of them takes the column groups 4 sub,
// 4 (sub + tpr), ...
__device__ __forceinline__ float group_sum(float v, int tpr) {
  for (int o = 1; o < tpr; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Mean and 1 / sqrt(var + eps) of the c columns of row `a` (its padding is 0).
__device__ __forceinline__ void row_stats(const float* a, int c, int cp, int sub, int tpr, float& mu, float& rstd) {
  float s = 0.f;
  for (int j = 4 * sub; j < cp; j += 4 * tpr) {
    const float4 v = ld4(a + j);
    s += (v.x + v.y) + (v.z + v.w);
  }
  mu = group_sum(s, tpr) / c;
  float v2 = 0.f;
  for (int j = 4 * sub; j < cp; j += 4 * tpr) {
    const float4 v = ld4(a + j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = j + e < c ? comp(v, e) - mu : 0.f;
      v2 += d * d;
    }
  }
  rstd = 1.f / sqrtf(group_sum(v2, tpr) / c + kLnEps);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1) winner_bwd_kernel(__grid_constant__ const BwdParams prm) {
  extern __shared__ __align__(16) float sm[];
  const BwdPlan& p = prm.plan;
  const int M = p.M, c1 = p.c1, c2 = p.c2, c3 = p.c3, c1p = p.c1p, c2p = p.c2p, c3p = p.c3p;
  const int ld1 = p.ld1, ld2 = p.ld2, ld3 = p.ld3;
  int* tab = reinterpret_cast<int*>(sm + p.o_tab);
  float* w1s = sm + p.o_w1;  // W1 [cinp][c1p]
  float* xs = sm + p.o_xs;   // [M][cinp] x rows
  float* ta = sm + p.o_a;    // h1 [M][ld1] | a3 -> da3 [M][ld3] | h1 -> da1 [M][ld1]
  float* h2 = sm + p.o_h2;   // h2 -> dn2 [M][ld2]
  float* x2 = sm + p.o_x2;   // a2 -> xhat2 -> da2 [M][ld2]
  float* vb1 = sm + p.o_vec;
  float *vb2 = vb1 + c1p, *vg2 = vb2 + c2p, *vbe2 = vg2 + c2p;
  float *vb3 = vbe2 + c2p, *vg3 = vb3 + c3p, *vbe3 = vg3 + c3p;
  float* ab1 = sm + p.o_acc;
  float *ab2 = ab1 + c1p, *ag2 = ab2 + c2p, *abe2 = ag2 + c2p;
  float *ab3 = abe2 + c2p, *ag3 = ab3 + c3p, *abe3 = ag3 + c3p;
  int* rk = reinterpret_cast<int*>(sm + p.o_row);  // per row: channel k, -1 past the last row
  float *rg = sm + p.o_row + M, *rrstd2 = rg + M, *rm1 = rrstd2 + M, *rm2 = rm1 + M;
  float *rdn3 = rm2 + M, *rxk = rdn3 + M;
  const int tpr = kBwdThreads / M, lrow = threadIdx.x / tpr, sub = threadIdx.x % tpr;

  const int t_begin = blockIdx.x * prm.per, t_end = min(prm.tiles, t_begin + prm.per);
  float* part = prm.part + static_cast<size_t>(blockIdx.x) * p.pstride;
  for (int e = threadIdx.x; e < p.per_tile; e += kBwdThreads) {
    int w = e, k = 0;
    while (w >= p.reps[k] * p.ws[k].nch) {
      w -= p.reps[k] * p.ws[k].nch;
      ++k;
    }
    const WSpec& s = p.ws[k];
    const int r0 = w % s.nch * s.kc;
    tab[2 * e] = s.off + r0 * s.np;
    tab[2 * e + 1] = imin(s.kc, s.kdp - r0) * s.np / 4;
  }
  __syncthreads();
  WStream st{prm.wprep, tab, sm + p.o_w, p.per_tile, p.per_tile * imax(0, t_end - t_begin), 0};
  for (int i = 0; i < kBwdBufs - 1; ++i) stream_request(st);
  int gc = 0;

  for (int i = threadIdx.x; i < p.cinp * c1p; i += kBwdThreads) {
    const int c = i / c1p, j = i % c1p;
    w1s[i] = c < p.c_in && j < c1 ? prm.w1[c * c1 + j] : 0.f;
  }
  for (int j = threadIdx.x; j < c1p; j += kBwdThreads) {
    vb1[j] = j < c1 ? prm.b1[j] : 0.f;
    ab1[j] = 0.f;
  }
  for (int j = threadIdx.x; j < c2p; j += kBwdThreads) {
    const bool ok = j < c2;
    vb2[j] = ok ? prm.b2[j] : 0.f;
    vg2[j] = ok ? prm.g2[j] : 0.f;
    vbe2[j] = ok ? prm.be2[j] : 0.f;
    ab2[j] = ag2[j] = abe2[j] = 0.f;
  }
  for (int j = threadIdx.x; j < c3p; j += kBwdThreads) {
    const bool ok = j < c3;
    vb3[j] = ok ? prm.b3[j] : 0.f;
    vg3[j] = ok ? prm.g3[j] : 0.f;
    vbe3[j] = ok ? prm.be3[j] : 0.f;
    ab3[j] = ag3[j] = abe3[j] = 0.f;
  }

  const T* x = static_cast<const T*>(prm.x);
  for (int t = t_begin; t < t_end; ++t) {
    const bool first = t == t_begin;
    // Gather the tile's winner rows of x.  Rows past the last are zeros
    // with a zero cotangent: they add nothing.
    for (int i = threadIdx.x; i < M * p.cinp; i += kBwdThreads) {
      const int r = i / p.cinp, c = i % p.cinp, row = t * M + r;
      float v = 0.f;
      if (row < prm.rows && c < p.c_in) {
        const int b = row / prm.K;
        v = to_f32(x[(static_cast<size_t>(b) * prm.N + prm.idx[row]) * p.c_in + c]);
      }
      xs[i] = v;
    }
    for (int r = threadIdx.x; r < M; r += kBwdThreads) {
      const int row = t * M + r;
      rk[r] = row < prm.rows ? row % prm.K : -1;
      rg[r] = row < prm.rows ? prm.g[row] : 0.f;
    }
    __syncthreads();
    bwd_layer1(p, xs, w1s, vb1, ta);
    __syncthreads();
    // a2 = h1 W2 + b2
    gemm_w(ta, ld1, M, p.ws[0], st, gc, [&](int r, int n, float4 v) {
      const float4 bias = ld4(vb2 + n);
      st4(x2 + r * ld2 + n, make_float4(v.x + bias.x, v.y + bias.y, v.z + bias.z, v.w + bias.w));
    });
    __syncthreads();
    // LayerNorm 2: xhat2 in place, h2 = relu(xhat2 g2 + be2)
    {
      float* a = x2 + lrow * ld2;
      float* h = h2 + lrow * ld2;
      float mu, rstd;
      row_stats(a, c2, c2p, sub, tpr, mu, rstd);
      for (int j = 4 * sub; j < c2p; j += 4 * tpr) {
        const float4 v = ld4(a + j);
        float xh[4], hh[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xh[e] = j + e < c2 ? (comp(v, e) - mu) * rstd : 0.f;
          hh[e] = fmaxf(__fadd_rn(__fmul_rn(xh[e], vg2[j + e]), vbe2[j + e]), 0.f);
        }
        st4(a + j, make_float4(xh[0], xh[1], xh[2], xh[3]));
        st4(h + j, make_float4(hh[0], hh[1], hh[2], hh[3]));
      }
      if (sub == 0) rrstd2[lrow] = rstd;
    }
    __syncthreads();
    // a3 = h2 W3 + b3
    gemm_w(h2, ld2, M, p.ws[1], st, gc, [&](int r, int n, float4 v) {
      const float4 bias = ld4(vb3 + n);
      st4(ta + r * ld3 + n, make_float4(v.x + bias.x, v.y + bias.y, v.z + bias.z, v.w + bias.w));
    });
    __syncthreads();
    // LayerNorm 3 and its backward in closed form: da3 in place of a3.
    {
      float* a = ta + lrow * ld3;
      float mu, rstd;
      row_stats(a, c3, c3p, sub, tpr, mu, rstd);
      const int k = rk[lrow];
      float dn3 = 0.f, xk = 0.f, dy = 0.f;
      if (k >= 0) {
        xk = (a[k] - mu) * rstd;
        dn3 = __fadd_rn(__fmul_rn(xk, vg3[k]), vbe3[k]) > 0.f ? rg[lrow] : 0.f;
        dy = dn3 * vg3[k];
      }
      __syncwarp();  // the row's threads have read a3_k before it is overwritten
      const float m1 = dy / c3, m2 = dy * xk / c3;
      for (int j = 4 * sub; j < c3p; j += 4 * tpr) {
        const float4 v = ld4(a + j);
        float da[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j + e;
          const float xh = (comp(v, e) - mu) * rstd;
          da[e] = col < c3 ? rstd * ((col == k ? dy : 0.f) - m1 - xh * m2) : 0.f;
        }
        st4(a + j, make_float4(da[0], da[1], da[2], da[3]));
      }
      if (sub == 0) {
        rdn3[lrow] = dn3;
        rxk[lrow] = xk;
      }
    }
    __syncthreads();
    // db3, and dg3 / dbe3 of the rows' own channels, in row order
    for (int j = threadIdx.x; j < c3; j += kBwdThreads) {
      float sd = 0.f, sg = 0.f, sb = 0.f;
      for (int r = 0; r < M; ++r) {
        sd += ta[r * ld3 + j];
        if (rk[r] == j) {
          sg += rdn3[r] * rxk[r];
          sb += rdn3[r];
        }
      }
      ab3[j] += sd;
      ag3[j] += sg;
      abe3[j] += sb;
    }
    // dW3 += h2^T da3
    gemm_dw(h2, ld2, c2p, ta, ld3, c3p, M, part + p.g_w3, c2, c3, first);
    __syncthreads();
    // dn2 = (da3 W3^T) [n2 > 0], in place of h2
    gemm_w(ta, ld3, M, p.ws[2], st, gc, [&](int r, int n, float4 v) { mask4(h2 + r * ld2 + n, v); });
    __syncthreads();
    // LayerNorm 2 backward: the row means, then da2 in place of xhat2
    {
      const float* dn = h2 + lrow * ld2;
      const float* xh = x2 + lrow * ld2;
      float s1 = 0.f, s2 = 0.f;
      for (int j = 4 * sub; j < c2p; j += 4 * tpr) {
        const float4 d = ld4(dn + j), xv = ld4(xh + j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dy = comp(d, e) * vg2[j + e];
          s1 += dy;
          s2 += dy * comp(xv, e);
        }
      }
      s1 = group_sum(s1, tpr);
      s2 = group_sum(s2, tpr);
      if (sub == 0) {
        rm1[lrow] = s1 / c2;
        rm2[lrow] = s2 / c2;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < c2; j += kBwdThreads) {
      const float gj = vg2[j];
      float sd = 0.f, sg = 0.f, sb = 0.f;
      for (int r = 0; r < M; ++r) {
        const float dn = h2[r * ld2 + j], xh = x2[r * ld2 + j];
        const float da = rrstd2[r] * (dn * gj - rm1[r] - xh * rm2[r]);
        x2[r * ld2 + j] = da;
        sd += da;
        sg += dn * xh;
        sb += dn;
      }
      ab2[j] += sd;
      ag2[j] += sg;
      abe2[j] += sb;
    }
    // h1 again, where da3 was (the da3 product is done)
    bwd_layer1(p, xs, w1s, vb1, ta);
    __syncthreads();
    // dW2 += h1^T da2
    gemm_dw(ta, ld1, c1p, x2, ld2, c2p, M, part + p.g_w2, c1, c2, first);
    __syncthreads();
    // da1 = (da2 W2^T) [a1 > 0], in place of h1
    gemm_w(x2, ld2, M, p.ws[3], st, gc, [&](int r, int n, float4 v) { mask4(ta + r * ld1 + n, v); });
    __syncthreads();
    for (int j = threadIdx.x; j < c1; j += kBwdThreads) {
      float sd = 0.f;
      for (int r = 0; r < M; ++r) sd += ta[r * ld1 + j];
      ab1[j] += sd;
    }
    // dW1 += x^T da1
    gemm_dw(xs, p.cinp, p.cinp, ta, ld1, c1p, M, part + p.g_w1, p.c_in, c1, first);
    if (prm.dxw != nullptr) {
      for (int i = threadIdx.x; i < M * p.c_in; i += kBwdThreads) {
        const int r = i / p.c_in, c = i % p.c_in, row = t * M + r;
        if (row >= prm.rows) continue;
        float acc = 0.f;
        for (int j = 0; j < c1; ++j) acc = fmaf(ta[r * ld1 + j], w1s[c * c1p + j], acc);
        prm.dxw[static_cast<size_t>(row) * p.c_in + c] = acc;
      }
    }
    __syncthreads();  // the next tile overwrites xs and ta
  }

  for (int j = threadIdx.x; j < c1; j += kBwdThreads) part[p.g_b1 + j] = ab1[j];
  for (int j = threadIdx.x; j < c2; j += kBwdThreads) {
    part[p.g_b2 + j] = ab2[j];
    part[p.g_g2 + j] = ag2[j];
    part[p.g_be2 + j] = abe2[j];
  }
  for (int j = threadIdx.x; j < c3; j += kBwdThreads) {
    part[p.g_b3 + j] = ab3[j];
    part[p.g_g3 + j] = ag3[j];
    part[p.g_be3 + j] = abe3[j];
  }
}

// The CTAs' partials -> the gradients, added in CTA order.
__global__ void winner_bwd_reduce_kernel(const float* __restrict__ part, int ctas, int pstride, int P,
                                         float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  float s = part[i];
  for (int c = 1; c < ctas; ++c) s += part[static_cast<size_t>(c) * pstride + i];
  out[i] = s;
}

// dx [B, N, c_in] (f32, zeroed) += each winner row's dx at its point, in k
// order: one thread per (batch row, channel) owns that column of dx.
__global__ void winner_bwd_dx_kernel(const float* __restrict__ dxw, const int32_t* __restrict__ idx, int B, int N,
                                     int K, int c_in, float* __restrict__ dx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * c_in) return;
  const int b = i / c_in, c = i % c_in;
  for (int k = 0; k < K; ++k) {
    const size_t row = static_cast<size_t>(b) * K + k;
    dx[(static_cast<size_t>(b) * N + idx[row]) * c_in + c] += dxw[row * c_in + c];
  }
}

template <typename T>
int launch_bwd_typed(const BwdParams& prm, const float* w2, const float* w3, float* wprep, int ctas, int B,
                     float* grads, float* dx, cudaStream_t st) {
  const BwdPlan& p = prm.plan;
  winner_bwd_prep_kernel<<<(p.wfloats + 255) / 256, 256, 0, st>>>(w2, w3, p, wprep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(winner_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  winner_bwd_kernel<T><<<ctas, kBwdThreads, p.smem, st>>>(prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  winner_bwd_reduce_kernel<<<(p.P + 255) / 256, 256, 0, st>>>(prm.part, ctas, p.pstride, p.P, grads);
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return static_cast<int>(err);
  winner_bwd_dx_kernel<<<(B * p.c_in + 255) / 256, 256, 0, st>>>(prm.dxw, prm.idx, B, prm.N, prm.K, p.c_in, dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Winner rows per tile of the backward for these widths, or 0 if it does
// not take them.
extern "C" int pointnet_fused_bwd_tile_rows(int c_in, int c1, int c2, int c3) {
  BwdPlan p;
  return choose_bwd_plan(c_in, c1, c2, c3, &p) ? p.M : 0;
}

extern "C" long long pointnet_fused_bwd_scratch_bytes(int c_in, int c1, int c2, int c3, int ctas, int rows,
                                                      int with_dx) {
  BwdPlan p;
  if (!choose_bwd_plan(c_in, c1, c2, c3, &p) || ctas < 1 || rows < 1) return -1;
  return 4ll * (static_cast<long long>(bwd_dxw_offset(p, ctas)) +
                (with_dx ? static_cast<long long>(rows) * c_in : 0));
}

// The ten parameter gradients, f32, into `grads` in the order (and shapes)
// dW1 [c_in, c1], db1, dW2 [c1, c2], db2, dg2, dbe2, dW3 [c2, c3], db3, dg3,
// dbe3, packed; with `dx` non-null (f32 [B, N, c_in], zeroed) the input
// gradient is added into it.  x is [B, N, c_in] of float (bf16 = 0) or
// __nv_bfloat16 (bf16 = 1); every weight is f32.  `ctas` CTAs take `per`
// tiles of winner rows each (the last CTA the rest), as the caller chose
// them; `scratch` holds pointnet_fused_bwd_scratch_bytes(..., ctas, ...)
// bytes.  Returns -1 for a shape it does not take or a split that leaves a
// tile or a CTA without work, else the cudaError_t of the launches.
extern "C" int pointnet_fused_bwd(int bf16, const void* x, int B, int N, int c_in, const int32_t* idx,
                                  const float* g, const float* w1, const float* b1, int c1, const float* w2,
                                  const float* b2, const float* g2, const float* be2, int c2, const float* w3,
                                  const float* b3, const float* g3, const float* be3, int c3, int ctas,
                                  int per, void* scratch, float* grads, float* dx, void* stream) {
  BwdPlan plan;
  if (B < 1 || N < 1 || ctas < 1 || per < 1 || !choose_bwd_plan(c_in, c1, c2, c3, &plan)) return -1;
  const int rows = B * c3;
  const int tiles = cdiv(rows, plan.M);
  if (static_cast<long long>(ctas) * per < tiles || static_cast<long long>(ctas - 1) * per >= tiles) return -1;
  float* s = static_cast<float*>(scratch);
  const BwdParams prm{x, idx, g, w1, b1, b2, g2, be2, b3, g3, be3, s, s + bwd_partials_offset(plan),
                      dx != nullptr ? s + bwd_dxw_offset(plan, ctas) : nullptr, N, c3, rows, tiles, per, plan};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_typed<__nv_bfloat16>(prm, w2, w3, s, ctas, B, grads, dx, st)
              : launch_bwd_typed<float>(prm, w2, w3, s, ctas, B, grads, dx, st);
}
