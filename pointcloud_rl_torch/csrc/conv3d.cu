// Dense 3-D convolution for Hopper (sm_90a) in f32: the forward, the input
// gradient and the weight gradient of the voxel encoder's strided Conv3d,
// each one launch, on the channels-last grids the encoder keeps.
//
// No TPU kernel of the JAX package is replaced: its voxel convolutions are
// XLA's `lax.conv_general_dilated` (pointcloud_rl_tpu/models/voxel.py).  The
// port ran them through cuDNN, whose f32 kernels reached 11-19 TFLOP/s at
// the encoder's shapes; these kernels are the port's own.
//
// Layouts (the wrapper `ops/conv.py` checks them):
//   x   [B, D, H, W, Ci]    the input grid, channels last (a [B, Ci, D, H, W]
//                            tensor with channels_last_3d strides)
//   w   [Co, Ci, k, k, k]   torch's weight layout, read as it is
//   y   [B, Do, Ho, Wo, Co] the output grid, channels last
// with the encoder's cube kernel k = 4 and stride s = 2 on every axis, a low
// padding per axis (the high side is whatever the output size leaves), and
// channel counts that are multiples of 4 (a 16-byte granule never straddles
// a row).  Every configuration of the voxel encoder convolves so; the entry
// points refuse any other kernel or stride.
//
// Arithmetic.  Every product is an f32 FFMA, one rounding per multiply-add:
// no tensor-core instruction, no TF32, no float atomics.  Each output is
// one chain of FFMAs in a fixed order, and the weight gradient's split over
// sites is summed in chunk order by the tile's last CTA, so repeated calls
// and CUDA-graph replays are bitwise equal.  The forward's chain runs in the
// order of the weight layout (input channel, then kx, ky, kz) from zero, the
// bias added after it.  With the cuDNN build the port was measured with, that
// is also cuDNN's f32 forward bit for bit at the encoder's shapes; the
// kernels are held to the f64 convolution and to cuDNN's gap to it, not to
// cuDNN's bits, which another cuDNN may change.
//
// What bounds them.  At the encoder's shapes (512 clouds; 32^3 x 32 ->
// 16^3 x 64 -> 8^3 x 64 -> 4^3 x 128, k 4, s 2) each call does 34-550
// GFLOP on 4-268 MB of grids: hundreds of FLOP per byte, so the bound is
// the card's f32 FMA rate, 67 TFLOP/s.  Each kernel is register-blocked on
// the CUDA cores: 256 threads, each an 8 x 8 tile of outputs, its operands
// staged in shared memory by cp.async, the next ones in flight while the
// current ones are multiplied.
//
//   fprop  a direct convolution over a box of 256 (Co <= 64) or 128 output
//          sites.  The box's input halo is staged 4 channels at a time, a
//          plane a channel, double-buffered (the next chunk's rows come in
//          portions while the current chunk is multiplied); the weights in
//          slabs of one channel and one kx plane (16 consecutive taps,
//          16-byte granules of torch's layout).  A thread reads its 8 sites'
//          inputs of a (kx, ky) row as float2 pairs (the stride and the
//          kernel are even, so every offset is) and its 8 output channels'
//          weights as float4; the bias is added after the chain, the output
//          written channels last.
//   dgrad  an input site takes k/s = 2 taps per axis, chosen by its parity
//          (x + pad) mod 2: 8 classes, each a dense GEMM with M = the
//          class's sites, N = Ci, K = 8 taps x Co, gathering rows of dy
//          (two taps x 8 channels a slab of 16, a ring of 3).
//          A slab's 16 products are summed apart and then added, so a
//          chain is 16 long and the slabs' sum K/16.  One launch runs every
//          class (blockIdx.z) and writes every element of dx.
//   wgrad  dW[co][ci][tap] = sum over output sites of dy[site][co] *
//          x[site + tap][ci]: M = Co, N = taps x Ci, K = sites, both
//          operands rows of the grids (16-byte granules).  The sites are cut
//          into chunks (at most 8192 sites, enough chunks to give every SM 4
//          CTAs); a CTA sums each slab's 16 sites apart and adds them up,
//          writes its partial tile to scratch, takes a ticket, and the
//          tile's last CTA sums the partials in chunk order and resets the
//          ticket.  db is summed from the staged dy slabs by
//          the CTAs of the first N tile (a slab's 16 sites apart, then
//          added), and reduced the same way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;     // K per slab
constexpr int kStages = 3;  // slabs in the ring
constexpr int kK = 4;       // the cube kernel every entry point takes
constexpr int kS = 2;       // and its stride
constexpr int kTaps = kK * kK * kK;
constexpr int kMaxChunkSites = 8192;  // the weight gradient's longest chain over sites
constexpr int kCtasPerSm = 4;         // the weight gradient's chunks fill the SMs this many times

struct Geom {
    int B, D, H, W, Ci;    // input grid
    int Do, Ho, Wo, Co;    // output grid
    int k, s, pd, ph, pw;  // cube kernel, stride, low padding
};

// n / d for n < 2^31 by a multiply and a shift (the round-up method).
struct FastDiv {
    unsigned d, m, s;
};

FastDiv make_div(unsigned d) {
    unsigned s = 0;
    while (s < 32 && (1ull << s) < d) ++s;
    unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
    return FastDiv{d, static_cast<unsigned>(m), s};
}

__device__ __forceinline__ unsigned fdiv(unsigned n, const FastDiv& f) {
    return (__umulhi(n, f.m) + n) >> f.s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
    unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
    unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_ring() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// A thread's place in the 8 x 8 register tiles: a warp covers WN column
// groups by 32 / WN row groups, so its A reads touch few rows and its B
// reads one contiguous run.
template <int BM, int BN>
struct ThreadTile {
    static constexpr int TM = BM / 8, TN = BN / 8, WN = TN < 8 ? TN : 8, WM = 32 / WN;
    static_assert(TM * TN == kThreads, "256 threads of 8 x 8 outputs");
    int tm, tn;
    __device__ ThreadTile(int tid) {
        int warp = tid >> 5, lane = tid & 31;
        tn = (warp % (TN / WN)) * WN + lane % WN;
        tm = (warp / (TN / WN)) * WM + lane / WN;
    }
};

// One slab's products.  B is k-major [kBK][BN + 4]: a thread reads its
// columns tn*4.. and BN/2 + tn*4.. as float4.  A is either m-major
// [BM][kBK + 4] (dgrad's gathered rows; a thread's rows are tm + TM*i) or
// k-major [kBK][BM + 4] (wgrad; rows tm*4.. and BM/2 + tm*4..).
template <int BM, int BN, bool A_KMAJOR>
__device__ __forceinline__ void slab_products(const float* As, const float* Bs, const ThreadTile<BM, BN>& tt,
                                              float (&acc)[8][8]) {
    constexpr int TM = ThreadTile<BM, BN>::TM;
#pragma unroll
    for (int kq = 0; kq < kBK / 4; ++kq) {
        float a[8][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            if (A_KMAJOR) {
                const float* row = As + (4 * kq + kk) * (BM + 4);
                float4 v0 = *reinterpret_cast<const float4*>(row + tt.tm * 4);
                float4 v1 = *reinterpret_cast<const float4*>(row + BM / 2 + tt.tm * 4);
                a[0][kk] = v0.x; a[1][kk] = v0.y; a[2][kk] = v0.z; a[3][kk] = v0.w;
                a[4][kk] = v1.x; a[5][kk] = v1.y; a[6][kk] = v1.z; a[7][kk] = v1.w;
            }
        }
        if (!A_KMAJOR) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float4 v = *reinterpret_cast<const float4*>(As + (tt.tm + TM * i) * (kBK + 4) + 4 * kq);
                a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
            }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const float* row = Bs + (4 * kq + kk) * (BN + 4);
            float4 w0 = *reinterpret_cast<const float4*>(row + tt.tn * 4);
            float4 w1 = *reinterpret_cast<const float4*>(row + BN / 2 + tt.tn * 4);
            float b[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
        }
    }
}

// ------------------------------------------------------------------ fprop
// A direct convolution over a box of output sites.  The input the box reads
// (its halo) is staged in shared memory 4 channels at a time, one plane a
// channel, double-buffered: the next chunk's rows are copied in portions
// while the current chunk is multiplied.  The weights come in slabs of one
// channel and one kx plane (k^2 taps) from torch's layout, 16-byte granules
// of consecutive taps.  Each output's chain runs channel outer, then kx, ky,
// kz: the order of the weight layout [Co][Ci][k][k][k].
struct ForwardArgs {
    const float* x;
    const float* w;
    const float* bias;  // or null
    float* y;
    Geom g;
    int tb, tx, ty, tz;  // a CTA's box of output sites (clouds, x, y, z)
    int nbx, nby, nbz;   // boxes along x, y, z
    int hx, hy, hz;      // the halo: (t - 1) * s + k input sites along each axis
    int plane;           // floats of one channel's halo (padded: 8 mod 32 spreads a warp's writes over the banks)
};

constexpr int kHaloCh = 4;  // channels of a halo chunk

constexpr int kFpropRow = kK * kK + 4;  // a weight slab's row: k^2 taps and 4 floats of padding

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1) conv3d_fprop_kernel(ForwardArgs p) {
    extern __shared__ __align__(16) float smem[];
    constexpr int K = kK, K2 = K * K, RS = kFpropRow, B_STAGE = BN * RS;
    constexpr int TM = BM / 8, TN = BN / 8;
    constexpr int SPC = kHaloCh * K;  // slabs a chunk: its channels by kx
    const Geom& g = p.g;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int T = kTaps;
    const int halo_floats = kHaloCh * p.plane;
    float* halo = smem;
    float* Bs = smem + 2 * halo_floats;

    int bi = blockIdx.x;
    const int bz = bi % p.nbz;
    bi /= p.nbz;
    const int by = bi % p.nby;
    bi /= p.nby;
    const int bx = bi % p.nbx, bb = bi / p.nbx;
    const int b0 = bb * p.tb, ox0 = bx * p.tx, oy0 = by * p.ty, oz0 = bz * p.tz;
    const int ix0 = ox0 * g.s - g.pd, iy0 = oy0 * g.s - g.ph, iz0 = oz0 * g.s - g.pw;
    const int n0 = blockIdx.y * BN;
    const int rows = p.tb * p.hx * p.hy;
    const int chunks = g.Ci / kHaloCh;
    const int slabs = chunks * SPC;

    // A thread's outputs: box sites tm + TM i, channels n0 + tn + TN j.
    const ThreadTile<BM, BN> tt(tid);
    int hs[8];
    bool mok[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int m = tt.tm + TM * i;
        int zl = m % p.tz, r = m / p.tz, yl = r % p.ty;
        r /= p.ty;
        int xl = r % p.tx, bl = r / p.tx;
        mok[i] = bl < p.tb && b0 + bl < g.B && ox0 + xl < g.Do && oy0 + yl < g.Ho && oz0 + zl < g.Wo;
        hs[i] = mok[i] ? ((bl * p.hx + xl * g.s) * p.hy + yl * g.s) * p.hz + zl * g.s : 0;
    }

    // Rows [r0, r1) of a chunk's halo (a row: hz sites of 4 channels), a warp a row.
    auto load_halo = [&](int chunk, int r0, int r1) {
        float* hb = halo + (chunk & 1) * halo_floats;
        const int c0 = chunk * kHaloCh;
        for (int r = r0 + warp; r < r1; r += kThreads / 32) {
            int hyy = r % p.hy, q = r / p.hy, hxx = q % p.hx, hbb = q / p.hx;
            int b = b0 + hbb, ix = ix0 + hxx, iy = iy0 + hyy;
            bool row_ok = b < g.B && (unsigned)ix < (unsigned)g.D && (unsigned)iy < (unsigned)g.H;
            int rbase = row_ok ? ((b * g.D + ix) * g.H + iy) * g.W : 0;
            for (int e = lane; e < p.hz * kHaloCh; e += 32) {
                int hzz = e >> 2, c = e & 3, iz = iz0 + hzz;
                bool ok = row_ok && (unsigned)iz < (unsigned)g.W;
                cp_async4(hb + c * p.plane + r * p.hz + hzz, p.x + (ok ? (rbase + iz) * g.Ci + c0 + c : 0), ok);
            }
        }
    };
    // Slab s: channel 4 (s / SPC) + (s % SPC) / K, plane kx = s % K, every output channel of the tile.
    auto load_w = [&](int s) {
        float* bs = Bs + (s % kStages) * B_STAGE;
        int ci = (s / SPC) * kHaloCh + (s % SPC) / K, kx = s % K;
        for (int e = tid; e < BN * K2 / 4; e += kThreads) {
            int n = e / (K2 / 4), q = e % (K2 / 4);
            bool ok = n0 + n < g.Co;
            cp_async16(bs + n * RS + 4 * q, p.w + (ok ? ((n0 + n) * g.Ci + ci) * T + kx * K2 + 4 * q : 0), ok);
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // The first chunk's halo and the first slabs; then at slab s the weights
    // of slab s + 2 and a portion of the next chunk's halo, which the slabs
    // of this chunk but its last two bring in, so the wait for the first slab
    // of the next chunk finds it whole.
    load_halo(0, 0, rows);
    load_w(0);
    cp_async_commit();
    if (slabs > 1) load_w(1);
    cp_async_commit();
    constexpr int PORTIONS = SPC - 2;
    for (int s = 0; s < slabs; ++s) {
        cp_async_wait_ring();
        __syncthreads();
        const int chunk = s / SPC, sl = s % SPC;
        if (s + 2 < slabs) load_w(s + 2);
        if (chunk + 1 < chunks && sl < PORTIONS)
            load_halo(chunk + 1, rows * sl / PORTIONS, rows * (sl + 1) / PORTIONS);
        cp_async_commit();

        const float* hp = halo + (chunk & 1) * halo_floats + (sl / K) * p.plane;
        const float* bs = Bs + (s % kStages) * B_STAGE;
        const int kx = sl % K;
        // A (kx, ky) row's fragments: its 8 output channels' k weights and
        // its 8 sites' k inputs; the next row's are read while this one's
        // products run.
        float b[2][8][K], a[2][8][K];
        auto read_row = [&](int ky, float (&rb)[8][K], float (&ra)[8][K]) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                float4 v = *reinterpret_cast<const float4*>(bs + (tt.tn + TN * j) * RS + ky * K);
                rb[j][0] = v.x, rb[j][1] = v.y, rb[j][2] = v.z, rb[j][3] = v.w;
            }
            const int rowoff = (kx * p.hy + ky) * p.hz;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float* arow = hp + hs[i] + rowoff;
#pragma unroll
                for (int kz = 0; kz < K; kz += 2) {  // even offsets: the row's taps as float2
                    float2 v = *reinterpret_cast<const float2*>(arow + kz);
                    ra[i][kz] = v.x, ra[i][kz + 1] = v.y;
                }
            }
        };
        read_row(0, b[0], a[0]);
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
            if (ky + 1 < K) read_row(ky + 1, b[(ky + 1) & 1], a[(ky + 1) & 1]);
#pragma unroll
            for (int kz = 0; kz < K; ++kz)  // 64 independent FFMAs between two into one output
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[ky & 1][i][kz], b[ky & 1][j][kz], acc[i][j]);
        }
    }
    cp_async_wait_all();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        if (!mok[i]) continue;
        int m = tt.tm + TM * i;
        int zl = m % p.tz, r = m / p.tz, yl = r % p.ty;
        r /= p.ty;
        int xl = r % p.tx, bl = r / p.tx;
        long long site = ((static_cast<long long>(b0 + bl) * g.Do + ox0 + xl) * g.Ho + oy0 + yl) * g.Wo + oz0 + zl;
        float* out = p.y + site * g.Co;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            int n = n0 + tt.tn + TN * j;
            if (n < g.Co) out[n] = p.bias != nullptr ? acc[i][j] + p.bias[n] : acc[i][j];
        }
    }
}

// ------------------------------------------------------------------ dgrad
// An input site takes k/s taps per axis, chosen by its parity (x + pad)
// mod s: each of the s^3 classes is a dense GEMM (M = its sites, N = Ci,
// K = (k/s)^3 taps x Co) that gathers rows of dy tap by tap against weights
// read element by element.  blockIdx.z is the class.
struct InputGradArgs {
    const float* dy;
    const float* w;  // [Co, Ci, k, k, k]
    float* dx;
    Geom g;
};

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1) conv3d_dgrad_kernel(InputGradArgs p) {
    extern __shared__ __align__(16) float smem[];
    const Geom& g = p.g;
    const int tid = threadIdx.x;
    const int T = g.k * g.k * g.k;
    __shared__ int tap_off[kTaps], tap_bits[kTaps], tap_w[kTaps];

    // The class: sites x = r - pad + s*u, u in [lo, lo + n), per axis.
    const int cls = blockIdx.z, kt = g.k / g.s;
    const int rx = cls / (g.s * g.s), ry = (cls / g.s) % g.s, rz = cls % g.s;
    // ceil((pad - r) / s) and floor((n - 1 + pad - r) / s) with pad, r >= 0
    auto lo = [&](int pad, int r) { int v = pad - r; return v >= 0 ? (v + g.s - 1) / g.s : -((-v) / g.s); };
    auto hi = [&](int n, int pad, int r) { return (n - 1 + pad - r) / g.s; };
    const int lox = lo(g.pd, rx), loy = lo(g.ph, ry), loz = lo(g.pw, rz);
    const int nx = hi(g.D, g.pd, rx) - lox + 1, ny = hi(g.H, g.ph, ry) - loy + 1, nz = hi(g.W, g.pw, rz) - loz + 1;
    if (nx <= 0 || ny <= 0 || nz <= 0) return;
    const int taps = kt * kt * kt;
    const int M = g.B * nx * ny * nz;
    const int m0 = blockIdx.x * BM;
    if (m0 >= M) return;
    const int n0 = blockIdx.y * BN;

    const int pairs = (taps + 1) / 2;
    for (int t = tid; t < 2 * pairs; t += kThreads) {
        int off = 0, bits = 1 << 24, wt = 0;  // past the last tap: no site holds bit 24
        if (t < taps) {
            int jx = t / (kt * kt), jy = (t / kt) % kt, jz = t % kt;
            bits = (1 << jx) | (1 << (8 + jy)) | (1 << (16 + jz));
            off = -((jx * g.Ho + jy) * g.Wo + jz) * g.Co;
            wt = ((rx + g.s * jx) * g.k + (ry + g.s * jy)) * g.k + (rz + g.s * jz);
        }
        tap_off[t] = off, tap_bits[t] = bits, tap_w[t] = wt;
    }

    // The loader's rows: granule tid + 256 q is (row (tid >> 2) + 64 q, sub tid & 3):
    // tap (sub >> 1) of the slab's pair, channels (sub & 1) * 4 .. + 3 of its 8.
    constexpr int G = BM / 64;
    const int sub = tid & 3, ltq = sub >> 1, lhalf = sub & 1;
    int base[G], mask[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
        int m = m0 + (tid >> 2) + 64 * q;
        base[q] = 0, mask[q] = 0;
        if (m < M) {
            int uz = m % nz, r = m / nz, uy = r % ny;
            r /= ny;
            int ux = r % nx + lox, b = r / nx, mk = 0;
            uy += loy, uz += loz;  // this site's output is (u - j) per axis
            base[q] = (((b * g.Do + ux) * g.Ho + uy) * g.Wo + uz) * g.Co;
            for (int j = 0; j < kt; ++j) {
                mk |= ((unsigned)(ux - j) < (unsigned)g.Do) << j;
                mk |= ((unsigned)(uy - j) < (unsigned)g.Ho) << (8 + j);
                mk |= ((unsigned)(uz - j) < (unsigned)g.Wo) << (16 + j);
            }
            mask[q] = mk;
        }
    }
    // The loader's weights: column (tid >> 1) % BN, the slab's tap tid & 1 and
    // channels (tid >> 1) / BN + (128 / BN) q: a warp's two taps of a (co, ci)
    // are adjacent in memory, so it touches 16 lines, not 32.
    const int bn = (tid >> 1) % BN, btq = tid & 1, bc0 = (tid >> 1) / BN;
    const bool bnvalid = n0 + bn < g.Ci;
    const int bbase = (n0 + bn) * T;
    __syncthreads();  // the tap table

    constexpr int A_STAGE = BM * (kBK + 4), B_STAGE = kBK * (BN + 4);
    float* As = smem;
    float* Bs = smem + kStages * A_STAGE;
    const int chunks = (g.Co + 7) / 8;
    const int slabs = chunks * pairs;

    auto load = [&](int it, int slot) {
        int chunk = it / pairs, pair = it - chunk * pairs;
        float* as = As + slot * A_STAGE;
        float* bs = Bs + slot * B_STAGE;
        int t = 2 * pair + ltq, c = chunk * 8 + lhalf * 4;
        int toff = tap_off[t], tbits = tap_bits[t];
#pragma unroll
        for (int q = 0; q < G; ++q) {
            bool ok = c < g.Co && (mask[q] & tbits) == tbits;
            const float* src = p.dy + (ok ? base[q] + toff + c : 0);
            cp_async16(as + ((tid >> 2) + 64 * q) * (kBK + 4) + ltq * 8 + lhalf * 4, src, ok);
        }
#pragma unroll
        for (int q = 0; q < kBK * BN / kThreads; ++q) {
            int cc = bc0 + (kThreads / 2 / BN) * q, kr = btq * 8 + cc;
            int tb = 2 * pair + btq, cb = chunk * 8 + cc;
            bool ok = bnvalid && cb < g.Co && tb < taps;
            const float* src = p.w + (ok ? bbase + cb * g.Ci * T + tap_w[tb] : 0);
            cp_async4(bs + kr * (BN + 4) + bn, src, ok);
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    const ThreadTile<BM, BN> tt(tid);

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
        if (st < slabs) load(st, st);
        cp_async_commit();
    }
    for (int it = 0; it < slabs; ++it) {
        cp_async_wait_ring();
        __syncthreads();
        int nxt = it + kStages - 1;
        if (nxt < slabs) load(nxt, nxt % kStages);
        cp_async_commit();
        int slot = it % kStages;
        float part[8][8];  // the slab's 16 products apart, then added: chains of 16 and of the slabs
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
        slab_products<BM, BN, false>(As + slot * A_STAGE, Bs + slot * B_STAGE, tt, part);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
    }
    cp_async_wait_all();

    constexpr int TM = ThreadTile<BM, BN>::TM;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int m = m0 + tt.tm + TM * i;
        if (m >= M) continue;
        int uz = m % nz, r = m / nz, uy = r % ny;
        r /= ny;
        int ux = r % nx, b = r / nx;
        int x = rx - g.pd + g.s * (ux + lox), y = ry - g.ph + g.s * (uy + loy), z = rz - g.pw + g.s * (uz + loz);
        long long row = (((static_cast<long long>(b) * g.D + x) * g.H + y) * g.W + z) * g.Ci;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            int n = n0 + h * (BN / 2) + tt.tn * 4;
            if (n >= g.Ci) continue;
            *reinterpret_cast<float4*>(p.dx + row + n) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
    }
}

// ------------------------------------------------------------------ wgrad
struct WeightArgs {
    const float* x;
    const float* dy;
    float* dw;       // [Co, Ci, k, k, k]
    float* db;       // [Co], or null
    float* part;     // [tiles][chunks][16][256] float4: each CTA's partial tile, thread by thread
    float* part_db;  // [m tiles][chunks][BM]
    int* tickets;    // [tiles], zero between calls
    Geom g;
    FastDiv dwo, dho, ddo;
    int chunk_len, chunks;
};

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1) conv3d_wgrad_kernel(WeightArgs p) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int last;
    const Geom& g = p.g;
    const int tid = threadIdx.x;
    const int T = g.k * g.k * g.k;
    const int N = T * g.Ci;
    const int S = g.B * g.Do * g.Ho * g.Wo;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, chunk = blockIdx.z;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const int s_begin = chunk * p.chunk_len;
    const int s_end = min(S, s_begin + p.chunk_len);
    const int slabs = s_end > s_begin ? (s_end - s_begin + kBK - 1) / kBK : 0;
    const bool with_db = p.db != nullptr && blockIdx.x == 0;

    constexpr int A_STAGE = kBK * (BM + 4), B_STAGE = kBK * (BN + 4);
    float* As = smem;
    float* Bs = smem + kStages * A_STAGE;

    // dy granules: column tid % (BM/4), slab rows tid / (BM/4) + (1024 / BM) q.
    constexpr int AC = BM / 4, AQ = kBK * AC / kThreads;
    const int ac = tid % AC, ar0 = tid / AC;
    const bool acvalid = m0 + 4 * ac < g.Co;
    // x granules: column tid % (BN/4) is tap tb, channels cb .. cb + 3.
    constexpr int BC = BN / 4, BQ = kBK * BC / kThreads;
    const int bc = tid % BC, br0 = tid / BC;
    const int nb = n0 + 4 * bc;
    const bool bcvalid = nb < N;
    const int tb = bcvalid ? nb / g.Ci : 0, cb = nb - tb * g.Ci;
    const int kx = tb / (g.k * g.k), ky = (tb / g.k) % g.k, kz = tb % g.k;

    auto load = [&](int it, int slot) {
        float* as = As + slot * A_STAGE;
        float* bs = Bs + slot * B_STAGE;
        int s0 = s_begin + it * kBK;
#pragma unroll
        for (int q = 0; q < AQ; ++q) {
            int r = ar0 + (kThreads / AC) * q, site = s0 + r;
            bool ok = acvalid && site < s_end;
            cp_async16(as + r * (BM + 4) + 4 * ac, p.dy + (ok ? site * g.Co + m0 + 4 * ac : 0), ok);
        }
#pragma unroll
        for (int q = 0; q < BQ; ++q) {
            int r = br0 + (kThreads / BC) * q, site = s0 + r;
            unsigned q1 = fdiv(site, p.dwo), q2 = fdiv(q1, p.dho), b = fdiv(q2, p.ddo);
            int oz = site - q1 * g.Wo, oy = q1 - q2 * g.Ho, ox = q2 - b * g.Do;
            int ix = ox * g.s - g.pd + kx, iy = oy * g.s - g.ph + ky, iz = oz * g.s - g.pw + kz;
            bool ok = bcvalid && site < s_end && (unsigned)ix < (unsigned)g.D && (unsigned)iy < (unsigned)g.H &&
                      (unsigned)iz < (unsigned)g.W;
            int off = ok ? (((b * g.D + ix) * g.H + iy) * g.W + iz) * g.Ci + cb : 0;
            cp_async16(bs + r * (BN + 4) + 4 * bc, p.x + off, ok);
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float dbacc = 0.f;
    const ThreadTile<BM, BN> tt(tid);

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
        if (st < slabs) load(st, st);
        cp_async_commit();
    }
    for (int it = 0; it < slabs; ++it) {
        cp_async_wait_ring();
        __syncthreads();
        int nxt = it + kStages - 1;
        if (nxt < slabs) load(nxt, nxt % kStages);
        cp_async_commit();
        int slot = it % kStages;
        const float* as = As + slot * A_STAGE;
        if (with_db && tid < BM) {
            float slab = 0.f;
#pragma unroll
            for (int k = 0; k < kBK; ++k) slab += as[k * (BM + 4) + tid];
            dbacc += slab;
        }
        float part[8][8];  // the slab's 16 sites apart, then added: chains of 16 and of the chunk's slabs
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
        slab_products<BM, BN, true>(as, Bs + slot * B_STAGE, tt, part);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
    }
    cp_async_wait_all();

    // This CTA's partial, then its ticket.
    float4* part = reinterpret_cast<float4*>(p.part) + (static_cast<long long>(tile) * p.chunks + chunk) * 16 * kThreads;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
        const float* v = &acc[q >> 1][(q & 1) * 4];
        part[q * kThreads + tid] = make_float4(v[0], v[1], v[2], v[3]);
    }
    if (with_db && tid < BM) p.part_db[(static_cast<long long>(blockIdx.y) * p.chunks + chunk) * BM + tid] = dbacc;
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&p.tickets[tile], 1) == p.chunks - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();

    // The tile's last CTA: the partials summed in chunk order.
    const float4* all = reinterpret_cast<const float4*>(p.part) + static_cast<long long>(tile) * p.chunks * 16 * kThreads;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < p.chunks; ++c) {
#pragma unroll
        for (int q = 0; q < 16; ++q) {
            float4 v = __ldcg(all + (static_cast<long long>(c) * 16 + q) * kThreads + tid);
            float* a = &acc[q >> 1][(q & 1) * 4];
            a[0] += v.x, a[1] += v.y, a[2] += v.z, a[3] += v.w;
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int m = m0 + (i < 4 ? tt.tm * 4 + i : BM / 2 + tt.tm * 4 + i - 4);
        if (m >= g.Co) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            int n = n0 + (j < 4 ? tt.tn * 4 + j : BN / 2 + tt.tn * 4 + j - 4);
            if (n >= N) continue;
            int tap = n / g.Ci, ci = n - tap * g.Ci;
            p.dw[(static_cast<long long>(m) * g.Ci + ci) * T + tap] = acc[i][j];
        }
    }
    if (with_db && tid < BM && m0 + tid < g.Co) {
        float s = 0.f;
        for (int c = 0; c < p.chunks; ++c)
            s += __ldcg(p.part_db + (static_cast<long long>(blockIdx.y) * p.chunks + c) * BM + tid);
        p.db[m0 + tid] = s;
    }
    if (tid == 0) p.tickets[tile] = 0;
}

// ------------------------------------------------------------------ host
Geom make_geom(int B, int D, int H, int W, int Ci, int Do, int Ho, int Wo, int Co, int k, int s, int pd, int ph,
               int pw) {
    return Geom{B, D, H, W, Ci, Do, Ho, Wo, Co, k, s, pd, ph, pw};
}

bool geom_ok(const Geom& g) {
    return g.B > 0 && g.k == kK && g.s == kS && g.Ci % 4 == 0 && g.Co % 4 == 0 && g.Ci > 0 && g.Co > 0 &&
           g.Do > 0 && g.Ho > 0 && g.Wo > 0 && g.pd >= 0 && g.ph >= 0 && g.pw >= 0;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, void* args) {
    cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    void* params[] = {args};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid, dim3(kThreads), params, smem, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

constexpr size_t kSmemBudget = 200 * 1024;  // dynamic shared memory a CTA may ask for

// The forward's box: BM output sites, z first, then y, x and clouds, cut
// until its halo fits.
template <int BM, int BN>
cudaError_t launch_fprop(ForwardArgs a, cudaStream_t stream) {
    const Geom& g = a.g;
    a.tz = min(g.Wo, BM);
    a.ty = min(g.Ho, BM / a.tz);
    a.tx = min(g.Do, BM / (a.tz * a.ty));
    a.tb = min(g.B, max(1, BM / (a.tz * a.ty * a.tx)));
    size_t smem;
    for (;;) {
        a.hx = (a.tx - 1) * kS + kK, a.hy = (a.ty - 1) * kS + kK, a.hz = (a.tz - 1) * kS + kK;
        int sites = a.tb * a.hx * a.hy * a.hz;
        a.plane = sites + (40 - sites % 32) % 32;
        smem = sizeof(float) * (2 * kHaloCh * static_cast<size_t>(a.plane) + kStages * BN * kFpropRow);
        if (smem <= kSmemBudget) break;
        if (a.tb > 1) a.tb = (a.tb + 1) / 2;
        else if (a.tx > 1) --a.tx;
        else if (a.ty > 1) --a.ty;
        else if (a.tz > 1) --a.tz;
        else return cudaErrorInvalidConfiguration;
    }
    a.nbx = (g.Do + a.tx - 1) / a.tx, a.nby = (g.Ho + a.ty - 1) / a.ty, a.nbz = (g.Wo + a.tz - 1) / a.tz;
    int nbb = (g.B + a.tb - 1) / a.tb;
    dim3 grid(nbb * a.nbx * a.nby * a.nbz, (g.Co + BN - 1) / BN);
    return launch(conv3d_fprop_kernel<BM, BN>, grid, smem, stream, &a);
}

template <int BM, int BN>
cudaError_t launch_dgrad(InputGradArgs a, cudaStream_t stream) {
    const Geom& g = a.g;
    // the largest class: ceil(n / s) sites per axis
    int M = g.B * ((g.D + g.s - 1) / g.s) * ((g.H + g.s - 1) / g.s) * ((g.W + g.s - 1) / g.s);
    dim3 grid((M + BM - 1) / BM, (g.Ci + BN - 1) / BN, g.s * g.s * g.s);
    size_t smem = sizeof(float) * kStages * (BM * (kBK + 4) + kBK * (BN + 4));
    return launch(conv3d_dgrad_kernel<BM, BN>, grid, smem, stream, &a);
}

// The weight gradient's tile: Co <= 64 as 64 x 256, else 128 x 128.
void wgrad_tile(int Co, int* bm, int* bn) {
    *bm = Co <= 64 ? 64 : 128;
    *bn = Co <= 64 ? 256 : 128;
}

}  // namespace

extern "C" const char* conv3d_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// 0, or the cudaError of the launch; -1 for a shape the kernels do not take.
extern "C" int conv3d_fprop(const float* x, const float* w, const float* bias, float* y, int B, int D, int H, int W,
                            int Ci, int Do, int Ho, int Wo, int Co, int k, int s, int pd, int ph, int pw,
                            void* stream) {
    Geom g = make_geom(B, D, H, W, Ci, Do, Ho, Wo, Co, k, s, pd, ph, pw);
    if (!geom_ok(g)) return -1;
    ForwardArgs a{x, w, bias, y, g};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (Co <= 64) return static_cast<int>(launch_fprop<256, 64>(a, st));
    return static_cast<int>(launch_fprop<128, 128>(a, st));
}

// The input gradient's tile follows Ci: 32 wide by 512 sites, 64 by 256,
// else 128 by 128.
extern "C" int conv3d_dgrad(const float* dy, const float* w, float* dx, int B, int D, int H, int W, int Ci, int Do,
                            int Ho, int Wo, int Co, int k, int s, int pd, int ph, int pw, void* stream) {
    Geom g = make_geom(B, D, H, W, Ci, Do, Ho, Wo, Co, k, s, pd, ph, pw);
    if (!geom_ok(g)) return -1;
    InputGradArgs a{dy, w, dx, g};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (Ci <= 32) return static_cast<int>(launch_dgrad<512, 32>(a, st));
    if (Ci <= 64) return static_cast<int>(launch_dgrad<256, 64>(a, st));
    return static_cast<int>(launch_dgrad<128, 128>(a, st));
}

// The weight gradient's plan: out = {tiles, chunks, chunk_len, partial
// floats, db partial floats}.
extern "C" int conv3d_wgrad_plan(int B, int Do, int Ho, int Wo, int Ci, int Co, int k, int sms, long long* out) {
    int bm, bn;
    wgrad_tile(Co, &bm, &bn);
    long long sites = static_cast<long long>(B) * Do * Ho * Wo;
    int mt = (Co + bm - 1) / bm, nt = (k * k * k * Ci + bn - 1) / bn, tiles = mt * nt;
    long long chunks = (sites + kMaxChunkSites - 1) / kMaxChunkSites;
    long long fill = (static_cast<long long>(kCtasPerSm) * sms + tiles - 1) / tiles;
    if (fill > chunks) chunks = fill;
    long long len = (sites + chunks - 1) / chunks;
    len = (len + kBK - 1) / kBK * kBK;
    chunks = (sites + len - 1) / len;
    out[0] = tiles;
    out[1] = chunks;
    out[2] = len;
    out[3] = static_cast<long long>(tiles) * chunks * bm * bn;
    out[4] = static_cast<long long>(mt) * chunks * bm;
    return 0;
}

extern "C" int conv3d_wgrad(const float* x, const float* dy, float* dw, float* db, float* part, float* part_db,
                            int* tickets, int B, int D, int H, int W, int Ci, int Do, int Ho, int Wo, int Co, int k,
                            int s, int pd, int ph, int pw, int chunks, int chunk_len, void* stream) {
    Geom g = make_geom(B, D, H, W, Ci, Do, Ho, Wo, Co, k, s, pd, ph, pw);
    if (!geom_ok(g) || chunks < 1 || chunk_len % kBK != 0) return -1;
    int bm, bn;
    wgrad_tile(Co, &bm, &bn);
    WeightArgs args{x, dy, dw, db, part, part_db, tickets, g, make_div(Wo), make_div(Ho), make_div(Do),
                   chunk_len, chunks};
    dim3 grid((k * k * k * Ci + bn - 1) / bn, (Co + bm - 1) / bm, chunks);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    size_t smem = sizeof(float) * kStages * kBK * ((bm + 4) + (bn + 4));
    if (bm == 64) return static_cast<int>(launch(conv3d_wgrad_kernel<64, 256>, grid, smem, st, &args));
    return static_cast<int>(launch(conv3d_wgrad_kernel<128, 128>, grid, smem, st, &args));
}
