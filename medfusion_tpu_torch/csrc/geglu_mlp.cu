// Fused transformer MLP for NVIDIA Hopper (sm_90a): LayerNorm -> GEGLU
// up-projection -> down-projection.
//
// Replaces medfusion_tpu/ops/geglu.py::_kernel (launched by _fused_call).
// Same math, per token row x [C]: LayerNorm in f32 (mean and E[x^2] - mean^2
// clamped at 0, eps), affine, rounded to the input dtype; h = xn W1[:, :F] +
// b1[:F] and gate = xn W1[:, F:] + b1[F:], f32 accumulation, each rounded to
// the input dtype once; g = h * gelu(gate) with the exact erf (CUDA has
// erff; the TPU kernel needed the A&S 7.1.26 rational approximation because
// Mosaic has no erf), rounded to the input dtype; out = g W2 + b2, f32
// accumulation, written in the input dtype. No atomics: every sum runs in a
// fixed order, so a launch gives the same bits every time.
//
// Weights come in nn.Linear layout: w1t = W1^T [2F, C] and w2t = W2^T
// [C, F], row-major, so that every weight tile is K-major.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): the tensor-core
// FLOPs, 6*M*C*F, at every UNet shape (C >= 256 puts the function far above
// the ridge). The TPU kernel streams F through a sequential grid, carrying a
// [BM, C] f32 accumulator in VMEM. On Hopper that accumulator is 256 KB at
// BM = 64, C = 1,024, the whole register file, so the bf16 path is two
// kernels on wgmma (m64nNk16, bf16 in, f32 accumulate) fed by TMA rings,
// with g [M, F] bf16 making one round trip through device memory (4*M*F
// bytes, under the FLOP time at every path shape):
//   * geglu_up_bf16: a block owns BM rows and a run of 128-column n-tiles
//     of F. Its consumer warpgroups LayerNorm the [BM, C] rows of x once
//     into shared memory (bf16, 64-column panels in the 128-byte swizzle
//     that TMA would write, <= 128 KB), which stay the A operand of every
//     n-tile; the producer warp streams the h tile W1[:, n0:n0+128] and the
//     gate tile W1[:, F+n0:...] of each 64-wide k-slice through a ring of
//     32 KB stages. Two accumulators (h, gate) per warpgroup: BM = 128
//     gives each warpgroup 64 rows x 128 columns (m64n128), BM = 64 each 64
//     rows x 64 columns (m64n64). The epilogue adds b1, rounds h and gate,
//     applies gelu and writes g. The erf epilogue costs about as much as
//     the products at C = 256, so there BM = 64 with a 2-stage ring lets
//     two blocks share an SM and overlap one's epilogue with the other's
//     products; C = 512 takes BM = 128 (twice the rows per weight tile,
//     3 stages) and C = 1,024 BM = 64 (the largest tile that fits, 3
//     stages), one block an SM (measured, PERF.md). Re-using the
//     LayerNormed rows over several n-tiles amortises the prologue; the
//     n-tiles are split over blocks only as far as needed to fill the card.
//   * geglu_down_bf16: a plain GEMM, g W2 + b2, K = F: 128 x 128 output
//     tiles, two consumer warpgroups of 64 rows (m64n128), g and W2^T tiles
//     through a 4-stage ring, the bias in the epilogue. No split-K.
// Each warpgroup issues a k-slice's wgmmas, then waits for the previous
// slice's to finish before freeing that slice's stage, so one slice of
// products is always in flight. Launch-time choices (rows per block,
// n-tiles per block, stages) come from ops/geglu.py::launch_shape and are
// checked here.
// float32 (not on a path: the UNet runs bf16 on the card) keeps the simple
// version: plain f32 FMA (not TF32), one thread per output element, BM =
// min(64, 8192 / C) rows a block, F streamed in chunks of 32.
//
// Launches go on the caller's stream; the kernels allocate nothing (g is the
// caller's workspace). The entry point returns cudaGetLastError() after the
// launches, or 10000 plus the CUresult where a tensor map cannot be encoded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

using namespace mf_sm90;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // f32 blocks
constexpr float kSqrt2 = 1.4142135623730951f;

__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float gelu_exact(float x) {
  return x * 0.5f * (1.f + erff(x / kSqrt2));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- float32: the simple version ----

// LayerNorm rows [m0, m0 + bm) of x [M, C] into xs (row stride ld), one warp
// per row; rows past M are zero.
__device__ void layer_norm_rows(float* xs, int ld, const float* x, const float* lns,
                                const float* lnb, int m0, int bm, int M, int C, float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < bm; r += kThreads / 32) {
    const int row = m0 + r;
    float* dst = xs + r * ld;
    if (row >= M) {
      for (int c = lane; c < C; c += 32) dst[c] = 0.f;
      continue;
    }
    const float* src = x + (long long)row * C;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = src[c];
      s += v;
      s2 += v * v;
    }
    const float mu = warp_sum(s) / C;
    const float var = fmaxf(warp_sum(s2) / C - mu * mu, 0.f);
    const float rstd = 1.f / sqrtf(var + eps);
    for (int c = lane; c < C; c += 32) dst[c] = (src[c] - mu) * rstd * lns[c] + lnb[c];
  }
}

constexpr int kBF32 = 32;          // F chunk (f32)
constexpr int kMaxElems32 = 32;    // output elements per thread (f32)

__global__ void __launch_bounds__(kThreads)
geglu_f32(const float* __restrict__ x, const float* __restrict__ lns,
          const float* __restrict__ lnb, const float* __restrict__ w1t,
          const float* __restrict__ b1, const float* __restrict__ w2t,
          const float* __restrict__ b2, float* __restrict__ out, int M, int C,
          int F, float eps, int bm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [bm][C]
  float* gs = xs + bm * C;                          // [bm][kBF32]
  const int m0 = blockIdx.x * bm;
  layer_norm_rows(xs, C, x, lns, lnb, m0, bm, M, C, eps);
  const int nout = bm * C;
  float acc[kMaxElems32];
#pragma unroll
  for (int i = 0; i < kMaxElems32; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int f0 = 0; f0 < F; f0 += kBF32) {
    for (int idx = threadIdx.x; idx < bm * kBF32; idx += kThreads) {
      const int r = idx / kBF32;
      const int f = f0 + idx % kBF32;
      float gv = 0.f;
      if (f < F) {
        const float* xr = xs + r * C;
        const float* wh = w1t + (long long)f * C;
        const float* wg = w1t + (long long)(F + f) * C;
        float hs = 0.f, gt = 0.f;
        for (int c = 0; c < C; ++c) {
          hs = fmaf(xr[c], wh[c], hs);
          gt = fmaf(xr[c], wg[c], gt);
        }
        gv = (hs + b1[f]) * gelu_exact(gt + b1[F + f]);
      }
      gs[idx] = gv;
    }
    __syncthreads();
    const int kw = min(kBF32, F - f0);
#pragma unroll
    for (int i = 0; i < kMaxElems32; ++i) {
      const int idx = threadIdx.x + kThreads * i;
      if (idx < nout) {
        const float* gr = gs + (idx / C) * kBF32;
        const float* w = w2t + (long long)(idx % C) * F + f0;
        float s = acc[i];
        for (int j = 0; j < kw; ++j) s = fmaf(gr[j], w[j], s);
        acc[i] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kMaxElems32; ++i) {
    const int idx = threadIdx.x + kThreads * i;
    const int row = m0 + idx / C;
    if (idx < nout && row < M)
      out[(long long)row * C + idx % C] = acc[i] + b2[idx % C];
  }
}

// ---- bf16: two wgmma kernels ----

constexpr int kConsumers = 256;                // two consumer warpgroups
constexpr int kTcThreads = kConsumers + 32;    // + the producer warp
constexpr int kBN = 128;                       // columns of an n-tile
constexpr int kWTile = kBN * 64 * 2;           // a [128, 64] bf16 tile: 16 KB
constexpr int kStage = 2 * kWTile;             // one ring stage: two tiles
constexpr int kMaxSmem = 232448;               // a block's shared memory (227 KB)
constexpr int kBarBytes = 2 * 4 * 8;           // full[], free[] of <= 4 stages
constexpr int kMaxStages = 4;                  // up-projection ring, at most
constexpr int kDownStages = 4;                 // down-projection ring
constexpr int kDownSmem = kDownStages * kStage + kBarBytes + 1024;

using WTile = SwTile<64, kBN>;                 // [128 rows, 64 columns], K-major

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__host__ __device__ constexpr int panels(int C) { return (C + 63) / 64; }
// Rows of an up-projection block: 128 for 256 < C <= 512, else 64.
__host__ __device__ constexpr int up_rows(int C) { return C > 256 && C <= 512 ? 128 : 64; }
// Ring stages of the up kernel: two where C <= 256, so that two blocks
// share an SM (one's gelu epilogue runs beside the other's products);
// else as many (<= kMaxStages) as fit beside the [BM, C] LayerNormed
// panels, one block an SM.
inline int up_stages(int bm, int C) {
  if (C <= 256) return 2;
  const int left = kMaxSmem - panels(C) * bm * 128 - kBarBytes - 1024;
  const int st = left / kStage;
  return st < kMaxStages ? st : kMaxStages;
}

// LayerNorm rows [m0, m0 + BM) of x [M, C] into the bf16 panels at xs
// (panel p: columns [64p, 64p + 64) of all BM rows, 128 bytes a row, the
// 16-byte chunk c of row r at chunk c ^ (r & 7): the 128-byte swizzle, as
// TMA would write it). One warp a row, 16-byte loads; columns past C and
// rows past M are zero. Then fenced for the wgmma reads.
template <int BM>
__device__ __forceinline__ void layer_norm_panels(unsigned char* xs, const bf16* x,
                                                  const bf16* lns, const bf16* lnb, int m0,
                                                  int M, int C, float eps) {
  constexpr int kMaxChunks = 1024 / 8 / 32;  // 16-byte chunks a lane at C = 1,024
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = C / 8;
  const int padded = panels(C) * 8;
  for (int r = warp; r < BM; r += kConsumers / 32) {
    const int row = m0 + r;
    uint4 xv[kMaxChunks];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxChunks; ++t) {
      const int c = lane + 32 * t;
      xv[t] = make_uint4(0, 0, 0, 0);
      if (c < chunks && row < M) {
        xv[t] = *reinterpret_cast<const uint4*>(x + (long long)row * C + c * 8);
        const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&xv[t]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(v[e]);
          s += f.x + f.y;
          s2 = fmaf(f.x, f.x, fmaf(f.y, f.y, s2));
        }
      }
    }
    const float mu = warp_sum(s) / C;
    const float var = fmaxf(warp_sum(s2) / C - mu * mu, 0.f);
    const float rstd = 1.f / sqrtf(var + eps);
#pragma unroll
    for (int t = 0; t < kMaxChunks; ++t) {
      const int c = lane + 32 * t;
      if (c >= padded) continue;
      uint4 out = make_uint4(0, 0, 0, 0);
      if (c < chunks && row < M) {
        const uint4 sv = *reinterpret_cast<const uint4*>(lns + c * 8);
        const uint4 bv = *reinterpret_cast<const uint4*>(lnb + c * 8);
        const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&xv[t]);
        const __nv_bfloat162* sc = reinterpret_cast<const __nv_bfloat162*>(&sv);
        const __nv_bfloat162* bi = reinterpret_cast<const __nv_bfloat162*>(&bv);
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(v[e]);
          const float2 a = __bfloat1622float2(sc[e]);
          const float2 bb = __bfloat1622float2(bi[e]);
          o[e] = __floats2bfloat162_rn((f.x - mu) * rstd * a.x + bb.x,
                                       (f.y - mu) * rstd * a.y + bb.y);
        }
      }
      *reinterpret_cast<uint4*>(xs + (c >> 3) * (BM * 128) + r * 128
                                + (((c & 7) ^ (r & 7)) << 4)) = out;
    }
  }
  fence_proxy_async();
}

// g[:, n-tiles] = gelu-gated up-projection of LayerNorm(x): blockIdx.y =
// row tile (BM = 64 MW rows), blockIdx.x = a run of `tiles_per_block`
// 128-column n-tiles. th / tg: the 2-D maps of W1^T's h rows [0, F) and
// gate rows [F, 2F), boxes of 64 columns by 128 rows.
template <int MW>
__global__ void __launch_bounds__(kTcThreads, 1)
    geglu_up_bf16(const bf16* __restrict__ x, const bf16* __restrict__ lns,
                  const bf16* __restrict__ lnb, const bf16* __restrict__ b1,
                  bf16* __restrict__ g, const __grid_constant__ CUtensorMap th,
                  const __grid_constant__ CUtensorMap tg, int M, int C, int F,
                  int tiles_per_block, int stages, float eps) {
  constexpr int BM = 64 * MW;
  constexpr int PANEL = BM * 128;       // bytes of a [BM, 64] panel
  constexpr int NW = MW == 2 ? 128 : 64;  // n-tile columns of one warpgroup
  unsigned char* smem = aligned_smem();
  const uint32_t s0 = smem_addr(smem);
  const int kp_n = panels(C);
  const uint32_t ring = s0 + kp_n * PANEL;
  const uint32_t bars = ring + stages * kStage;  // full[stages], free[stages]
  auto full = [&](int st) { return bars + 8 * st; };
  auto freed = [&](int st) { return bars + 8 * (stages + st); };
  const int m0 = blockIdx.y * BM;
  const int ntiles = (F + kBN - 1) / kBN;
  const int nt0 = blockIdx.x * tiles_per_block;
  const int nt1 = min(ntiles, nt0 + tiles_per_block);
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(freed(st), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one lane issues TMA
    if (threadIdx.x == kConsumers) {
      int i = 0;
      for (int nt = nt0; nt < nt1; ++nt) {
        for (int kp = 0; kp < kp_n; ++kp, ++i) {
          const int st = i % stages;
          if (i >= stages) mbar_wait(freed(st), ((i / stages) & 1) ^ 1);
          const uint32_t dst = ring + st * kStage;
          mbar_arrive_expect_tx(full(st), kStage);
          tma_load_2d(dst, &th, kp * 64, nt * kBN, full(st));
          tma_load_2d(dst + kWTile, &tg, kp * 64, nt * kBN, full(st));
        }
      }
    }
    return;
  }

  layer_norm_panels<BM>(smem, x, lns, lnb, m0, M, C, eps);
  consumers_sync();

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  // MW = 2: warpgroup wg owns rows [64 wg, 64 wg + 64) and all 128 columns;
  // MW = 1: all 64 rows and columns [64 wg, 64 wg + 64) of the n-tile
  const uint32_t a_off = MW == 2 ? wg * 64 * 128 : 0;
  const uint32_t b_off = MW == 2 ? 0 : wg * 64 * 128;
  const int row0 = m0 + (MW == 2 ? wg * 64 : 0) + warp * 16 + gq;
  float acc_h[NW / 2], acc_g[NW / 2];
  int i = 0;
  for (int nt = nt0; nt < nt1; ++nt) {
    for (int kp = 0; kp < kp_n; ++kp, ++i) {
      const int st = i % stages;
      const uint32_t stage = ring + st * kStage;
      mbar_wait(full(st), (i / stages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a = SwTile<64, BM>::k_major(s0 + kp * PANEL + a_off, kk);
        Wgmma<NW>::ss(acc_h, a, WTile::k_major(stage + b_off, kk), kp > 0 || kk > 0);
        Wgmma<NW>::ss(acc_g, a, WTile::k_major(stage + kWTile + b_off, kk), kp > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kp > 0) mbar_arrive(freed((i - 1) % stages));
    }
    wgmma_wait<0>();
    fence_regs(acc_h);
    fence_regs(acc_g);
    mbar_arrive(freed((i - 1) % stages));
    // h, gate: + bias, each rounded once; g = h * gelu(gate), rounded
    const int col0 = nt * kBN + (MW == 2 ? 0 : wg * 64) + t4 * 2;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = col0 + j * 8;
      if (col >= F) continue;
      const float2 bh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + col));
      const float2 bg =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + F + col));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= M) continue;
        const float h0 = round_bf(acc_h[4 * j + 2 * r] + bh.x);
        const float h1 = round_bf(acc_h[4 * j + 2 * r + 1] + bh.y);
        const float g0 = round_bf(acc_g[4 * j + 2 * r] + bg.x);
        const float g1 = round_bf(acc_g[4 * j + 2 * r + 1] + bg.y);
        *reinterpret_cast<__nv_bfloat162*>(g + (long long)row * F + col) =
            __floats2bfloat162_rn(h0 * gelu_exact(g0), h1 * gelu_exact(g1));
      }
    }
  }
}

// out = g W2 + b2: blockIdx.x = 128-column tile of C, blockIdx.y = 128-row
// tile of M; tgm: g [M, F], tw: W2^T [C, F], boxes of 64 columns by 128
// rows. Warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile.
__global__ void __launch_bounds__(kTcThreads, 1)
    geglu_down_bf16(const bf16* __restrict__ b2, bf16* __restrict__ out,
                    const __grid_constant__ CUtensorMap tgm,
                    const __grid_constant__ CUtensorMap tw, int M, int C, int F) {
  unsigned char* smem = aligned_smem();
  const uint32_t ring = smem_addr(smem);
  const uint32_t bars = ring + kDownStages * kStage;
  auto full = [&](int st) { return bars + 8 * st; };
  auto freed = [&](int st) { return bars + 8 * (kDownStages + st); };
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * 128;
  const int kf = panels(F);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kDownStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(freed(st), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one lane issues TMA
    if (threadIdx.x == kConsumers) {
      for (int kp = 0; kp < kf; ++kp) {
        const int st = kp % kDownStages;
        if (kp >= kDownStages) mbar_wait(freed(st), ((kp / kDownStages) & 1) ^ 1);
        const uint32_t dst = ring + st * kStage;
        mbar_arrive_expect_tx(full(st), kStage);
        tma_load_2d(dst, &tgm, kp * 64, m0, full(st));
        tma_load_2d(dst + kWTile, &tw, kp * 64, n0, full(st));
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  float acc[kBN / 2];
  for (int kp = 0; kp < kf; ++kp) {
    const int st = kp % kDownStages;
    const uint32_t stage = ring + st * kStage;
    mbar_wait(full(st), (kp / kDownStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma<kBN>::ss(acc, WTile::k_major(stage + wg * 64 * 128, kk),
                     WTile::k_major(stage + kWTile, kk), kp > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (kp > 0) mbar_arrive(freed((kp - 1) % kDownStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
    if (col >= C) continue;
    const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + col));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= M) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * C + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] + bias.x, acc[4 * j + 2 * r + 1] + bias.y);
    }
  }
}

template <int MW>
int launch_up(const bf16* x, const bf16* lns, const bf16* lnb, const CUtensorMap& th,
              const CUtensorMap& tg, const bf16* b1, bf16* g, int M, int C, int F,
              int tiles_per_block, float eps, cudaStream_t stream) {
  constexpr int BM = 64 * MW;
  const int stages = up_stages(BM, C);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = panels(C) * BM * 128 + stages * kStage + kBarBytes + 1024;
  static DeviceAttr attr;
  int err;
  if ((err = set_smem(geglu_up_bf16<MW>, kMaxSmem, &attr)) != 0) return err;
  const int ntiles = (F + kBN - 1) / kBN;
  const dim3 grid((ntiles + tiles_per_block - 1) / tiles_per_block, (M + BM - 1) / BM);
  geglu_up_bf16<MW><<<grid, kTcThreads, smem, stream>>>(x, lns, lnb, b1, g, th, tg, M, C, F,
                                                       tiles_per_block, stages, eps);
  return (int)cudaGetLastError();
}

int launch_bf16(const bf16* x, const bf16* lns, const bf16* lnb, const bf16* w1t,
                const bf16* b1, const bf16* w2t, const bf16* b2, bf16* out, bf16* g, int M,
                int C, int F, int block_rows, int tiles_per_block, float eps,
                cudaStream_t stream) {
  CUtensorMap th, tg, tgm, tw;
  int err;
  if ((err = encode_2d(&th, w1t, F, C, kBN)) != 0) return err;
  if ((err = encode_2d(&tg, w1t + (long long)F * C, F, C, kBN)) != 0) return err;
  if ((err = encode_2d(&tgm, g, M, F, 128)) != 0) return err;
  if ((err = encode_2d(&tw, w2t, C, F, kBN)) != 0) return err;
  err = block_rows == 128
            ? launch_up<2>(x, lns, lnb, th, tg, b1, g, M, C, F, tiles_per_block, eps, stream)
            : launch_up<1>(x, lns, lnb, th, tg, b1, g, M, C, F, tiles_per_block, eps, stream);
  if (err != 0) return err;
  static DeviceAttr attr;
  if ((err = set_smem(geglu_down_bf16, kDownSmem, &attr)) != 0) return err;
  const dim3 grid((C + kBN - 1) / kBN, (M + 127) / 128);
  geglu_down_bf16<<<grid, kTcThreads, kDownSmem, stream>>>(b2, out, tgm, tw, M, C, F);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, C]; ln_scale, ln_bias, b2 [C]; w1t [2F, C]; b1 [2F]; w2t [C, F];
// out [M, C]; all contiguous and 16-byte aligned, one dtype (is_bf16: 1
// bfloat16, 0 float32). C and F multiples of 16, C <= 1024. bfloat16:
// block_rows = up_rows(C), 1 <= tiles_per_block <=
// ceil(F / 128), and g a bf16 workspace [M, F]. float32: block_rows =
// min(64, 8192 / C); tiles_per_block and g are not read. Anything else
// returns cudaErrorInvalidValue without launching.
extern "C" int mf_geglu_mlp(int is_bf16, const void* x, const void* ln_scale,
                            const void* ln_bias, const void* w1t,
                            const void* b1, const void* w2t, const void* b2,
                            void* out, void* g, int M, int C, int F,
                            int block_rows, int tiles_per_block, float eps,
                            void* stream) {
  if (M < 1 || C < 16 || C > 1024 || C % 16 || F < 16 || F % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (g == nullptr || block_rows != up_rows(C) || tiles_per_block < 1 ||
        tiles_per_block > (F + kBN - 1) / kBN)
      return (int)cudaErrorInvalidValue;
    return launch_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(ln_scale),
                       static_cast<const bf16*>(ln_bias), static_cast<const bf16*>(w1t),
                       static_cast<const bf16*>(b1), static_cast<const bf16*>(w2t),
                       static_cast<const bf16*>(b2), static_cast<bf16*>(out),
                       static_cast<bf16*>(g), M, C, F, block_rows, tiles_per_block, eps, st);
  }
  if (block_rows != min(64, kMaxElems32 * kThreads / C)) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + block_rows - 1) / block_rows);
  const int smem = block_rows * (C + kBF32) * 4;  // < 48 KB
  geglu_f32<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(w1t),
      static_cast<const float*>(b1), static_cast<const float*>(w2t),
      static_cast<const float*>(b2), static_cast<float*>(out), M, C, F, eps, block_rows);
  return (int)cudaGetLastError();
}
