// Fused transformer MLP for NVIDIA Hopper (sm_90a): LayerNorm -> GEGLU
// up-projection -> down-projection, with F streamed so that no [M, 2F] or
// [M, F] tensor reaches device memory.
//
// Replaces medfusion_tpu/ops/geglu.py::_kernel (launched by _fused_call).
// Same math, per token row x [C]: LayerNorm in f32 (mean and E[x^2] - mean^2
// clamped at 0, eps), affine, rounded to the input dtype; h = xn W1[:, :F] +
// b1[:F] and gate = xn W1[:, F:] + b1[F:], f32 accumulation, each rounded to
// the input dtype; g = h * gelu(gate) with the exact erf (CUDA has erff; the
// TPU kernel needed the A&S 7.1.26 rational approximation because Mosaic has
// no erf), rounded to the input dtype; out = g W2 + b2, f32 accumulation,
// written in the input dtype.
//
// Weights come in nn.Linear layout: w1t = W1^T [2F, C] and w2t = W2^T
// [C, F], row-major, so that every mma B fragment is two 32-bit loads.
//
// Bound: tensor-core FLOPs (6*M*C*F) at the UNet's shapes. Design: the TPU
// kernel carries a [BM, C] f32 accumulator in VMEM across a sequential F
// grid. Hopper has no sequential grid, so a block owns BM rows and loops over
// F itself, keeping that accumulator in REGISTERS, split over its 8 warps as
// 16x8 mma tiles (at most 16 tiles, 64 floats, per thread). BM = 16, 32 or 64
// rows for C in (512, 1024], (256, 512] or <= 256 keeps that bound and the
// shared memory under 48 KB. (Splitting the output columns over blocks
// instead would recompute the up-projection, 2/3 of the FLOPs, once per
// column block.) Where M / BM row blocks cannot fill the card, F is split
// over gridDim.y blocks per row block: each writes its f32 partial sum to a
// workspace and geglu_reduce adds the partials in split order, then b2
// (deterministic). Per block:
//   1. each warp LayerNorms rows into shared memory (bf16, rows padded by 8
//      values so that A-fragment loads are free of bank conflicts);
//   2. for each 64-wide chunk of F: warp w computes the h and gate columns
//      [8w, 8w + 8) of the chunk for all BM rows (mma.sync m16n8k16, A from
//      shared memory, B straight from the L2-resident weights), applies the
//      bias, rounding and gate in registers, and writes g [BM, 64] to shared
//      memory; then every warp adds g W2[chunk, its columns] into its
//      register accumulators;
//   3. the accumulators plus b2 are written out.
// float32 takes the same structure with plain f32 FMA (not TF32): one thread
// per output element, BM = min(64, 8192 / C) rows.
// The k loops are unrolled and the launch bound asks for two blocks per SM,
// so that more B-fragment loads are in flight (a spill of a few registers at
// BM = 64 costs less than the second block gains). Weights are re-read from
// L2 once per block (BM rows) and there is no TMA/wgmma pipelining: that is
// what a later PR makes fast.
//
// The launch goes on the caller's stream; the kernel allocates nothing. The
// entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBF = 64;        // F chunk
constexpr int kLDG = kBF + 8;  // padded row of the g chunk
constexpr int kMaxTiles = 16;  // output mma tiles per warp
constexpr float kSqrt2 = 1.4142135623730951f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float gelu_exact(float x) {
  return x * 0.5f * (1.f + erff(x / kSqrt2));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a bf16
// shared-memory matrix with row stride ld.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* base, int ld,
                                       int r0, int c0, int g, int t4) {
  const bf16* p = base + (r0 + g) * ld + c0 + t4 * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm rows [m0, m0 + bm) of x [M, C] into xs (row stride ld), one warp
// per row; rows past M are zero.
template <typename T>
__device__ void layer_norm_rows(T* xs, int ld, const T* x, const T* lns,
                                const T* lnb, int m0, int bm, int M, int C,
                                float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < bm; r += kThreads / 32) {
    const int row = m0 + r;
    T* dst = xs + r * ld;
    if (row >= M) {
      for (int c = lane; c < C; c += 32) dst[c] = from_f<T>(0.f);
      continue;
    }
    const T* src = x + (long long)row * C;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = to_f(src[c]);
      s += v;
      s2 += v * v;
    }
    const float mu = warp_sum(s) / C;
    const float var = fmaxf(warp_sum(s2) / C - mu * mu, 0.f);
    const float rstd = 1.f / sqrtf(var + eps);
    for (int c = lane; c < C; c += 32)
      dst[c] = from_f<T>((to_f(src[c]) - mu) * rstd * to_f(lns[c]) + to_f(lnb[c]));
  }
}

template <int MT>  // BM = 16 * MT rows per block
__global__ void __launch_bounds__(kThreads, 2)
geglu_bf16(const bf16* __restrict__ x, const bf16* __restrict__ lns,
           const bf16* __restrict__ lnb, const bf16* __restrict__ w1t,
           const bf16* __restrict__ b1, const bf16* __restrict__ w2t,
           const bf16* __restrict__ b2, bf16* __restrict__ out,
           float* __restrict__ partial, int M, int C, int F, float eps) {
  constexpr int BM = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = C + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [BM][C + 8]
  bf16* gs = xs + BM * ldx;                       // [BM][kBF + 8]
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  layer_norm_rows<bf16>(xs, ldx, x, lns, lnb, m0, BM, M, C, eps);

  // output tiles t = warp + 8 i: rows 16 (t % MT), columns 8 (t / MT)
  const int ntiles = MT * (C / 8);
  float acc[kMaxTiles][4];
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  __syncthreads();

  // this block's share of the F chunks (all of them unless F is split)
  const int nchunks = (F + kBF - 1) / kBF;
  const int f_begin = (int)(blockIdx.y * nchunks / gridDim.y) * kBF;
  const int f_end = min(F, (int)((blockIdx.y + 1) * nchunks / gridDim.y) * kBF);
  for (int f0 = f_begin; f0 < f_end; f0 += kBF) {
    // up-projection: columns [fc, fc + 8) of h and of gate, all BM rows
    const int fc = f0 + warp * 8;
    if (fc < F) {
      float ha[MT][4], ga[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ha[mt][0] = ha[mt][1] = ha[mt][2] = ha[mt][3] =
            ga[mt][0] = ga[mt][1] = ga[mt][2] = ga[mt][3] = 0.f;
      const bf16* wh = w1t + (long long)(fc + g) * C + t4 * 2;
      const bf16* wg = w1t + (long long)(F + fc + g) * C + t4 * 2;
#pragma unroll 4
      for (int kk = 0; kk < C; kk += 16) {
        const uint32_t bh0 = ld32(wh + kk), bh1 = ld32(wh + kk + 8);
        const uint32_t bg0 = ld32(wg + kk), bg1 = ld32(wg + kk + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          load_a(a, xs, ldx, mt * 16, kk, g, t4);
          mma_bf16(ha[mt], a, bh0, bh1);
          mma_bf16(ga[mt], a, bg0, bg1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float gv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = fc + t4 * 2 + e;
            const float hv = round_bf(ha[mt][2 * r + e] + to_f(b1[col]));
            const float gt = round_bf(ga[mt][2 * r + e] + to_f(b1[F + col]));
            gv[e] = hv * gelu_exact(gt);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              gs + (mt * 16 + g + 8 * r) * kLDG + warp * 8 + t4 * 2) =
              __floats2bfloat162_rn(gv[0], gv[1]);
        }
      }
    }
    __syncthreads();
    // down-projection of this chunk into the register accumulators
    const int kw = min(kBF, F - f0);  // a multiple of 16
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i) {
      const int t = warp + 8 * i;
      if (t < ntiles) {
        const int mt = t % MT;
        const int ct = t / MT;
        const bf16* w = w2t + (long long)(ct * 8 + g) * F + f0 + t4 * 2;
#pragma unroll
        for (int kk = 0; kk < kBF; kk += 16) {
          if (kk < kw) {
            uint32_t a[4];
            load_a(a, gs, kLDG, mt * 16, kk, g, t4);
            mma_bf16(acc[i], a, ld32(w + kk), ld32(w + kk + 8));
          }
        }
      }
    }
    __syncthreads();  // gs is rewritten by the next chunk
  }

#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    const int t = warp + 8 * i;
    if (t >= ntiles) continue;
    const int col = (t / MT) * 8 + t4 * 2;
    const float c0 = to_f(b2[col]), c1 = to_f(b2[col + 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + (t % MT) * 16 + g + 8 * r;
      if (row >= M) continue;
      if (gridDim.y == 1) {
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * C + col) =
            __floats2bfloat162_rn(acc[i][2 * r] + c0, acc[i][2 * r + 1] + c1);
      } else {  // this split's f32 partial sum, without b2
        *reinterpret_cast<float2*>(
            partial + ((long long)blockIdx.y * M + row) * C + col) =
            make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
      }
    }
  }
}

// out = bf16(sum over the splits, in split order, + b2): the second pass of
// an F-split launch.
__global__ void __launch_bounds__(kThreads)
geglu_reduce(const float* __restrict__ partial, const bf16* __restrict__ b2,
             bf16* __restrict__ out, int M, int C, int splits) {
  const long long n = (long long)M * C;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += partial[sp * n + i];
    out[i] = __float2bfloat16(v + to_f(b2[i % C]));
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
  layer_norm_rows<float>(xs, C, x, lns, lnb, m0, bm, M, C, eps);
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

}  // namespace

// x [M, C]; ln_scale, ln_bias, b2 [C]; w1t [2F, C]; b1 [2F]; w2t [C, F];
// out [M, C]; all contiguous, one dtype (is_bf16: 1 bfloat16, 0 float32).
// C and F multiples of 16, C <= 1024. bfloat16: block_rows in {16, 32, 64}
// with block_rows * C <= 16384, and F split over `splits` blocks per row
// block (1 <= splits <= ceil(F / 64)); for splits > 1, partial is an f32
// workspace of splits * M * C. float32: block_rows = min(64, 8192 / C),
// splits = 1. Anything else returns cudaErrorInvalidValue without launching.
extern "C" int mf_geglu_mlp(int is_bf16, const void* x, const void* ln_scale,
                            const void* ln_bias, const void* w1t,
                            const void* b1, const void* w2t, const void* b2,
                            void* out, void* partial, int M, int C, int F,
                            int block_rows, int splits, float eps,
                            void* stream) {
  if (M < 1 || C < 16 || C > 1024 || C % 16 || F < 16 || F % 16 || splits < 1 ||
      splits > (F + kBF - 1) / kBF || (splits > 1 && (!is_bf16 || !partial)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + block_rows - 1) / block_rows, splits);
  if (is_bf16) {
    if (block_rows * C > 16384) return (int)cudaErrorInvalidValue;
    const int smem = block_rows * (C + 8 + kLDG) * 2;  // < 48 KB
#define MF_GEGLU_LAUNCH(MT)                                                   \
  geglu_bf16<MT><<<grid, kThreads, smem, st>>>(                               \
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_scale),        \
      static_cast<const bf16*>(ln_bias), static_cast<const bf16*>(w1t),       \
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2t),            \
      static_cast<const bf16*>(b2), static_cast<bf16*>(out),                  \
      static_cast<float*>(partial), M, C, F, eps)
    if (block_rows == 64) MF_GEGLU_LAUNCH(4);
    else if (block_rows == 32) MF_GEGLU_LAUNCH(2);
    else if (block_rows == 16) MF_GEGLU_LAUNCH(1);
    else return (int)cudaErrorInvalidValue;
#undef MF_GEGLU_LAUNCH
    if (splits > 1) {
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const long long n = (long long)M * C;
      const long long need = (n + kThreads - 1) / kThreads;
      const int blocks = need < 4096 ? (int)need : 4096;
      geglu_reduce<<<blocks, kThreads, 0, st>>>(
          static_cast<const float*>(partial), static_cast<const bf16*>(b2),
          static_cast<bf16*>(out), M, C, splits);
    }
  } else {
    if (block_rows != min(64, kMaxElems32 * kThreads / C))
      return (int)cudaErrorInvalidValue;
    const int smem = block_rows * (C + kBF32) * 4;  // < 48 KB
    geglu_f32<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(ln_scale),
        static_cast<const float*>(ln_bias), static_cast<const float*>(w1t),
        static_cast<const float*>(b1), static_cast<const float*>(w2t),
        static_cast<const float*>(b2), static_cast<float*>(out), M, C, F, eps,
        block_rows);
  }
  return (int)cudaGetLastError();
}
