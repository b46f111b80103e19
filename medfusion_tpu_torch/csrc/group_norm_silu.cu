// GroupNorm (+ optional SiLU) for NVIDIA Hopper (sm_90a), NCHW contiguous.
//
// Replaces the Pallas TPU kernel medfusion_tpu/ops/group_norm.py::_kernel
// (launched by _pallas_group_norm_silu). Same math: per (batch, group) the
// mean and variance are taken in f32 over every spatial position x the
// channels of the group, then y = (x - mean) * rsqrt(var + eps) * scale[c]
// + bias[c], then y * sigmoid(y) when apply_silu, stored in x's dtype.
//
// Bound: memory. The function reads x once and writes y once (2 bytes per
// element each way in bf16); it does a handful of flops per element. In
// contiguous NCHW every (b, g) is one contiguous run of n = (C/G)*S values,
// so the design is a split reduction over that run:
//   1. gn_stats_kernel: grid (chunks, B*G). Each block takes one chunk of
//      its run and computes the chunk's mean, then the sum of squares about
//      that mean (two passes; the second hits L2, the chunk is <= 32 KB in
//      bf16). It writes (mean, M2) for the chunk.
//   2. gn_apply_kernel: same grid. Each block merges its group's chunk
//      statistics in chunk order with Chan's formula (deterministic), then
//      normalises, applies the affine and the SiLU, and writes its chunk.
// Splitting the run keeps 132 SMs busy at the VAE's top level (G=8 over
// 256^2 positions gives only 8*B runs). There is no matrix product, so no
// wgmma or TMA. The TPU kernel's [C, G] membership matmul existed only
// because Mosaic rejects the group reshape; here a run is already a group.
//
// The launches go on the caller's stream; the kernel allocates nothing (the
// wrapper passes the chunk-statistics scratch). Each entry point returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// Sum over the block; every thread gets the result. smem holds >= 32 floats.
__device__ float block_sum(float v, float* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // smem may still be read from the previous call
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? smem[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) smem[0] = t;
  }
  __syncthreads();
  return smem[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ stats, int n,
                int chunk, int nchunk) {
  __shared__ float smem[32];
  const int64_t bg = blockIdx.y;
  const int start = blockIdx.x * chunk;
  const int end = min(start + chunk, n);
  const T* xg = x + bg * (int64_t)n;

  float s = 0.f;
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) s += to_f(xg[i]);
  const float mean = block_sum(s, smem) / (float)(end - start);

  float q = 0.f;
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    const float d = to_f(xg[i]) - mean;
    q += d * d;
  }
  const float m2 = block_sum(q, smem);
  if (threadIdx.x == 0) stats[bg * nchunk + blockIdx.x] = make_float2(mean, m2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                const T* __restrict__ bias, T* __restrict__ y,
                const float2* __restrict__ stats, int n, int S, int cg, int G,
                int chunk, int nchunk, float eps, int apply_silu) {
  __shared__ float s_mean, s_rstd;
  const int64_t bg = blockIdx.y;
  if (threadIdx.x == 0) {
    // Chan et al. pairwise merge of (count, mean, M2), in chunk order.
    float cnt = 0.f, mean = 0.f, m2 = 0.f;
    for (int k = 0; k < nchunk; ++k) {
      const float2 st = stats[bg * nchunk + k];
      const float nb = (float)(min((k + 1) * chunk, n) - k * chunk);
      const float tot = cnt + nb;
      const float delta = st.x - mean;
      mean += delta * (nb / tot);
      m2 += st.y + delta * delta * (cnt * nb / tot);
      cnt = tot;
    }
    s_mean = mean;
    s_rstd = rsqrtf(m2 / cnt + eps);
  }
  __syncthreads();
  const float mean = s_mean;
  const float rstd = s_rstd;
  const int c0 = (int)(bg % G) * cg;
  const int start = blockIdx.x * chunk;
  const int end = min(start + chunk, n);
  const T* xg = x + bg * (int64_t)n;
  T* yg = y + bg * (int64_t)n;
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    const int c = c0 + i / S;
    float v = (to_f(xg[i]) - mean) * rstd * to_f(scale[c]) + to_f(bias[c]);
    if (apply_silu) v = v * (1.f / (1.f + expf(-v)));
    yg[i] = from_f<T>(v);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y,
           void* stats, int B, int C, int S, int G, float eps, int apply_silu,
           int chunk, cudaStream_t stream) {
  const int cg = C / G;
  const int n = cg * S;
  const int nchunk = (n + chunk - 1) / chunk;
  const dim3 grid(nchunk, B * G);
  gn_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float2*>(stats), n, chunk, nchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_apply_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(y),
      static_cast<const float2*>(stats), n, S, cg, G, chunk, nchunk, eps,
      apply_silu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mf_group_norm_silu_f32(const void* x, const void* scale,
                                      const void* bias, void* y, void* stats,
                                      int B, int C, int S, int G, float eps,
                                      int apply_silu, int chunk, void* stream) {
  return launch<float>(x, scale, bias, y, stats, B, C, S, G, eps, apply_silu,
                       chunk, static_cast<cudaStream_t>(stream));
}

extern "C" int mf_group_norm_silu_bf16(const void* x, const void* scale,
                                       const void* bias, void* y, void* stats,
                                       int B, int C, int S, int G, float eps,
                                       int apply_silu, int chunk, void* stream) {
  return launch<__nv_bfloat16>(x, scale, bias, y, stats, B, C, S, G, eps,
                               apply_silu, chunk,
                               static_cast<cudaStream_t>(stream));
}
