// Flash-attention forward for NVIDIA Hopper (sm_90a), one kernel for both
// layouts, addressed by strides.
//
// Replaces medfusion_tpu/ops/flash_attention.py::_fwd_kernel (head layout
// [B*H, N, D], launched by _fwd_call) and ::_fwd_mha_kernel (token layout
// [B, N, H*D], launched by _fwd_mha_call). Same math: logits =
// (q*s)(k*s)^T with s = d^-1/4, where q*s and k*s are rounded to the input
// dtype (s itself is first rounded to it, as jnp.asarray(scale, in_dt));
// online softmax with f32 statistics; the probability block p is rounded to
// the input dtype before p.v, which accumulates in f32; o = acc / l in the
// input dtype and lse = m + log(l) in f32.
//
// Layouts: the caller passes element strides (batch, head, token) for q, o,
// k, v and lse; the head dim is unit-stride. The head layout [B, H, N, D] and
// the token layout [B, N, H*D] (viewed as [B, H, N, D] with head stride D and
// token stride H*D) are the same kernel, so the token layout needs no
// transposes.
//
// Bound: tensor-core FLOPs, 4*B*H*N*M*d, at the UNet's shapes (N = M = 1024,
// 256 or 64 tokens; d = 32, 64 or 128) against reading q, k, v and writing o
// once. Design (FlashAttention-2 style, simple first version):
//   * one block of 4 warps per (batch*head, 64-query tile); each warp owns
//     16 query rows, held as mma A fragments in registers for the whole loop;
//   * a loop over 64-key tiles: k (scaled, rounded) and v are staged in
//     shared memory with rows padded by 8 values, so that the fragment loads
//     are free of bank conflicts; ragged tiles are zero-filled and their
//     logits masked to -inf, so any N, M >= 1 works;
//   * bf16: S = Q K^T and O += P V with mma.sync m16n8k16 (bf16 in, f32
//     accumulate); the row max and sum live in registers, reduced over the
//     four lanes that share a row, and P goes from the S accumulators to A
//     fragments without touching shared memory;
//   * f32: plain f32 FMA (not TF32), four lanes per query row, each lane
//     holding d/4 of q and of the accumulator.
// No TMA, wgmma or pipelining of the tile loads yet: that is for the PR that
// makes it fast.
//
// The launch goes on the caller's stream; the kernel allocates nothing. The
// entry point returns cudaGetLastError() after the launch.

#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace {

using namespace mf_flash;

constexpr float kInitMax = -1e30f;  // the TPU kernel's _NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, N, M;
  long long q_sb, q_sh, q_st;
  long long o_sb, o_sh, o_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long l_sb, l_sh, l_st;
  float scale;
};

constexpr int kBQ = 64;   // query rows per block (bf16)
constexpr int kBK = 64;   // keys per tile (bf16)
constexpr int kThreads = 128;

template <int D>
constexpr int bf16_smem_bytes() {
  return (kBQ + 2 * kBK) * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Params p) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;   // k-steps over the head dim
  constexpr int NT = kBK / 8;  // n-tiles of S per key tile
  constexpr int DT = D / 8;    // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBQ * LD;
  bf16* Vs = Ks + kBK * LD;

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kBQ;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  float* lse = p.lse + b * p.l_sb + h * p.l_sh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the 8-row group of a fragment
  const int t4 = lane & 3;  // column pair within the fragment
  const float s = __bfloat162float(__float2bfloat16(p.scale));

  load_tile<D, LD, kBQ, kThreads>(Qs, q + q0 * p.q_st, p.q_st, p.N - q0, true, s);
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a<LD>(qf[kk], Qs, warp * 16, kk * 16, g, t4);

  float m_r[2] = {kInitMax, kInitMax};
  float l_r[2] = {0.f, 0.f};  // this lane's part of the row sums
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int k0 = 0; k0 < p.M; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D, LD, kBK, kThreads>(Ks, k + k0 * p.k_st, p.k_st, p.M - k0, true, s);
    load_tile<D, LD, kBK, kThreads>(Vs, v + k0 * p.v_st, p.v_st, p.M - k0, false, 1.f);
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kp = Ks + (nt * 8 + g) * LD + kk * 16 + t4 * 2;
        mma_bf16(sc[nt], qf[kk], ld32(kp), ld32(kp + 8));
      }
    }
    if (k0 + kBK > p.M) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + nt * 8 + t4 * 2 + (e & 1) >= p.M) sc[nt][e] = -INFINITY;
        }
      }
    }
    // online softmax: rows g (elements 0, 1) and g + 8 (elements 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[nt][0], sc[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[nt][2], sc[nt][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = expf(sc[nt][e] - m_r[e >> 1]);
        l_r[e >> 1] += sc[nt][e];
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    // O += P V: the S accumulators of key columns [16kk, 16kk + 16) are the
    // A fragment of P for that k-step, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a_from_c(a, sc[2 * kk], sc[2 * kk + 1]);
      const bf16* vp = Vs + (kk * 16 + t4 * 2) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const bf16* vq = vp + dt * 8;
        mma_bf16(acc[dt], a, pack_h(vq[0], vq[LD]), pack_h(vq[8 * LD], vq[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.N) continue;
    bf16* orow = o + row * p.o_st + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) = __floats2bfloat162_rn(
          acc[dt][2 * r] / l_r[r], acc[dt][2 * r + 1] / l_r[r]);
    }
    if (t4 == 0) lse[row * p.l_st] = m_r[r] + logf(l_r[r]);
  }
}

constexpr int kBQ32 = 32;  // query rows per block (f32): 4 lanes per row
constexpr int kBK32 = 32;  // keys per tile (f32)

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Params p) {
  constexpr int DP = D / 4;  // head dims per lane: d = 4 * i + sub
  __shared__ float Ks[kBK32][D];
  __shared__ float Vs[kBK32][D];

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  float* lse = p.lse + b * p.l_sb + h * p.l_sh;
  const int row = blockIdx.x * kBQ32 + (threadIdx.x >> 2);
  const int sub = threadIdx.x & 3;
  const float s = p.scale;

  float qr[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = row < p.N ? q[row * p.q_st + 4 * i + sub] * s : 0.f;
    acc[i] = 0.f;
  }
  float m = kInitMax, l = 0.f;

  for (int k0 = 0; k0 < p.M; k0 += kBK32) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBK32 * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const bool ok = k0 + j < p.M;
      Ks[j][d] = ok ? k[(k0 + j) * p.k_st + d] * s : 0.f;
      Vs[j][d] = ok ? v[(k0 + j) * p.v_st + d] : 0.f;
    }
    __syncthreads();
    float sc[kBK32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) part = fmaf(qr[i], Ks[j][4 * i + sub], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      sc[j] = k0 + j < p.M ? part : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      const float pj = expf(sc[j] - m);
      l += pj;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(pj, Vs[j][4 * i + sub], acc[i]);
    }
  }
  if (row < p.N) {
#pragma unroll
    for (int i = 0; i < DP; ++i) o[row * p.o_st + 4 * i + sub] = acc[i] / l;
    if (sub == 0) lse[row * p.l_st] = m + logf(l);
  }
}

template <int D>
int launch(int is_bf16, const Params& p, int BH, cudaStream_t stream) {
  if (is_bf16) {
    constexpr int smem = bf16_smem_bytes<D>();
    static bool attr_set = false;
    if (!attr_set) {
      cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      attr_set = true;
    }
    const dim3 grid((p.N + kBQ - 1) / kBQ, BH);
    flash_fwd_bf16<D><<<grid, kThreads, smem, stream>>>(p);
  } else {
    const dim3 grid((p.N + kBQ32 - 1) / kBQ32, BH);
    flash_fwd_f32<D><<<grid, kThreads, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, H, N|M, D] addressed by strides[0..11] (q, o, k, v: batch,
// head, token; the head dim is unit-stride); lse: [B, H, N] f32 by
// strides[12..14]. is_bf16: 1 for bfloat16, 0 for float32. D in {16, 32, 64,
// 128}; any other D returns cudaErrorInvalidValue without launching.
extern "C" int mf_flash_attention_fwd(int is_bf16, const void* q, const void* k,
                                      const void* v, void* o, void* lse, int B,
                                      int H, int N, int M, int D,
                                      const long long* strides, float scale,
                                      void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.N = N;
  p.M = M;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
  p.o_sb = strides[3]; p.o_sh = strides[4]; p.o_st = strides[5];
  p.k_sb = strides[6]; p.k_sh = strides[7]; p.k_st = strides[8];
  p.v_sb = strides[9]; p.v_sh = strides[10]; p.v_st = strides[11];
  p.l_sb = strides[12]; p.l_sh = strides[13]; p.l_st = strides[14];
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(is_bf16, p, B * H, st);
    case 32: return launch<32>(is_bf16, p, B * H, st);
    case 64: return launch<64>(is_bf16, p, B * H, st);
    case 128: return launch<128>(is_bf16, p, B * H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
