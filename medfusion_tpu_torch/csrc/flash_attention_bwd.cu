// Flash-attention backward for NVIDIA Hopper (sm_90a): a dQ kernel and a
// dK/dV kernel, for both layouts, addressed by strides.
//
// Replaces medfusion_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (launched by _flash_bwd; the token layout's
// _flash_mha_bwd transposes into them, where these kernels read the token
// layout through its strides). Same math and rounding points as the TPU
// kernels, which are not the forward's: with sc2 = s^2 and the UNSCALED q
// and k in the input dtype,
//   S  = sc2 * (q k^T)            f32 accumulation, then one f32 multiply
//   P  = exp(S - lse)             lse from the forward
//   dP = dO V^T                   f32
//   D  = rowsum(dO * O)           f32
//   dS = P * (dP - D)
//   dQ = sc2 * (dS K),  dK = sc2 * (dS^T Q),  dV = P^T dO
// where dS and P are rounded to the input dtype only as operands of the
// last three products (which accumulate in f32), and dQ, dK, dV are rounded
// once at the end.
//
// Two kernels, as on the TPU, so that no sum crosses blocks: no atomics, and
// the result is the same bits on every run.
//   * dQ: one block per (batch*head, 64 queries), looping over 64-key tiles.
//     It also computes D for its rows, keeps it for dS and writes it out for
//     the dK/dV kernel, which runs after it on the same stream.
//   * dK/dV: one block per (batch*head, 64 keys), looping over 64-query
//     tiles. It computes S^T = K Q^T directly, rows being keys: P^T and
//     dS^T then come out of the mma accumulators already in the A-fragment
//     layout of P^T dO and dS^T Q (the trick the forward uses to feed P into
//     P V), and lse and D are per-column values of those accumulators.
// bf16: mma.sync m16n8k16, bf16 in, f32 accumulate; 4 warps of 16 rows;
// every operand tile is staged in shared memory with rows padded by 8
// values (no bank conflicts on fragment loads). f32: plain f32 FMA (not
// TF32), four lanes per row, each holding d/4 of the row's vectors.
// Ragged tiles take any N, M >= 1: loads beyond N or M are zero-filled;
// keys past M give P = 0 in the dQ kernel, and queries past N give P = 0
// and dS = 0 in the dK/dV kernel (their lse and D are not data).
//
// Bound: tensor-core FLOPs, 6*BH*N*M*d for dQ (q k^T, dO v^T, dS k) and
// 8*BH*N*M*d for dK/dV (k q^T, v dO^T, P^T dO, dS^T q), against reading q,
// k, v, o, dO, lse and writing dq, dk, dv once. No TMA, wgmma or pipelined
// tile loads yet: that is for the PR that makes these kernels fast.
//
// Launches go on the caller's stream; the kernels allocate nothing. Each
// entry point returns cudaGetLastError() after its launch.

#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace {

using namespace mf_flash;

// operands, in the order of the entry points' pointer and stride arrays
enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kLse, kDelta, kOperands };

struct BwdParams {
  void* ptr[kOperands];
  long long st[kOperands][3];  // batch, head, token strides in elements
  int H, N, M;
  float sc2;
};

template <typename T>
__device__ __forceinline__ T* base(const BwdParams& p, int which, int b, int h) {
  return static_cast<T*>(p.ptr[which]) + b * p.st[which][0] + h * p.st[which][1];
}

constexpr int kTile = 64;  // rows of a block and of a looped tile (bf16)
constexpr int kThreads = 128;
constexpr int kTile32 = 32;  // f32

template <int D>
constexpr int bf16_smem_bytes() {
  return 4 * kTile * (D + 8) * 2 + 2 * kTile * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(BwdParams p) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;    // k-steps over the head dim
  constexpr int NT = kTile / 8;  // n-tiles of S per key tile
  constexpr int DT = D / 8;     // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTile * LD;
  bf16* Ks = dOs + kTile * LD;
  bf16* Vs = Ks + kTile * LD;
  float* Ds = reinterpret_cast<float*>(Vs + kTile * LD);

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kTile;
  const int nq = min(kTile, p.N - q0);
  const bf16* q = base<const bf16>(p, kQ, b, h) + q0 * p.st[kQ][2];
  const bf16* k = base<const bf16>(p, kK, b, h);
  const bf16* v = base<const bf16>(p, kV, b, h);
  const bf16* o = base<const bf16>(p, kO, b, h) + q0 * p.st[kO][2];
  const bf16* dout = base<const bf16>(p, kDO, b, h) + q0 * p.st[kDO][2];
  bf16* dq = base<bf16>(p, kDQ, b, h) + q0 * p.st[kDQ][2];
  const float* lse = base<const float>(p, kLse, b, h) + q0 * p.st[kLse][2];
  float* delta = base<float>(p, kDelta, b, h) + q0 * p.st[kDelta][2];

  load_tile<D, LD, kTile, kThreads>(Qs, q, p.st[kQ][2], nq, false, 1.f);
  load_tile<D, LD, kTile, kThreads>(dOs, dout, p.st[kDO][2], nq, false, 1.f);
  {
    // D = rowsum(dO * O) in f32, two threads a row; written for dK/dV
    const int r = threadIdx.x >> 1;
    const int half = threadIdx.x & 1;
    float sum = 0.f;
    if (r < nq) {
      const bf16* orow = o + r * p.st[kO][2] + half * (D / 2);
      const bf16* drow = dout + r * p.st[kDO][2] + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 2) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + c));
        const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + c));
        sum = fmaf(d.x, a.x, sum);
        sum = fmaf(d.y, a.y, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      Ds[r] = sum;
      if (r < nq) delta[r * p.st[kDelta][2]] = sum;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this lane's rows: r0 and r0 + 8
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    lse_r[r] = row < nq ? lse[row * p.st[kLse][2]] : 0.f;
    d_r[r] = Ds[row];
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int k0 = 0; k0 < p.M; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D, LD, kTile, kThreads>(Ks, k + k0 * p.st[kK][2], p.st[kK][2], p.M - k0, false, 1.f);
    load_tile<D, LD, kTile, kThreads>(Vs, v + k0 * p.st[kV][2], p.st[kV][2], p.M - k0, false, 1.f);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, Qs, warp * 16, kk * 16, g, t4);
      load_a<LD>(da, dOs, warp * 16, kk * 16, g, t4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kp = Ks + (nt * 8 + g) * LD + kk * 16 + t4 * 2;
        mma_bf16(s[nt], qa, ld32(kp), ld32(kp + 8));
        const bf16* vp = Vs + (nt * 8 + g) * LD + kk * 16 + t4 * 2;
        mma_bf16(dp[nt], da, ld32(vp), ld32(vp + 8));
      }
    }
    // dS = P * (dP - D) in place of S; keys past M give P = 0
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        const float pv = col < p.M ? expf(__fmul_rn(p.sc2, s[nt][e]) - lse_r[e >> 1]) : 0.f;
        s[nt][e] = pv * (dp[nt][e] - d_r[e >> 1]);
      }
    }
    // dQ += dS K, dS rounded to bf16 from the accumulators
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      a_from_c(a, s[2 * kk], s[2 * kk + 1]);
      const bf16* kp = Ks + (kk * 16 + t4 * 2) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const bf16* kq = kp + dt * 8;
        mma_bf16(acc[dt], a, pack_h(kq[0], kq[LD]), pack_h(kq[8 * LD], kq[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= nq) continue;
    bf16* out = dq + row * p.st[kDQ][2] + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(out + dt * 8) = __floats2bfloat162_rn(
          p.sc2 * acc[dt][2 * r], p.sc2 * acc[dt][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16(BwdParams p) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int NT = kTile / 8;  // n-tiles of S^T per query tile
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTile * LD;
  bf16* Qs = Vs + kTile * LD;
  bf16* dOs = Qs + kTile * LD;
  float* Ls = reinterpret_cast<float*>(dOs + kTile * LD);
  float* Dl = Ls + kTile;

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = blockIdx.x * kTile;
  const int nk = min(kTile, p.M - k0);
  const bf16* q = base<const bf16>(p, kQ, b, h);
  const bf16* k = base<const bf16>(p, kK, b, h) + k0 * p.st[kK][2];
  const bf16* v = base<const bf16>(p, kV, b, h) + k0 * p.st[kV][2];
  const bf16* dout = base<const bf16>(p, kDO, b, h);
  bf16* dk = base<bf16>(p, kDK, b, h) + k0 * p.st[kDK][2];
  bf16* dv = base<bf16>(p, kDV, b, h) + k0 * p.st[kDV][2];
  const float* lse = base<const float>(p, kLse, b, h);
  const float* delta = base<const float>(p, kDelta, b, h);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  load_tile<D, LD, kTile, kThreads>(Ks, k, p.st[kK][2], nk, false, 1.f);
  load_tile<D, LD, kTile, kThreads>(Vs, v, p.st[kV][2], nk, false, 1.f);

  float acck[DT][4], accv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[dt][e] = accv[dt][e] = 0.f;
  }

  for (int q0 = 0; q0 < p.N; q0 += kTile) {
    const int nq = min(kTile, p.N - q0);
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D, LD, kTile, kThreads>(Qs, q + q0 * p.st[kQ][2], p.st[kQ][2], nq, false, 1.f);
    load_tile<D, LD, kTile, kThreads>(dOs, dout + q0 * p.st[kDO][2], p.st[kDO][2], nq, false, 1.f);
    if (threadIdx.x < kTile) {
      const int i = threadIdx.x;
      Ls[i] = i < nq ? lse[(q0 + i) * p.st[kLse][2]] : 0.f;
      Dl[i] = i < nq ? delta[(q0 + i) * p.st[kDelta][2]] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's 16 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, Ks, warp * 16, kk * 16, g, t4);
      load_a<LD>(va, Vs, warp * 16, kk * 16, g, t4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* qp = Qs + (nt * 8 + g) * LD + kk * 16 + t4 * 2;
        mma_bf16(s[nt], ka, ld32(qp), ld32(qp + 8));
        const bf16* dop = dOs + (nt * 8 + g) * LD + kk * 16 + t4 * 2;
        mma_bf16(dp[nt], va, ld32(dop), ld32(dop + 8));
      }
    }
    // P^T in place of S^T, dS^T in place of dP^T; lse and D by column
    // (query); queries past N give P = 0 and dS = 0
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t4 * 2 + (e & 1);
        float pv = 0.f, ds = 0.f;
        if (col < nq) {
          pv = expf(__fmul_rn(p.sc2, s[nt][e]) - Ls[col]);
          ds = pv * (dp[nt][e] - Dl[col]);
        }
        s[nt][e] = pv;
        dp[nt][e] = ds;
      }
    }
    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4], da[4];
      a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
      a_from_c(da, dp[2 * kk], dp[2 * kk + 1]);
      const bf16* dop = dOs + (kk * 16 + t4 * 2) * LD + g;
      const bf16* qp = Qs + (kk * 16 + t4 * 2) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const bf16* x = dop + dt * 8;
        mma_bf16(accv[dt], pa, pack_h(x[0], x[LD]), pack_h(x[8 * LD], x[9 * LD]));
        const bf16* y = qp + dt * 8;
        mma_bf16(acck[dt], da, pack_h(y[0], y[LD]), pack_h(y[8 * LD], y[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    if (row >= nk) continue;
    bf16* ko = dk + row * p.st[kDK][2] + t4 * 2;
    bf16* vo = dv + row * p.st[kDV][2] + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(ko + dt * 8) = __floats2bfloat162_rn(
          p.sc2 * acck[dt][2 * r], p.sc2 * acck[dt][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vo + dt * 8) = __floats2bfloat162_rn(
          accv[dt][2 * r], accv[dt][2 * r + 1]);
    }
  }
}

// f32: 32 rows a block, four lanes a row; lane `sub` holds elements
// 4 * i + sub of the row's vectors. Sums over d are reduced over the four
// lanes with shuffles.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32(BwdParams p) {
  constexpr int DP = D / 4;
  __shared__ float Ks[kTile32][D];
  __shared__ float Vs[kTile32][D];

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int row = blockIdx.x * kTile32 + (threadIdx.x >> 2);
  const int sub = threadIdx.x & 3;
  const bool valid = row < p.N;
  const float* q = base<const float>(p, kQ, b, h) + row * p.st[kQ][2];
  const float* o = base<const float>(p, kO, b, h) + row * p.st[kO][2];
  const float* dout = base<const float>(p, kDO, b, h) + row * p.st[kDO][2];
  const float* k = base<const float>(p, kK, b, h);
  const float* v = base<const float>(p, kV, b, h);

  float qr[DP], dor[DP], acc[DP];
  float dsum = 0.f;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = valid ? q[4 * i + sub] : 0.f;
    dor[i] = valid ? dout[4 * i + sub] : 0.f;
    dsum = fmaf(dor[i], valid ? o[4 * i + sub] : 0.f, dsum);
    acc[i] = 0.f;
  }
  dsum = quad_sum(dsum);
  if (valid && sub == 0) base<float>(p, kDelta, b, h)[row * p.st[kDelta][2]] = dsum;
  const float l = valid ? base<const float>(p, kLse, b, h)[row * p.st[kLse][2]] : 0.f;

  for (int k0 = 0; k0 < p.M; k0 += kTile32) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTile32 * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const bool ok = k0 + j < p.M;
      Ks[j][d] = ok ? k[(k0 + j) * p.st[kK][2] + d] : 0.f;
      Vs[j][d] = ok ? v[(k0 + j) * p.st[kV][2] + d] : 0.f;
    }
    __syncthreads();
    const int nk = min(kTile32, p.M - k0);  // the same for the whole block
    for (int j = 0; j < nk; ++j) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        sp = fmaf(qr[i], Ks[j][4 * i + sub], sp);
        dpp = fmaf(dor[i], Vs[j][4 * i + sub], dpp);
      }
      sp = quad_sum(sp);
      dpp = quad_sum(dpp);
      const float pj = expf(__fmul_rn(p.sc2, sp) - l);
      const float ds = pj * (dpp - dsum);
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(ds, Ks[j][4 * i + sub], acc[i]);
    }
  }
  if (valid) {
    float* out = base<float>(p, kDQ, b, h) + row * p.st[kDQ][2];
#pragma unroll
    for (int i = 0; i < DP; ++i) out[4 * i + sub] = p.sc2 * acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32(BwdParams p) {
  constexpr int DP = D / 4;
  __shared__ float Qs[kTile32][D];
  __shared__ float dOs[kTile32][D];
  __shared__ float Ls[kTile32];
  __shared__ float Dl[kTile32];

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int key = blockIdx.x * kTile32 + (threadIdx.x >> 2);
  const int sub = threadIdx.x & 3;
  const bool valid = key < p.M;
  const float* k = base<const float>(p, kK, b, h) + key * p.st[kK][2];
  const float* v = base<const float>(p, kV, b, h) + key * p.st[kV][2];
  const float* q = base<const float>(p, kQ, b, h);
  const float* dout = base<const float>(p, kDO, b, h);
  const float* lse = base<const float>(p, kLse, b, h);
  const float* delta = base<const float>(p, kDelta, b, h);

  float kr[DP], vr[DP], acck[DP], accv[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    kr[i] = valid ? k[4 * i + sub] : 0.f;
    vr[i] = valid ? v[4 * i + sub] : 0.f;
    acck[i] = accv[i] = 0.f;
  }

  for (int q0 = 0; q0 < p.N; q0 += kTile32) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTile32 * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const bool ok = q0 + j < p.N;
      Qs[j][d] = ok ? q[(q0 + j) * p.st[kQ][2] + d] : 0.f;
      dOs[j][d] = ok ? dout[(q0 + j) * p.st[kDO][2] + d] : 0.f;
    }
    if (threadIdx.x < kTile32) {
      const int j = threadIdx.x;
      const bool ok = q0 + j < p.N;
      Ls[j] = ok ? lse[(q0 + j) * p.st[kLse][2]] : 0.f;
      Dl[j] = ok ? delta[(q0 + j) * p.st[kDelta][2]] : 0.f;
    }
    __syncthreads();
    const int nq = min(kTile32, p.N - q0);  // queries past N are skipped
    for (int j = 0; j < nq; ++j) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        sp = fmaf(kr[i], Qs[j][4 * i + sub], sp);
        dpp = fmaf(vr[i], dOs[j][4 * i + sub], dpp);
      }
      sp = quad_sum(sp);
      dpp = quad_sum(dpp);
      const float pj = expf(__fmul_rn(p.sc2, sp) - Ls[j]);
      const float ds = pj * (dpp - Dl[j]);
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        accv[i] = fmaf(pj, dOs[j][4 * i + sub], accv[i]);
        acck[i] = fmaf(ds, Qs[j][4 * i + sub], acck[i]);
      }
    }
  }
  if (valid) {
    float* ko = base<float>(p, kDK, b, h) + key * p.st[kDK][2];
    float* vo = base<float>(p, kDV, b, h) + key * p.st[kDV][2];
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      ko[4 * i + sub] = p.sc2 * acck[i];
      vo[4 * i + sub] = accv[i];
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  *done = true;
  return 0;
}

// which: 0 = dQ (and D), 1 = dK/dV
template <int D>
int launch(int which, int is_bf16, const BwdParams& p, int BH, cudaStream_t stream) {
  const int rows = which == 0 ? p.N : p.M;
  if (is_bf16) {
    constexpr int smem = bf16_smem_bytes<D>();
    static bool dq_attr = false, dkv_attr = false;
    const dim3 grid((rows + kTile - 1) / kTile, BH);
    int err;
    if (which == 0) {
      if ((err = set_smem(flash_bwd_dq_bf16<D>, smem, &dq_attr)) != 0) return err;
      flash_bwd_dq_bf16<D><<<grid, kThreads, smem, stream>>>(p);
    } else {
      if ((err = set_smem(flash_bwd_dkv_bf16<D>, smem, &dkv_attr)) != 0) return err;
      flash_bwd_dkv_bf16<D><<<grid, kThreads, smem, stream>>>(p);
    }
  } else {
    const dim3 grid((rows + kTile32 - 1) / kTile32, BH);
    if (which == 0) {
      flash_bwd_dq_f32<D><<<grid, kThreads, 0, stream>>>(p);
    } else {
      flash_bwd_dkv_f32<D><<<grid, kThreads, 0, stream>>>(p);
    }
  }
  return (int)cudaGetLastError();
}

int dispatch(int which, int is_bf16, void* const* ptrs, int B, int H, int N,
             int M, int D, const long long* strides, float sc2, void* stream) {
  BwdParams p;
  for (int i = 0; i < kOperands; ++i) {
    p.ptr[i] = ptrs[i];
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  }
  p.H = H;
  p.N = N;
  p.M = M;
  p.sc2 = sc2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(which, is_bf16, p, B * H, st);
    case 32: return launch<32>(which, is_bf16, p, B * H, st);
    case 64: return launch<64>(which, is_bf16, p, B * H, st);
    case 128: return launch<128>(which, is_bf16, p, B * H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ptrs[10]: q, k, v, o, dO, dq, dk, dv ([B, H, N|M, D], unit-stride head dim)
// and lse, delta ([B, H, N] f32); strides[30]: (batch, head, token) element
// strides of each, in the same order. is_bf16: 1 for bfloat16, 0 for
// float32. sc2 is s^2, the square of the forward's scale taken in double
// and rounded to f32 once, as the TPU kernels' sc2 = scale * scale is. D in
// {16, 32, 64, 128}; any other D returns cudaErrorInvalidValue without
// launching.
//
// mf_flash_attention_bwd_dq writes dq and delta = rowsum(dO * O);
// mf_flash_attention_bwd_dkv reads delta and writes dk and dv, so it runs
// after the dQ kernel on the same stream.
extern "C" int mf_flash_attention_bwd_dq(int is_bf16, void* const* ptrs, int B,
                                         int H, int N, int M, int D,
                                         const long long* strides, float sc2,
                                         void* stream) {
  return dispatch(0, is_bf16, ptrs, B, H, N, M, D, strides, sc2, stream);
}

extern "C" int mf_flash_attention_bwd_dkv(int is_bf16, void* const* ptrs, int B,
                                          int H, int N, int M, int D,
                                          const long long* strides, float sc2,
                                          void* stream) {
  return dispatch(1, is_bf16, ptrs, B, H, N, M, D, strides, sc2, stream);
}
