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
// once at the end. bf16 takes P = exp2(S * log2e - lse * log2e) on the SFU
// (ex2.approx), a few f32 ulps from exp(S - lse) before P's bf16 rounding.
//
// Two kernels, as on the TPU, so that no sum crosses blocks: no atomics, and
// the result is the same bits on every run.
//   * dQ: one block per (batch*head, 64 queries), looping over key tiles.
//     It also computes D for its rows, keeps it for dS and writes it out for
//     the dK/dV kernel, which runs after it on the same stream.
//   * dK/dV: one block per (batch*head, 64 keys), looping over query tiles.
//     It computes S^T = K Q^T directly, rows being keys, so that P^T and
//     dS^T come out of the accumulators as the A operands of P^T dO and
//     dS^T Q, and lse and D are per-column values.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s, 132 SMs): tensor-core
// FLOPs, 6*BH*N*M*d for dQ (q k^T, dO v^T, dS k) and 8*BH*N*M*d for dK/dV
// (k q^T, v dO^T, P^T dO, dS^T q), against reading q, k, v, o, dO, lse, D
// and writing dq, dk, dv once. Each kernel also takes BH*N*M exponentials,
// at 16 a clock on each SM: at d = 32 (the 1,024-token shape, B = 32, H = 8)
// that is 0.064 ms at 1.98 GHz against a FLOP bound of 0.052 ms (dQ) and
// 0.069 ms (dK/dV), so at d = 32 the SFU, not the tensor cores, sets the
// dQ kernel's floor; exp2 saves expf's range reduction on the FMA pipe.
//
// bf16 design (one block = one consumer warpgroup + one producer warp):
//   * warps 0-3 are the consumer warpgroup and own the block's 64 rows, the
//     M of every wgmma (m64nNk16, bf16 in, f32 accumulate). dQ: S = Q K^T
//     and dP = dO V^T with both operands in shared memory (Q and dO resident,
//     K and V by tile); dS leaves the accumulators as bf16 A fragments in
//     registers, and dQ += dS K reads the K tile MN-major through the
//     descriptor's transpose bit (no transposed copy). dK/dV: S^T = K Q^T and
//     dP^T = V dO^T (K and V resident), then dV += P^T dO and dK += dS^T Q
//     from registers, reading dO and Q MN-major.
//   * warp 4 is the producer: it loads the resident tiles once and the
//     looped tiles (K and V; Q and dO) with TMA (cp.async.bulk.tensor, 4-D
//     maps (d, token, head, batch) built from the strides, so one map serves
//     both layouts) into a ring of stages, each signalled by a "full"
//     mbarrier (TMA bytes) and released by an "empty" one (the consumers'
//     128 arrivals). The producer of dK/dV also copies the tile's lse * log2e
//     and D (ordinary loads: the token layout's lse stride is H * 4 bytes,
//     under TMA's 16-byte rule at H < 4) into the stage before it arrives.
//   * what sets the pace is each warpgroup's serial chain (scores, then the
//     exponentials and dS, then the accumulating products), hidden only by
//     the other blocks on the SM. So the sizes favour blocks per SM over
//     work per block: looped tiles of 64 keys in dQ and 32 queries in dK/dV,
//     whose two accumulators (dK, dV) leave less room for the scores (92
//     registers a thread at d = 32, four blocks an SM, against 130 and three
//     with 64 queries; d = 128: ~190 registers, and 64 queries would spill);
//     2 stages, 3 for dQ at d = 128. On an H100 (PERF.md) these beat
//     deeper rings, 64-query dK/dV tiles, 32-key dQ tiles, two consumer
//     warpgroups sharing each looped tile (288 threads: one block an SM),
//     and issuing the next tile's scores behind this tile's products (more
//     live registers, fewer blocks). With a one-warp producer, setmaxnreg
//     would move too few registers to matter, and is not used.
//   * shared tiles use TMA's 32/64/128-byte swizzle (row width 2 * min(d,
//     64) bytes; d = 128 is two 64-column halves), which is the layout the
//     wgmma descriptors read (hopper_sm90.cuh). TMA zero-fills rows past N
//     or M; keys past M still get P = 0 in the dQ kernel and queries past N
//     P = 0 and dS = 0 in the dK/dV kernel (their lse and D are not data).
//
// Head widths: every d that is a multiple of 8, up to 1,024. d <= 128 runs
// the kernels compiled for the next width of 16, 32, 64 and 128 (PAD = true
// where d is narrower: the widths 16-128 themselves keep the instantiations
// without the column checks): TMA zero-fills the tiles' columns past d, D
// sums only d columns, and only d columns of dq, dk and dv are stored. d > 128 (the *_wide kernels) splits
// the gradients' columns into 128-wide chunks over gridDim.z; each block
// streams 64-column slices of both operands of the score products (Q and
// K, then dO and V, for S and dP; K and Q, then V and dO, for S^T and
// dP^T) through a ring of 16 KB stages, then its chunk of the looped
// operand (K for dQ; dO and Q for dK/dV) for the accumulating products.
// Every chunk recomputes the scores (d / 128 times their FLOPs); the dQ
// kernel's chunk 0 writes D.
// f32 (classifier guidance and training, the f32 paths): every product on
// the tensor cores in split-TF32 (three tf32 mma.syncs, f32-accurate), 16
// output rows a block, the loop over the other side split across the
// block's warps, each with its own cp.async ring; see "f32" below.
//
// Launches go on the caller's stream; the kernels allocate nothing. Each
// entry point returns cudaGetLastError() after its launch, or 10000 plus
// the CUresult where a tensor map cannot be encoded.

#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "hopper_sm90.cuh"

namespace {

using namespace mf_flash;
using namespace mf_sm90;

// operands, in the order of the entry points' pointer and stride arrays
enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kLse, kDelta, kOperands };

struct BwdParams {
  void* ptr[kOperands];
  long long st[kOperands][3];  // batch, head, token strides in elements
  int H, N, M, d;
  float sc2;
};

template <typename T>
__device__ __forceinline__ T* base(const BwdParams& p, int which, int b, int h) {
  return static_cast<T*>(p.ptr[which]) + b * p.st[which][0] + h * p.st[which][1];
}

constexpr int kTile = 64;  // rows of a bf16 block: one warpgroup's wgmma M
constexpr int kConsumers = 128;  // warps 0-3
constexpr int kBf16Threads = kConsumers + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

// Looped tile rows, keys (dQ) or queries (dK/dV), and the ring's stages,
// as measured fastest on an H100 (see the note at the top).
__host__ __device__ constexpr int loop_rows(int which) {
  return which == 0 ? 64 : 32;
}
template <int D>
__host__ __device__ constexpr int ring_stages(int which) {
  return which == 0 && D == 128 ? 3 : 2;
}

// Shared memory of a bf16 block, from a 1,024-byte aligned base: two
// resident tiles, the ring (two looped tiles and two f32 vectors a stage),
// D of the block's rows, the mbarriers.
template <int D, int LOOP, int STAGES>
struct BwdSmem {
  using Res = SwTile<D, kTile>;
  using Loop = SwTile<D, LOOP>;
  static constexpr int kRes1 = Res::BYTES;
  static constexpr int kRing = 2 * Res::BYTES;
  static constexpr int kStage = 2 * Loop::BYTES;
  static constexpr int kVec = kRing + STAGES * kStage;  // [stage][2][LOOP] f32
  static constexpr int kRows = kVec + STAGES * 2 * LOOP * 4;  // [64] f32
  static constexpr int kBars = kRows + kTile * 4;  // res, full[], empty[]
  static constexpr int kBytes = kBars + (1 + 2 * STAGES) * 8 + 1024;  // + alignment
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// dq (or dk, dv) rows r0 and r0 + 8 of a [64, D] accumulator held as
// halves of W columns, times `scale`, to rows [0, valid) of out.
// Columns of the accumulator at or past d (zero-fill, or a chunk's half
// that lies past d) are not stored.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long st, int valid, int r0,
                                           int t4, const float (&acc)[D / SwTile<D, 64>::W][SwTile<D, 64>::W / 2],
                                           float scale, int d) {
  constexpr int W = SwTile<D, 64>::W;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= valid) continue;
    bf16* o = out + row * st + t4 * 2;
#pragma unroll
    for (int h = 0; h < D / W; ++h) {
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        if (h * W + j * 8 >= d) continue;
        *reinterpret_cast<__nv_bfloat162*>(o + h * W + j * 8) = __floats2bfloat162_rn(
            scale * acc[h][4 * j + 2 * r], scale * acc[h][4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int D, bool PAD>
__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_bwd_dq_bf16(BwdParams p, const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv) {
  constexpr int BK = loop_rows(0);
  constexpr int kStages = ring_stages<D>(0);
  using L = BwdSmem<D, BK, kStages>;
  using Res = typename L::Res;
  using Loop = typename L::Loop;
  constexpr int W = Res::W;
  constexpr int HALVES = D / W;
  unsigned char* smem = aligned_smem();
  const uint32_t s0 = smem_addr(smem);
  const uint32_t sQ = s0, sDO = s0 + L::kRes1;
  float* Ds = reinterpret_cast<float*>(smem + L::kRows);
  const uint32_t bars = s0 + L::kBars;  // res, full[kStages], empty[kStages]
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_tile = [&](int s) { return s0 + L::kRing + s * L::kStage; };
  auto v_tile = [&](int s) { return k_tile(s) + Loop::BYTES; };

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kTile;
  const int nq = min(kTile, p.N - q0);
  const int tiles = (p.M + BK - 1) / BK;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one lane issues TMA
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(bars, 2 * Res::BYTES);
      for (int hf = 0; hf < HALVES; ++hf) {
        tma_load_4d(sQ + hf * Res::HALF_BYTES, &tq, hf * W, q0, h, b, bars);
        tma_load_4d(sDO + hf * Res::HALF_BYTES, &tdo, hf * W, q0, h, b, bars);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), L::kStage);
        for (int hf = 0; hf < HALVES; ++hf) {
          tma_load_4d(k_tile(s) + hf * Loop::HALF_BYTES, &tk, hf * W, it * BK, h, b, full(s));
          tma_load_4d(v_tile(s) + hf * Loop::HALF_BYTES, &tv, hf * W, it * BK, h, b, full(s));
        }
      }
    }
  } else {  // the consumer warpgroup
    const bf16* o = base<const bf16>(p, kO, b, h) + q0 * p.st[kO][2];
    const bf16* dout = base<const bf16>(p, kDO, b, h) + q0 * p.st[kDO][2];
    const float* lse = base<const float>(p, kLse, b, h) + q0 * p.st[kLse][2];
    float* delta = base<float>(p, kDelta, b, h) + q0 * p.st[kDelta][2];
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
          if (PAD && half * (D / 2) + c >= p.d) break;
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
    consumer_sync();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
    float l2[2], d_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      l2[r] = row < nq ? lse[row * p.st[kLse][2]] * kLog2e : 0.f;
      d_r[r] = Ds[row];
    }
    float acc[HALVES][W / 2];
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[hf][i] = 0.f;
    }
    mbar_wait(bars, 0);

    for (int it = 0; it < tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<BK>::ss(sc, Res::k_major(sQ, kk), Loop::k_major(k_tile(s), kk), kk > 0);
        Wgmma<BK>::ss(dp, Res::k_major(sDO, kk), Loop::k_major(v_tile(s), kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // dS = P * (dP - D) in place of S; keys past M give P = 0
      const int k0 = it * BK;
      const bool ragged = k0 + BK > p.M;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = ex2(fmaf(__fmul_rn(p.sc2, sc[4 * j + e]), kLog2e, -l2[e >> 1]));
          if (ragged && k0 + j * 8 + t4 * 2 + (e & 1) >= p.M) pv = 0.f;
          sc[4 * j + e] = pv * (dp[4 * j + e] - d_r[e >> 1]);
        }
      }
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) a_from_c(a[kk], &sc[8 * kk], &sc[8 * kk + 4]);
      // dQ += dS K, dS rounded to bf16, the K tile read MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf) {
          Wgmma<W>::rs(acc[hf], a[kk], Loop::mn_major(k_tile(s), kk, hf));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) fence_regs(acc[hf]);
      mbar_arrive(empty(s));
    }
    store_rows<D>(base<bf16>(p, kDQ, b, h) + q0 * p.st[kDQ][2], p.st[kDQ][2], nq, r0, t4,
                  acc, p.sc2, PAD ? p.d : D);
  }
}

template <int D, bool PAD>
__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_bwd_dkv_bf16(BwdParams p, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo) {
  constexpr int BQ = loop_rows(1);
  constexpr int kStages = ring_stages<D>(1);
  using L = BwdSmem<D, BQ, kStages>;
  using Res = typename L::Res;
  using Loop = typename L::Loop;
  constexpr int W = Res::W;
  constexpr int HALVES = D / W;
  unsigned char* smem = aligned_smem();
  const uint32_t s0 = smem_addr(smem);
  const uint32_t sK = s0, sV = s0 + L::kRes1;
  float* vec = reinterpret_cast<float*>(smem + L::kVec);  // [stage][lse*log2e, D][BQ]
  const uint32_t bars = s0 + L::kBars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto q_tile = [&](int s) { return s0 + L::kRing + s * L::kStage; };
  auto do_tile = [&](int s) { return q_tile(s) + Loop::BYTES; };

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = blockIdx.x * kTile;
  const int nk = min(kTile, p.M - k0);
  const int tiles = (p.N + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes
      mbar_init(empty(s), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    const float* lse = base<const float>(p, kLse, b, h);
    const float* delta = base<const float>(p, kDelta, b, h);
    if (lane == 0) {
      mbar_arrive_expect_tx(bars, 2 * Res::BYTES);
      for (int hf = 0; hf < HALVES; ++hf) {
        tma_load_4d(sK + hf * Res::HALF_BYTES, &tk, hf * W, k0, h, b, bars);
        tma_load_4d(sV + hf * Res::HALF_BYTES, &tv, hf * W, k0, h, b, bars);
      }
    }
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
      float* ls = vec + s * 2 * BQ;
      for (int i = lane; i < BQ; i += 32) {
        const int q = it * BQ + i;
        ls[i] = q < p.N ? lse[q * p.st[kLse][2]] * kLog2e : 0.f;
        ls[BQ + i] = q < p.N ? delta[q * p.st[kDelta][2]] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full(s), L::kStage);
        for (int hf = 0; hf < HALVES; ++hf) {
          tma_load_4d(q_tile(s) + hf * Loop::HALF_BYTES, &tq, hf * W, it * BQ, h, b, full(s));
          tma_load_4d(do_tile(s) + hf * Loop::HALF_BYTES, &tdo, hf * W, it * BQ, h, b,
                      full(s));
        }
      } else {
        mbar_arrive(full(s));
      }
    }
  } else {  // the consumer warpgroup: rows are this block's 64 keys
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    float acck[HALVES][W / 2], accv[HALVES][W / 2];
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acck[hf][i] = accv[hf][i] = 0.f;
    }
    mbar_wait(bars, 0);

    for (int it = 0; it < tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      // S^T = K Q^T and dP^T = V dO^T
      float sc[BQ / 2], dp[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<BQ>::ss(sc, Res::k_major(sK, kk), Loop::k_major(q_tile(s), kk), kk > 0);
        Wgmma<BQ>::ss(dp, Res::k_major(sV, kk), Loop::k_major(do_tile(s), kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // P^T in place of S^T, dS^T in place of dP^T; lse and D by column
      // (query); queries past N give P = 0 and dS = 0
      const float* ls = vec + s * 2 * BQ;
      const int q0 = it * BQ;
      const bool ragged = q0 + BQ > p.N;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int col = j * 8 + t4 * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 dd = *reinterpret_cast<const float2*>(ls + BQ + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lc = (e & 1) ? l2.y : l2.x;
          const float dc = (e & 1) ? dd.y : dd.x;
          float pv = ex2(fmaf(__fmul_rn(p.sc2, sc[4 * j + e]), kLog2e, -lc));
          float ds = pv * (dp[4 * j + e] - dc);
          if (ragged && q0 + col + (e & 1) >= p.N) pv = ds = 0.f;
          sc[4 * j + e] = pv;
          dp[4 * j + e] = ds;
        }
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        a_from_c(pa[kk], &sc[8 * kk], &sc[8 * kk + 4]);
        a_from_c(da[kk], &dp[8 * kk], &dp[8 * kk + 4]);
      }
      // dV += P^T dO and dK += dS^T Q, the dO and Q tiles read MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf) {
          Wgmma<W>::rs(accv[hf], pa[kk], Loop::mn_major(do_tile(s), kk, hf));
          Wgmma<W>::rs(acck[hf], da[kk], Loop::mn_major(q_tile(s), kk, hf));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) {
        fence_regs(acck[hf]);
        fence_regs(accv[hf]);
      }
      mbar_arrive(empty(s));
    }
    const int r0 = warp * 16 + g;
    store_rows<D>(base<bf16>(p, kDK, b, h) + k0 * p.st[kDK][2], p.st[kDK][2], nk, r0, t4,
                  acck, p.sc2, PAD ? p.d : D);
    store_rows<D>(base<bf16>(p, kDV, b, h) + k0 * p.st[kDV][2], p.st[kDV][2], nk, r0, t4,
                  accv, 1.f, PAD ? p.d : D);
  }
}

// ---- d > 128 (bf16) ----
// One block = 64 rows (queries for dQ, keys for dK/dV) x one 128-column
// chunk of the gradients (blockIdx.z). Each looped tile is a stream of
// 2 * kSlices(d) + 1 items through a ring of kWStages stages of 16 KB: the
// 64-column slices of the two score products' operands, A in the stage's
// first 8 KB and B in its second (dQ: (Q_j, K_j), then (dO_j, V_j); dK/dV:
// (K_j, Q_j), then (V_j, dO_j)), then the chunk of the looped operand that
// the accumulating products read MN-major (dQ: K's [64 keys, 128]; dK/dV:
// dO's and Q's [32 queries, 128], with the tile's lse * log2e and D).
constexpr int kWStages = 4;
constexpr int kHalf = 64 * 128;        // bytes of a [64, 64] bf16 tile
constexpr int kWStage = 2 * kHalf;
constexpr int kWideBQ = 32;            // queries of a dK/dV looped tile

__host__ __device__ constexpr int kSlices(int d) { return (d + 63) / 64; }
// ring, per-stage vectors (dK/dV: [2][kWideBQ] f32), D of the rows (dQ),
// mbarriers (full[], empty[])
constexpr int kWVec = kWStages * kWStage;
constexpr int kWRows = kWVec + kWStages * 2 * kWideBQ * 4;
constexpr int kWBars = kWRows + kTile * 4;
constexpr int kWideSmem = kWBars + 2 * kWStages * 8 + 1024;

// The score product over the d-slices: items first .. first + nsl - 1,
// each A [64, 64] (K-major) x B [BROWS, 64]^T into acc; a slice's stage is
// freed once the next slice's products are issued and its own completed.
template <int BROWS>
__device__ __forceinline__ void slice_products(float* acc, int nsl, int first, uint32_t ring,
                                               uint32_t bars) {
  for (int j = 0; j < nsl; ++j) {
    const int i = first + j;
    const int st = i % kWStages;
    const uint32_t stage = ring + st * kWStage;
    mbar_wait(bars + 8 * st, (i / kWStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma<BROWS>::ss(acc, SwTile<64, kTile>::k_major(stage, kk),
                       SwTile<64, BROWS>::k_major(stage + kHalf, kk), j > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (j > 0) mbar_arrive(bars + 8 * (kWStages + (i - 1) % kWStages));
  }
  wgmma_wait<0>();
  mbar_arrive(bars + 8 * (kWStages + (first + nsl - 1) % kWStages));
}

// rows r0, r0 + 8 of a [64, 128] chunk accumulator (two halves), times
// scale, to columns [c0, min(c0 + 128, d)) of rows [0, valid) of out.
__device__ __forceinline__ void store_chunk(bf16* out, long long st, int valid, int r0, int t4,
                                            const float (&acc)[2][32], float scale, int c0,
                                            int d) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= valid) continue;
    bf16* o = out + row * st + c0 + t4 * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (c0 + h * 64 + j * 8 >= d) continue;
        *reinterpret_cast<__nv_bfloat162*>(o + h * 64 + j * 8) = __floats2bfloat162_rn(
            scale * acc[h][4 * j + 2 * r], scale * acc[h][4 * j + 2 * r + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_bwd_dq_bf16_wide(BwdParams p, const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv) {
  using Chunk = SwTile<128, kTile>;
  const int nsl = kSlices(p.d);
  const int per_tile = 2 * nsl + 1;
  const int c0 = blockIdx.z * 128;
  const bool hi = c0 + 64 < p.d;
  unsigned char* smem = aligned_smem();
  const uint32_t s0 = smem_addr(smem);
  float* Ds = reinterpret_cast<float*>(smem + kWRows);
  const uint32_t bars = s0 + kWBars;  // full[kWStages], empty[kWStages]
  auto stage = [&](int st) { return s0 + st * kWStage; };

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kTile;
  const int nq = min(kTile, p.N - q0);
  const int tiles = (p.M + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kWStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kWStages + st), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one lane issues TMA
    if (threadIdx.x == kConsumers) {
      for (int i = 0; i < tiles * per_tile; ++i) {
        const int st = i % kWStages;
        const uint32_t full = bars + 8 * st;
        if (i >= kWStages) mbar_wait(bars + 8 * (kWStages + st), ((i / kWStages) & 1) ^ 1);
        const int it = i / per_tile, j = i % per_tile;
        if (j < 2 * nsl) {
          const int col = (j % nsl) * 64;
          mbar_arrive_expect_tx(full, 2 * kHalf);
          tma_load_4d(stage(st), j < nsl ? &tq : &tdo, col, q0, h, b, full);
          tma_load_4d(stage(st) + kHalf, j < nsl ? &tk : &tv, col, it * kTile, h, b, full);
        } else {
          mbar_arrive_expect_tx(full, hi ? 2 * kHalf : kHalf);
          tma_load_4d(stage(st), &tk, c0, it * kTile, h, b, full);
          if (hi) tma_load_4d(stage(st) + kHalf, &tk, c0 + 64, it * kTile, h, b, full);
        }
      }
    }
  } else {  // the consumer warpgroup
    const bf16* o = base<const bf16>(p, kO, b, h) + q0 * p.st[kO][2];
    const bf16* dout = base<const bf16>(p, kDO, b, h) + q0 * p.st[kDO][2];
    const float* lse = base<const float>(p, kLse, b, h) + q0 * p.st[kLse][2];
    float* delta = base<float>(p, kDelta, b, h) + q0 * p.st[kDelta][2];
    {
      // D = rowsum(dO * O) in f32 over all d, two threads a row
      const int r = threadIdx.x >> 1;
      const int half = threadIdx.x & 1;
      const int w = p.d / 2;  // a multiple of 4
      float sum = 0.f;
      if (r < nq) {
        const bf16* orow = o + r * p.st[kO][2] + half * w;
        const bf16* drow = dout + r * p.st[kDO][2] + half * w;
        for (int c = 0; c < w; c += 2) {
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + c));
          const float2 dd = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + c));
          sum = fmaf(dd.x, a.x, sum);
          sum = fmaf(dd.y, a.y, sum);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) {
        Ds[r] = sum;
        if (r < nq && blockIdx.z == 0) delta[r * p.st[kDelta][2]] = sum;
      }
    }
    consumer_sync();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int r0 = warp * 16 + g;
    float l2[2], d_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      l2[r] = row < nq ? lse[row * p.st[kLse][2]] * kLog2e : 0.f;
      d_r[r] = Ds[row];
    }
    float acc[2][32];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hf][i] = 0.f;
    }
    for (int it = 0; it < tiles; ++it) {
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      slice_products<64>(sc, nsl, it * per_tile, s0, bars);
      slice_products<64>(dp, nsl, it * per_tile + nsl, s0, bars);
      fence_regs(sc);
      fence_regs(dp);
      const int k0 = it * kTile;
      const bool ragged = k0 + kTile > p.M;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = ex2(fmaf(__fmul_rn(p.sc2, sc[4 * j + e]), kLog2e, -l2[e >> 1]));
          if (ragged && k0 + j * 8 + t4 * 2 + (e & 1) >= p.M) pv = 0.f;
          sc[4 * j + e] = pv * (dp[4 * j + e] - d_r[e >> 1]);
        }
      }
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_from_c(a[kk], &sc[8 * kk], &sc[8 * kk + 4]);
      // dQ[:, chunk] += dS K[:, chunk], the chunk read MN-major
      const int i = it * per_tile + 2 * nsl;
      const int st = i % kWStages;
      mbar_wait(bars + 8 * st, (i / kWStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Wgmma<64>::rs(acc[0], a[kk], Chunk::mn_major(stage(st), kk, 0));
        if (hi) Wgmma<64>::rs(acc[1], a[kk], Chunk::mn_major(stage(st), kk, 1));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      mbar_arrive(bars + 8 * (kWStages + st));
    }
    store_chunk(base<bf16>(p, kDQ, b, h) + q0 * p.st[kDQ][2], p.st[kDQ][2], nq, r0, t4, acc,
                p.sc2, c0, p.d);
  }
}

__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_bwd_dkv_bf16_wide(BwdParams p, const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo) {
  using Chunk = SwTile<128, kWideBQ>;  // [32 queries, 128]: two 4 KB halves
  const int nsl = kSlices(p.d);
  const int per_tile = 2 * nsl + 1;
  const int c0 = blockIdx.z * 128;
  const bool hi = c0 + 64 < p.d;
  unsigned char* smem = aligned_smem();
  const uint32_t s0 = smem_addr(smem);
  float* vec = reinterpret_cast<float*>(smem + kWVec);  // [stage][lse*log2e, D][kWideBQ]
  const uint32_t bars = s0 + kWBars;
  auto stage = [&](int st) { return s0 + st * kWStage; };

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = blockIdx.x * kTile;
  const int nk = min(kTile, p.M - k0);
  const int tiles = (p.N + kWideBQ - 1) / kWideBQ;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kWStages; ++st) {
      mbar_init(bars + 8 * st, 32);  // the producer warp's lanes
      mbar_init(bars + 8 * (kWStages + st), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    const float* lse = base<const float>(p, kLse, b, h);
    const float* delta = base<const float>(p, kDelta, b, h);
    for (int i = 0; i < tiles * per_tile; ++i) {
      const int st = i % kWStages;
      const uint32_t full = bars + 8 * st;
      if (i >= kWStages) mbar_wait(bars + 8 * (kWStages + st), ((i / kWStages) & 1) ^ 1);
      const int it = i / per_tile, j = i % per_tile;
      if (j == 2 * nsl) {  // the chunk item carries the tile's lse and D
        float* ls = vec + st * 2 * kWideBQ;
        const int q = it * kWideBQ + lane;
        ls[lane] = q < p.N ? lse[q * p.st[kLse][2]] * kLog2e : 0.f;
        ls[kWideBQ + lane] = q < p.N ? delta[q * p.st[kDelta][2]] : 0.f;
      }
      if (lane == 0) {
        if (j < 2 * nsl) {
          const int col = (j % nsl) * 64;
          mbar_arrive_expect_tx(full, kHalf + kWideBQ * 128);
          tma_load_4d(stage(st), j < nsl ? &tk : &tv, col, k0, h, b, full);
          tma_load_4d(stage(st) + kHalf, j < nsl ? &tq : &tdo, col, it * kWideBQ, h, b, full);
        } else {  // dO's chunk at 0, Q's at kHalf, each two halves of 4 KB
          mbar_arrive_expect_tx(full, (hi ? 4 : 2) * Chunk::HALF_BYTES);
          for (int hf = 0; hf < (hi ? 2 : 1); ++hf) {
            tma_load_4d(stage(st) + hf * Chunk::HALF_BYTES, &tdo, c0 + hf * 64, it * kWideBQ, h,
                        b, full);
            tma_load_4d(stage(st) + kHalf + hf * Chunk::HALF_BYTES, &tq, c0 + hf * 64,
                        it * kWideBQ, h, b, full);
          }
        }
      } else {
        mbar_arrive(full);
      }
    }
  } else {  // the consumer warpgroup: rows are this block's 64 keys
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    float acck[2][32], accv[2][32];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acck[hf][i] = accv[hf][i] = 0.f;
    }
    for (int it = 0; it < tiles; ++it) {
      float sc[kWideBQ / 2], dp[kWideBQ / 2];
#pragma unroll
      for (int i = 0; i < kWideBQ / 2; ++i) sc[i] = dp[i] = 0.f;
      slice_products<kWideBQ>(sc, nsl, it * per_tile, s0, bars);
      slice_products<kWideBQ>(dp, nsl, it * per_tile + nsl, s0, bars);
      fence_regs(sc);
      fence_regs(dp);
      const int i = it * per_tile + 2 * nsl;
      const int st = i % kWStages;
      mbar_wait(bars + 8 * st, (i / kWStages) & 1);
      const float* ls = vec + st * 2 * kWideBQ;
      const int q0 = it * kWideBQ;
      const bool ragged = q0 + kWideBQ > p.N;
#pragma unroll
      for (int j = 0; j < kWideBQ / 8; ++j) {
        const int col = j * 8 + t4 * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 dd = *reinterpret_cast<const float2*>(ls + kWideBQ + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lc = (e & 1) ? l2.y : l2.x;
          const float dc = (e & 1) ? dd.y : dd.x;
          float pv = ex2(fmaf(__fmul_rn(p.sc2, sc[4 * j + e]), kLog2e, -lc));
          float ds = pv * (dp[4 * j + e] - dc);
          if (ragged && q0 + col + (e & 1) >= p.N) pv = ds = 0.f;
          sc[4 * j + e] = pv;
          dp[4 * j + e] = ds;
        }
      }
      uint32_t pa[kWideBQ / 16][4], da[kWideBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWideBQ / 16; ++kk) {
        a_from_c(pa[kk], &sc[8 * kk], &sc[8 * kk + 4]);
        a_from_c(da[kk], &dp[8 * kk], &dp[8 * kk + 4]);
      }
      // dV[:, chunk] += P^T dO[:, chunk] and dK[:, chunk] += dS^T Q[:, chunk]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWideBQ / 16; ++kk) {
        Wgmma<64>::rs(accv[0], pa[kk], Chunk::mn_major(stage(st), kk, 0));
        Wgmma<64>::rs(acck[0], da[kk], Chunk::mn_major(stage(st) + kHalf, kk, 0));
        if (hi) {
          Wgmma<64>::rs(accv[1], pa[kk], Chunk::mn_major(stage(st), kk, 1));
          Wgmma<64>::rs(acck[1], da[kk], Chunk::mn_major(stage(st) + kHalf, kk, 1));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        fence_regs(acck[hf]);
        fence_regs(accv[hf]);
      }
      mbar_arrive(bars + 8 * (kWStages + st));
    }
    const int r0 = warp * 16 + g;
    store_chunk(base<bf16>(p, kDK, b, h) + k0 * p.st[kDK][2], p.st[kDK][2], nk, r0, t4, acck,
                p.sc2, c0, p.d);
    store_chunk(base<bf16>(p, kDV, b, h) + k0 * p.st[kDV][2], p.st[kDV][2], nk, r0, t4, accv,
                1.f, c0, p.d);
  }
}

// ---- f32: split-TF32 products on the tensor cores ----
// A block owns 16 output rows (query rows for dQ, key rows for dK/dV), one
// m16 tile, resident in shared memory with the rows' other operand (q and
// dO; k and v), already split into tf32 big and small parts (d <= 128), and
// read there by every warp, never again from device memory. Its W warps
// split the loop over the other side (keys; queries) into tiles of 8 rows,
// one n8 tile of the scores and one k8 step of the accumulating products:
// warp w takes tiles w, w + W, w + 2W, ..., each through its own cp.async
// ring (16-byte copies, zero-filled past N, M and d; 4 stages at d <= 64,
// 2 at 128), synchronised by the warp alone. Each warp keeps its own
// partial sums; at the end they meet in shared memory and are added in warp
// order: no atomics, the same bits on every run. Every product is
// mma_split3 (split-TF32, flash_attention_common.cuh): the scores and dP
// over the head dim in k8 steps with the resident rows as A, then P and dS
// as A fragments straight from the score accumulators; a score tile's
// columns are the looped tile's rows permuted (score_row, in
// flash_attention_common.cuh with the loads and the products shared with
// the forward's f32 kernel), so both load patterns hit 32 distinct banks.
// dK/dV computes S^T and dP^T of a query tile
// once and feeds both P^T dO and dS^T Q from them.
// Head widths: d <= 128 runs the kernels compiled for the next of 16, 32,
// 64 and 128 on zero-filled columns; d > 128 (WIDE) splits the gradients'
// columns into 128-wide chunks over gridDim.z, keeps the rows' whole d
// resident unsplit (129 KB at d = 1,024), streams the looped operands in
// 128-column slices (the chunk's own slice into a buffer kept for the
// accumulating products), two warps a block; every chunk recomputes the
// scores.
// Occupancy on an H100 at the classifier's shapes, B = 8: d = 128, N = 256,
// one head: 16 x 8 = 128 blocks of 8 warps (171 KB of shared memory, one
// block an SM), so 128 of the 132 SMs hold 8 warps, each warp 4 key (query)
// tiles; d = 32, N = 256 or 257, 4 heads: 16 or 17 x 32 blocks of 4 warps
// (51 KB, 128 registers a thread), four blocks an SM, one wave.
// Bound: 6 (dQ) and 8 (dK/dV) BH N M d FLOPs at the split-TF32 rate (495 /
// 3 TFLOP/s), against each input read and each output written once (at
// these shapes the FLOPs). What sets the pace instead: the tensor pipe's
// three mma.syncs a product and the splits' conversions (each about a
// quarter of the time at d = 128, PERF.md), and each warp's few tiles, whose
// fixed costs (the resident rows, D, the partial sums) and load latency a
// 16-row block cannot spread further.

// Shared memory of an f32 block, in floats: W slots, each a warp's ring
// and then its partial sums; the two resident [16][res_ld] tiles; lse and
// D of the block's rows (dQ).
template <int DC, bool WIDE>
struct F32Smem {
  // warps a block, the loop's shares: 8 at DC 64 and 128 (one or two
  // blocks an SM), 4 at DC <= 32 (four blocks an SM), 2 for WIDE
  static constexpr int W = WIDE ? 2 : DC <= 32 ? 4 : 8;
  static constexpr int S = DC + 8;  // a tile's row stride, 8 mod 16: no bank conflicts
  static constexpr int kTileF = kF32Tile * S;  // one looped operand's [8][S] tile
  static constexpr int kBuf = 2 * kTileF;  // both looped operands
  static constexpr int kStat = 2 * kF32Tile;  // lse and D of a query tile (dK/dV)
  // a warp's ring: kStages buffers (and stats) by tile, deeper where the
  // tiles are small; WIDE also the slice ring by step parity
  static constexpr int kStages = !WIDE && DC <= 64 ? 4 : 2;
  static constexpr int kRing = (kStages + (WIDE ? 2 : 0)) * kBuf + kStages * kStat;
  static constexpr int kPartial = 2 * kF32Rows * S;  // dK and dV (dQ: the first)
  static constexpr int kSlot = kRing > kPartial ? kRing : kPartial;
  static constexpr int kPool = W * kSlot;
  __host__ __device__ static constexpr int res_stride(int d) { return round_up(d, DC) + 8; }
  // a resident tile's row stride: raw (WIDE), or split in pairs
  __host__ __device__ static constexpr int res_ld(int d) {
    return (WIDE ? 1 : 2) * res_stride(d);
  }
  __host__ __device__ static constexpr int bytes(int d) {
    return 4 * (kPool + 2 * kF32Rows * res_ld(d) + 2 * kF32Rows);
  }
};

// Blocks an SM each f32 kernel is compiled for: 16 warps (128 registers a
// thread) at DC <= 32, where a block's work is small and more of them hide
// each other's loads; one block at the wider DC, whose accumulators need
// the registers.
template <int DC, bool WIDE>
__host__ __device__ constexpr int f32_min_blocks() {
  return DC <= 32 ? 16 / F32Smem<DC, WIDE>::W : 1;
}

// The scores (S or S^T) and dP (or dP^T) of one looped tile over one DC-wide
// slice: rows of the resident tiles x and y (columns [c, c + DC)) against
// rows pi(g) of the looped tiles tx and ty. The tensor cores round their
// f32 sums toward zero, a bias that grows with the length of a chain of
// mma.syncs on one accumulator (at d = 1,024 it cost the scores 2^-15 of
// their size); so each 16 columns are summed on a fresh accumulator and
// added to the scores in f32, rounded to nearest.
template <int DC, int S, bool WIDE>
__device__ __forceinline__ void f32_scores(float* sc, float* dp, const float* x, const float* y,
                                           int ld, const float* tx, const float* ty, int g,
                                           int t4) {
  constexpr int kSteps = DC / 8 < 2 ? DC / 8 : 2;  // k8 steps a fresh accumulator
  const int row = score_row(g) * S;
#pragma unroll
  for (int k0 = 0; k0 < DC / 8; k0 += kSteps) {
    float ps[4] = {0.f, 0.f, 0.f, 0.f}, pd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = k0; kk < k0 + kSteps; ++kk) {
      const int c = kk * 8 + 2 * t4;
      tf32_score_step<WIDE>(ps, x, ld, tx + row, g, c, 1.f);
      tf32_score_step<WIDE>(pd, y, ld, ty + row, g, c, 1.f);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[e] += ps[e];
      dp[e] += pd[e];
    }
  }
}

// The W partial sums at offset `off` of each slot, added in warp order,
// times `scale`, to rows [r0, limit) and columns [c0, d) of out.
template <int DC, int S, int W, int SLOT>
__device__ __forceinline__ void f32_store(float* out, long long st, const float* pool, int off,
                                          int r0, int limit, int c0, int d, float scale) {
  constexpr int kChunks = DC / 4;
  for (int i = threadIdx.x; i < kF32Rows * kChunks; i += W * 32) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    if (r0 + r >= limit || c0 + c >= d) continue;
    float4 s = *reinterpret_cast<const float4*>(pool + off + r * S + c);
#pragma unroll
    for (int w = 1; w < W; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(pool + w * SLOT + off + r * S + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(out + (r0 + r) * st + c0 + c) =
        make_float4(__fmul_rn(scale, s.x), __fmul_rn(scale, s.y), __fmul_rn(scale, s.z),
                    __fmul_rn(scale, s.w));
  }
}

template <int DC, bool WIDE>
__global__ void __launch_bounds__(F32Smem<DC, WIDE>::W * 32, f32_min_blocks<DC, WIDE>())
    flash_bwd_dq_f32(BwdParams p) {
  using L = F32Smem<DC, WIDE>;
  constexpr int W = L::W, S = L::S;
  extern __shared__ __align__(16) float f32_smem[];
  const int ld = L::res_ld(p.d);
  float* resQ = f32_smem + L::kPool;
  float* resDO = resQ + kF32Rows * ld;
  float* rowL = resDO + kF32Rows * ld;
  float* rowD = rowL + kF32Rows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int r0 = blockIdx.x * kF32Rows;
  const int chunk = blockIdx.z;  // dq's columns [chunk * DC, chunk * DC + DC)
  const int ns = WIDE ? (p.d + DC - 1) / DC : 1;  // slices of the head dim
  const float* kp = base<const float>(p, kK, b, h);
  const float* vp = base<const float>(p, kV, b, h);
  const long long kst = p.st[kK][2], vst = p.st[kV][2];

  load_resident<WIDE>(resQ, ld, base<const float>(p, kQ, b, h), p.st[kQ][2], r0, p.N,
                      ns * DC, p.d, W * 32);
  load_resident<WIDE>(resDO, ld, base<const float>(p, kDO, b, h), p.st[kDO][2], r0, p.N,
                      ns * DC, p.d, W * 32);
  cp_async_commit();

  float* slot = f32_smem + warp * L::kSlot;
  const int tiles = (p.M + kF32Tile - 1) / kF32Tile;
  const int mine = warp < tiles ? (tiles - warp + W - 1) / W : 0;
  const int steps = mine * ns;
  // step i: the warp's tile i / ns, slice i % ns; the chunk's own slice
  // goes to the tile's buffer, the others (WIDE) through the slice ring
  auto chunk_buf = [&](int lt) { return slot + (lt % L::kStages) * L::kBuf; };
  auto buffer = [&](int i) {
    const int lt = i / ns, s = i - lt * ns;
    return s == chunk ? chunk_buf(lt) : slot + (L::kStages + (i & 1)) * L::kBuf;
  };
  auto prefetch = [&](int i) {
    if (i < steps) {
      const int lt = i / ns, s = i - lt * ns;
      const int k0 = (warp + lt * W) * kF32Tile;
      float* dst = buffer(i);
      load_rows(dst, S, kp, kst, k0, p.M, kF32Tile, s * DC, DC, p.d, lane, 32);
      load_rows(dst + L::kTileF, S, vp, vst, k0, p.M, kF32Tile, s * DC, DC, p.d, lane, 32);
    }
    cp_async_commit();
  };
  for (int i = 0; i < L::kStages - 1; ++i) prefetch(i);
  cp_async_wait<L::kStages - 1>();
  __syncthreads();

  // D = rowsum(dO * O) and lse of the block's rows (zero past N)
  for (int r = warp; r < kF32Rows; r += W) {
    const int row = r0 + r;
    float sum = 0.f;
    if (row < p.N) {
      const float* o = base<const float>(p, kO, b, h) + row * p.st[kO][2];
      for (int c = 4 * lane; c < p.d; c += 128) {
        const float4 ov = *reinterpret_cast<const float4*>(o + c);
        float4 dv;
        if (WIDE) {
          dv = *reinterpret_cast<const float4*>(resDO + r * ld + c);
        } else {  // big + small is dO exactly
          const float4 lo = *reinterpret_cast<const float4*>(resDO + r * ld + 2 * c);
          const float4 hi = *reinterpret_cast<const float4*>(resDO + r * ld + 2 * c + 4);
          dv = make_float4(lo.x + lo.z, lo.y + lo.w, hi.x + hi.z, hi.y + hi.w);
        }
        sum = fmaf(dv.x, ov.x, sum);
        sum = fmaf(dv.y, ov.y, sum);
        sum = fmaf(dv.z, ov.z, sum);
        sum = fmaf(dv.w, ov.w, sum);
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (lane == 0) {
      rowD[r] = sum;
      rowL[r] = row < p.N ? base<const float>(p, kLse, b, h)[row * p.st[kLse][2]] : 0.f;
      if (row < p.N && chunk == 0) base<float>(p, kDelta, b, h)[row * p.st[kDelta][2]] = sum;
    }
  }
  __syncthreads();
  const float l0 = rowL[g], l1 = rowL[g + 8], d0 = rowD[g], d1 = rowD[g + 8];

  float acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float sc[4], dp[4];
  for (int i = 0; i < steps; ++i) {
    prefetch(i + L::kStages - 1);
    cp_async_wait<L::kStages - 1>();
    __syncwarp();
    const int lt = i / ns, s = i - lt * ns;
    const float* tile = buffer(i);
    if (s == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[e] = dp[e] = 0.f;
    }
    f32_scores<DC, S, WIDE>(sc, dp, resQ + s * DC, resDO + s * DC, ld, tile, tile + L::kTileF,
                            g, t4);
    if (s == ns - 1) {
      // P = exp(sc2 S - lse) and dS = P (dP - D); keys past M: P = dS = 0
      const int k0 = (warp + lt * W) * kF32Tile;
      const bool ok0 = k0 + score_row(2 * t4) < p.M, ok1 = k0 + score_row(2 * t4 + 1) < p.M;
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = e & 1 ? ok1 : ok0;
        const float pv = ok ? expf(__fmul_rn(p.sc2, sc[e]) - (e < 2 ? l0 : l1)) : 0.f;
        ds[e] = ok ? pv * (dp[e] - (e < 2 ? d0 : d1)) : 0.f;
      }
      Tf32A a;
      tf32_a_from_c(a, ds);
      f32_accumulate<DC, S>(acc, a, chunk_buf(lt), g, t4);  // dQ += dS K
    }
    __syncwarp();
  }
  f32_partial<DC, S>(slot, acc, g, t4);
  __syncthreads();
  f32_store<DC, S, W, L::kSlot>(base<float>(p, kDQ, b, h), p.st[kDQ][2], f32_smem, 0, r0,
                                p.N, chunk * DC, p.d, p.sc2);
}

template <int DC, bool WIDE>
__global__ void __launch_bounds__(F32Smem<DC, WIDE>::W * 32, f32_min_blocks<DC, WIDE>())
    flash_bwd_dkv_f32(BwdParams p) {
  using L = F32Smem<DC, WIDE>;
  constexpr int W = L::W, S = L::S;
  extern __shared__ __align__(16) float f32_smem[];
  const int ld = L::res_ld(p.d);
  float* resK = f32_smem + L::kPool;
  float* resV = resK + kF32Rows * ld;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int r0 = blockIdx.x * kF32Rows;
  const int chunk = blockIdx.z;  // dk's and dv's columns [chunk * DC, chunk * DC + DC)
  const int ns = WIDE ? (p.d + DC - 1) / DC : 1;
  const float* qp = base<const float>(p, kQ, b, h);
  const float* dop = base<const float>(p, kDO, b, h);
  const float* lse = base<const float>(p, kLse, b, h);
  const float* delta = base<const float>(p, kDelta, b, h);
  const long long qst = p.st[kQ][2], dost = p.st[kDO][2];

  load_resident<WIDE>(resK, ld, base<const float>(p, kK, b, h), p.st[kK][2], r0, p.M,
                      ns * DC, p.d, W * 32);
  load_resident<WIDE>(resV, ld, base<const float>(p, kV, b, h), p.st[kV][2], r0, p.M,
                      ns * DC, p.d, W * 32);
  cp_async_commit();

  float* slot = f32_smem + warp * L::kSlot;
  float* stats = slot + (L::kStages + (WIDE ? 2 : 0)) * L::kBuf;  // [stage][lse 8, D 8]
  const int tiles = (p.N + kF32Tile - 1) / kF32Tile;
  const int mine = warp < tiles ? (tiles - warp + W - 1) / W : 0;
  const int steps = mine * ns;
  auto chunk_buf = [&](int lt) { return slot + (lt % L::kStages) * L::kBuf; };
  auto buffer = [&](int i) {
    const int lt = i / ns, s = i - lt * ns;
    return s == chunk ? chunk_buf(lt) : slot + (L::kStages + (i & 1)) * L::kBuf;
  };
  auto prefetch = [&](int i) {
    if (i < steps) {
      const int lt = i / ns, s = i - lt * ns;
      const int q0 = (warp + lt * W) * kF32Tile;
      float* dst = buffer(i);
      load_rows(dst, S, qp, qst, q0, p.N, kF32Tile, s * DC, DC, p.d, lane, 32);
      load_rows(dst + L::kTileF, S, dop, dost, q0, p.N, kF32Tile, s * DC, DC, p.d, lane, 32);
      if (s == 0 && lane < 2 * kF32Tile) {  // lse and D of the tile's queries
        const int q = q0 + (lane & 7);
        const bool ok = q < p.N;
        const float* src = lane < kF32Tile ? lse + (ok ? q * p.st[kLse][2] : 0)
                                           : delta + (ok ? q * p.st[kDelta][2] : 0);
        cp_async4(stats + (lt % L::kStages) * L::kStat + lane, src, ok);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < L::kStages - 1; ++i) prefetch(i);
  cp_async_wait<L::kStages - 1>();
  __syncthreads();

  float acck[DC / 8][4], accv[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
    acck[j][0] = acck[j][1] = acck[j][2] = acck[j][3] = accv[j][0] = accv[j][1] = accv[j][2] =
        accv[j][3] = 0.f;
  float sc[4], dp[4];
  const int n0 = score_row(2 * t4), n1 = score_row(2 * t4 + 1);
  for (int i = 0; i < steps; ++i) {
    prefetch(i + L::kStages - 1);
    cp_async_wait<L::kStages - 1>();
    __syncwarp();
    const int lt = i / ns, s = i - lt * ns;
    const float* tile = buffer(i);
    if (s == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[e] = dp[e] = 0.f;
    }
    // S^T = K Q^T and dP^T = V dO^T over this slice
    f32_scores<DC, S, WIDE>(sc, dp, resK + s * DC, resV + s * DC, ld, tile, tile + L::kTileF,
                            g, t4);
    if (s == ns - 1) {
      // P^T and dS^T; column n is query q0 + pi(n), and queries past N give
      // P = dS = 0
      const int q0 = (warp + lt * W) * kF32Tile;
      const float* stat = stats + (lt % L::kStages) * L::kStat;
      const bool ok0 = q0 + n0 < p.N, ok1 = q0 + n1 < p.N;
      float pt[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = e & 1 ? ok1 : ok0;
        const int n = e & 1 ? n1 : n0;
        pt[e] = ok ? expf(__fmul_rn(p.sc2, sc[e]) - stat[n]) : 0.f;
        ds[e] = ok ? pt[e] * (dp[e] - stat[kF32Tile + n]) : 0.f;
      }
      const float* chunk_tile = chunk_buf(lt);  // Q and dO's chunk
      Tf32A a;
      tf32_a_from_c(a, pt);
      f32_accumulate<DC, S>(accv, a, chunk_tile + L::kTileF, g, t4);  // dV += P^T dO
      tf32_a_from_c(a, ds);
      f32_accumulate<DC, S>(acck, a, chunk_tile, g, t4);  // dK += dS^T Q
    }
    __syncwarp();
  }
  f32_partial<DC, S>(slot, acck, g, t4);
  f32_partial<DC, S>(slot + kF32Rows * S, accv, g, t4);
  __syncthreads();
  f32_store<DC, S, W, L::kSlot>(base<float>(p, kDK, b, h), p.st[kDK][2], f32_smem, 0, r0,
                                p.M, chunk * DC, p.d, p.sc2);
  f32_store<DC, S, W, L::kSlot>(base<float>(p, kDV, b, h), p.st[kDV][2], f32_smem,
                                kF32Rows * S, r0, p.M, chunk * DC, p.d, 1.f);
}

// The TMA maps of one bf16 kernel, in boxes of W columns: the resident
// operands (q, dO for dQ; k, v for dK/dV) by 64 rows, the looped ones (k, v;
// q, dO) by `lrows`.
int encode_maps(CUtensorMap* res, CUtensorMap* loop, int which, const BwdParams& p, int B,
                int W, int lrows) {
  const int res_ops[2] = {which == 0 ? kQ : kK, which == 0 ? kDO : kV};
  const int loop_ops[2] = {which == 0 ? kK : kQ, which == 0 ? kV : kDO};
  const int res_tokens = which == 0 ? p.N : p.M;
  const int loop_tokens = which == 0 ? p.M : p.N;
  int err;
  for (int i = 0; i < 2; ++i) {
    if ((err = encode(&res[i], p.ptr[res_ops[i]], p.st[res_ops[i]], p.d, B, p.H, res_tokens,
                      kTile, W)) != 0)
      return err;
    if ((err = encode(&loop[i], p.ptr[loop_ops[i]], p.st[loop_ops[i]], p.d, B, p.H,
                      loop_tokens, lrows, W)) != 0)
      return err;
  }
  return 0;
}

// which: 0 = dQ (and D), 1 = dK/dV
template <int D, bool PAD>
int launch_bf16(int which, const BwdParams& p, int B, cudaStream_t stream) {
  const int rows = which == 0 ? p.N : p.M;
  const dim3 grid((rows + kTile - 1) / kTile, B * p.H);
  CUtensorMap res[2], loop[2];
  int err;
  if ((err = encode_maps(res, loop, which, p, B, SwTile<D, kTile>::W, loop_rows(which))) != 0)
    return err;
  if (which == 0) {
    constexpr int smem = BwdSmem<D, loop_rows(0), ring_stages<D>(0)>::kBytes;
    static DeviceAttr attr;
    if ((err = set_smem(flash_bwd_dq_bf16<D, PAD>, smem, &attr)) != 0) return err;
    flash_bwd_dq_bf16<D, PAD><<<grid, kBf16Threads, smem, stream>>>(p, res[0], res[1],
                                                                     loop[0], loop[1]);
  } else {
    constexpr int smem = BwdSmem<D, loop_rows(1), ring_stages<D>(1)>::kBytes;
    static DeviceAttr attr;
    if ((err = set_smem(flash_bwd_dkv_bf16<D, PAD>, smem, &attr)) != 0) return err;
    flash_bwd_dkv_bf16<D, PAD><<<grid, kBf16Threads, smem, stream>>>(p, res[0], res[1],
                                                                      loop[0], loop[1]);
  }
  return (int)cudaGetLastError();
}

int launch_bf16_wide(int which, const BwdParams& p, int B, cudaStream_t stream) {
  const int rows = which == 0 ? p.N : p.M;
  const dim3 grid((rows + kTile - 1) / kTile, B * p.H, (p.d + 127) / 128);
  CUtensorMap res[2], loop[2];
  int err;
  if ((err = encode_maps(res, loop, which, p, B, 64, which == 0 ? kTile : kWideBQ)) != 0)
    return err;
  if (which == 0) {
    static DeviceAttr attr;
    if ((err = set_smem(flash_bwd_dq_bf16_wide, kWideSmem, &attr)) != 0) return err;
    flash_bwd_dq_bf16_wide<<<grid, kBf16Threads, kWideSmem, stream>>>(p, res[0], res[1],
                                                                     loop[0], loop[1]);
  } else {
    static DeviceAttr attr;
    if ((err = set_smem(flash_bwd_dkv_bf16_wide, kWideSmem, &attr)) != 0) return err;
    flash_bwd_dkv_bf16_wide<<<grid, kBf16Threads, kWideSmem, stream>>>(p, res[0], res[1],
                                                                      loop[0], loop[1]);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_narrow(int which, const BwdParams& p, int B, cudaStream_t stream) {
  return p.d == D ? launch_bf16<D, false>(which, p, B, stream)
                  : launch_bf16<D, true>(which, p, B, stream);
}

template <int DC, bool WIDE>
int launch_f32(int which, const BwdParams& p, int B, cudaStream_t stream) {
  using L = F32Smem<DC, WIDE>;
  const int rows = which == 0 ? p.N : p.M;
  const dim3 grid((rows + kF32Rows - 1) / kF32Rows, B * p.H, WIDE ? (p.d + DC - 1) / DC : 1);
  constexpr int kMaxBytes = L::bytes(WIDE ? 1024 : DC);
  int err;
  if (which == 0) {
    static DeviceAttr attr;
    if ((err = set_smem(flash_bwd_dq_f32<DC, WIDE>, kMaxBytes, &attr)) != 0) return err;
    flash_bwd_dq_f32<DC, WIDE><<<grid, L::W * 32, L::bytes(p.d), stream>>>(p);
  } else {
    static DeviceAttr attr;
    if ((err = set_smem(flash_bwd_dkv_f32<DC, WIDE>, kMaxBytes, &attr)) != 0) return err;
    flash_bwd_dkv_f32<DC, WIDE><<<grid, L::W * 32, L::bytes(p.d), stream>>>(p);
  }
  return (int)cudaGetLastError();
}

int dispatch(int which, int is_bf16, void* const* ptrs, int B, int H, int N,
             int M, int D, const long long* strides, float sc2, void* stream) {
  if (D < 8 || D > 1024 || D % 8) return (int)cudaErrorInvalidValue;
  BwdParams p;
  for (int i = 0; i < kOperands; ++i) {
    p.ptr[i] = ptrs[i];
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  }
  p.H = H;
  p.N = N;
  p.M = M;
  p.d = D;
  p.sc2 = sc2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D <= 16) return launch_narrow<16>(which, p, B, st);
    if (D <= 32) return launch_narrow<32>(which, p, B, st);
    if (D <= 64) return launch_narrow<64>(which, p, B, st);
    if (D <= 128) return launch_narrow<128>(which, p, B, st);
    return launch_bf16_wide(which, p, B, st);
  }
  if (D <= 16) return launch_f32<16, false>(which, p, B, st);
  if (D <= 32) return launch_f32<32, false>(which, p, B, st);
  if (D <= 64) return launch_f32<64, false>(which, p, B, st);
  if (D <= 128) return launch_f32<128, false>(which, p, B, st);
  return launch_f32<128, true>(which, p, B, st);
}

}  // namespace

// ptrs[10]: q, k, v, o, dO, dq, dk, dv ([B, H, N|M, D], unit-stride head dim)
// and lse, delta ([B, H, N] f32); strides[30]: (batch, head, token) element
// strides of each, in the same order. is_bf16: 1 for bfloat16, 0 for
// float32. sc2 is s^2, the square of the forward's scale taken in double
// and rounded to f32 once, as the TPU kernels' sc2 = scale * scale is. D a
// multiple of 8 up to 1,024; any other D returns cudaErrorInvalidValue
// without launching. bfloat16 reads q, k, v and dO through TMA: their addresses and
// strides are multiples of 16 bytes, and no stride along a dim longer than 1
// is 0 (else 10000 + CUDA_ERROR_INVALID_VALUE, without launching).
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
