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
// input dtype and lse = m + log(l) in f32 (natural log).
//
// Layouts: the caller passes element strides (batch, head, token) for q, o,
// k, v and lse; the head dim is unit-stride. The head layout [B, H, N, D] and
// the token layout [B, N, H*D] (viewed as [B, H, N, D] with head stride D and
// token stride H*D) are the same kernel, so the token layout needs no
// transposes.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s, 132 SMs): the larger of
// the tensor-core FLOPs, 4*BH*N*M*d, over the bf16 rate; reading q, k, v and
// writing o and lse once over HBM's; and the BH*N*M exponentials over the
// SFU's 16 a clock on each SM. At 1,024 tokens d = 32 (B = 64 rows, H = 8)
// that is 0.069 ms of FLOPs against 0.128 ms of exponentials at 1.98 GHz:
// the SFU sets the floor, and the tensor cores and the loads have to hide
// under it. The token shapes (256 and 64 tokens) are bytes-bound.
//
// bf16 design (one consumer warpgroup + one producer warp a block):
//   * the consumer warpgroup owns the block's 64 query rows, the M of every
//     wgmma (m64nNk16, bf16 in, f32 accumulate). S = (Q s)(K s)^T
//     (m64n64k16) reads both operands K-major from shared memory; the
//     exponentials leave the accumulators as bf16 A fragments in registers
//     (mf_flash::a_from_c), and O += P V (RS) reads the V tile MN-major
//     through the descriptor's transpose bit, with no transposed copy;
//   * the producer warp loads Q once and the K and V tiles of 64 keys into
//     a ring of two stages with TMA (4-D maps (d, token, head, batch)
//     built from the strides, so one map serves both layouts). TMA brings
//     raw q and k, and the scores' wgmma reads them from shared memory, so
//     the producer's lanes scale each arrived Q and K tile in place (each
//     product rounded to bf16, the function's rounding point) and fence
//     their writes to the async proxy before releasing the tile, so the
//     scaling runs on the producer's warp, not the consumers'. Each stage
//     has four mbarriers: K landed (TMA bytes), K scaled (the producer's 32
//     lanes), V landed (TMA bytes), stage free (the consumers' arrivals);
//   * softmax in base 2 on the SFU: p = ex2(S log2e - m log2e), one FFMA
//     and one ex2.approx an element, the row max and sum over the four lanes
//     of a row; keys past M are masked to -inf (TMA zero-fills them, and a
//     zero score is not -inf), queries past N are not stored;
//   * what sets the pace is instruction issue and latency, not the SFU: on
//     an H100 (PERF.md) dropping the exponentials saved 4 % at 1,024 tokens
//     d = 32, dropping the K scaling 15 %. Each warpgroup runs scores ->
//     softmax -> P V in series, hidden by the other blocks on the SM (five at
//     d = 32: 74 registers). That beat, on the sum of the path's shapes,
//     issuing tile j's scores beside tile j-1's P V, two consumer warpgroups
//     sharing each tile (with and without FlashAttention-3's ping-pong
//     through named barriers) and three stages; setmaxnreg would move few
//     registers from a one-warp producer, and the consumer needs no more.
//
// Head widths: every d that is a multiple of 8, up to 1,024. d <= 128 runs
// the kernel compiled for the next width of 16, 32, 64 and 128 (PAD = true
// where d is narrower: the widths 16-128 themselves keep the instantiation
// without the column checks): TMA zero-fills the tile's columns past d (a
// zero column changes no product and no rounding point) and only d columns
// of o are stored. d > 128 cannot
// keep a [64, d] f32 accumulator in registers, so flash_fwd_bf16_wide
// splits o's columns into 128-wide chunks over gridDim.z: each block keeps
// its 64 query rows' scaled Q resident (d / 64 tiles of 64 columns, 128 KB
// at d = 1,024), accumulates S = (Q s)(K s)^T over 64-column slices of K
// streamed through the ring, and multiplies P by its own 128-column chunk
// of V. Every chunk recomputes the scores (d / 128 times the score FLOPs);
// chunk 0 writes lse.
// f32 (classifier guidance and training, the f32 paths): every product on
// the tensor cores in split-TF32 (three tf32 mma.syncs, f32-accurate), 16
// query rows a block, the key loop split across the block's warps, each
// with its own cp.async ring and online softmax, merged in warp order; see
// "f32" below.
//
// The launch goes on the caller's stream; the kernel allocates nothing. The
// entry point returns cudaGetLastError() after the launch, or 10000 plus the
// CUresult where a tensor map cannot be encoded.

#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "hopper_sm90.cuh"

namespace {

using namespace mf_flash;
using namespace mf_sm90;

constexpr float kInitMax = -1e30f;  // the TPU kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, N, M, d;
  long long q_sb, q_sh, q_st;
  long long o_sb, o_sh, o_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long l_sb, l_sh, l_st;
  float scale;
};

// bf16 blocks: 64 query rows (one consumer warpgroup) plus the producer
// warp, 64-key tiles, a ring of two stages
constexpr int kRows = 64;
constexpr int kConsumers = 128;
constexpr int kBf16Threads = kConsumers + 32;
constexpr int kStages = 2;

// Shared memory of a bf16 block, from a 1,024-byte aligned base: the Q
// tile, the ring (a K and a V tile a stage), the mbarriers (Q landed, Q
// scaled, then K landed, K scaled, V landed and stage free for each stage).
template <int D>
struct FwdSmem {
  using Tile = SwTile<D, kRows>;
  static constexpr int kRing = Tile::BYTES;
  static constexpr int kStage = 2 * Tile::BYTES;
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr int kBytes = kBars + (2 + 4 * kStages) * 8 + 1024;  // + alignment
};

// Every bf16 value of the BYTES-byte tile at `tile` times s, each product
// rounded to bf16, by the 32 lanes of a warp (16 bytes a lane at a time;
// the swizzle moves whole 16-byte chunks, so it does not matter), then
// fenced for the wgmma reads that follow the lanes' barrier arrival.
template <int BYTES>
__device__ __forceinline__ void scale_tile(unsigned char* tile, float s, int lane) {
  static_assert(BYTES % 512 == 0, "whole rounds of 32 lanes x 16 bytes");
#pragma unroll 4
  for (int i = lane * 16; i < BYTES; i += 32 * 16) {
    uint4* v = reinterpret_cast<uint4*>(tile + i);
    *v = scale8(*v, s);
  }
  fence_proxy_async();
}

template <int D, bool PAD>
__global__ void __launch_bounds__(kBf16Threads, D == 128 ? 2 : 3)
    flash_fwd_bf16(Params p, const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv) {
  using L = FwdSmem<D>;
  using Tile = typename L::Tile;
  constexpr int W = Tile::W;
  constexpr int HALVES = D / W;
  unsigned char* smem = aligned_smem();
  const uint32_t s0 = smem_addr(smem);
  const uint32_t bars = s0 + L::kBars;
  const uint32_t q_landed = bars, q_scaled = bars + 8;
  // kind 0: K landed, 1: K scaled, 2: V landed, 3: stage free
  auto bar = [&](int kind, int st) { return bars + 16 + 8 * (kind * kStages + st); };
  auto k_tile = [&](int st) { return L::kRing + st * L::kStage; };  // offsets
  auto v_tile = [&](int st) { return k_tile(st) + Tile::BYTES; };

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kRows;
  const int tiles = (p.M + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    mbar_init(q_landed, 1);
    mbar_init(q_scaled, 32);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar(0, st), 1);
      mbar_init(bar(1, st), 32);
      mbar_init(bar(2, st), 1);
      mbar_init(bar(3, st), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const float s = __bfloat162float(__float2bfloat16(p.scale));

  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    const CUtensorMap* mk = &tk;
    const CUtensorMap* mv = &tv;
    auto issue = [&](int it) {  // K and V tile `it` into its stage
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(bar(3, st), ((it / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(bar(0, st), Tile::BYTES);
        mbar_arrive_expect_tx(bar(2, st), Tile::BYTES);
        for (int hf = 0; hf < HALVES; ++hf) {
          tma_load_4d(s0 + k_tile(st) + hf * Tile::HALF_BYTES, mk, hf * W, it * kRows, h, b,
                      bar(0, st));
          tma_load_4d(s0 + v_tile(st) + hf * Tile::HALF_BYTES, mv, hf * W, it * kRows, h, b,
                      bar(2, st));
        }
      }
    };
    if (lane == 0) {
      mbar_arrive_expect_tx(q_landed, Tile::BYTES);
      for (int hf = 0; hf < HALVES; ++hf) {
        tma_load_4d(s0 + hf * Tile::HALF_BYTES, &tq, hf * W, q0, h, b, q_landed);
      }
    }
    for (int it = 0; it < kStages - 1 && it < tiles; ++it) issue(it);
    mbar_wait(q_landed, 0);
    scale_tile<Tile::BYTES>(smem, s, lane);
    mbar_arrive(q_scaled);
    // scale tile it, then refill the stage that tile it - 1 frees
    for (int it = 0; it < tiles; ++it) {
      const int st = it % kStages;
      mbar_wait(bar(0, st), (it / kStages) & 1);
      scale_tile<Tile::BYTES>(smem + k_tile(st), s, lane);
      mbar_arrive(bar(1, st));
      if (it + kStages - 1 < tiles) issue(it + kStages - 1);
    }
  } else {  // the consumer warpgroup
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    float m_r[2] = {kInitMax, kInitMax};
    float l_r[2] = {0.f, 0.f};  // this lane's part of the row sums
    float acc[HALVES][W / 2];
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[hf][i] = 0.f;
    }
    mbar_wait(q_scaled, 0);

    for (int it = 0; it < tiles; ++it) {
      const int st = it % kStages;
      const uint32_t phase = (it / kStages) & 1;
      // S = (Q s)(K s)^T, both operands K-major in shared memory
      float sc[kRows / 2];
      mbar_wait(bar(1, st), phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<kRows>::ss(sc, Tile::k_major(s0, kk), Tile::k_major(s0 + k_tile(st), kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      // online softmax (rows g: elements 0, 1 of each 8-column chunk; g + 8:
      // elements 2, 3); keys past M are -inf
      const int k0 = it * kRows;
      if (k0 + kRows > p.M) {
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (k0 + j * 8 + t4 * 2 + (e & 1) >= p.M) sc[4 * j + e] = -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float ml[2], alpha[2];  // m_new * log2e; exp(m_old - m_new)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        ml[r] = m_new * kLog2e;
        alpha[r] = ex2(fmaf(m_r[r], kLog2e, -ml[r]));
        m_r[r] = m_new;
        l_r[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = ex2(fmaf(sc[4 * j + e], kLog2e, -ml[e >> 1]));
          sc[4 * j + e] = pv;
          l_r[e >> 1] += pv;
        }
      }
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) {
#pragma unroll
        for (int i = 0; i < W / 2; ++i) acc[hf][i] *= alpha[(i >> 1) & 1];
      }
      // O += P V: P rounded to bf16 as A fragments, the V tile MN-major
      uint32_t pa[kRows / 16][4];
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) a_from_c(pa[kk], &sc[8 * kk], &sc[8 * kk + 4]);
      mbar_wait(bar(2, st), phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf) {
          Wgmma<W>::rs(acc[hf], pa[kk], Tile::mn_major(s0 + v_tile(st), kk, hf));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      // keep the accumulator and the A registers in place until now
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) fence_regs(acc[hf]);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[kk][i])::"memory");
      }
      mbar_arrive(bar(3, st));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
    float* lse = p.lse + b * p.l_sb + h * p.l_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row >= p.N) continue;
      bf16* orow = o + row * p.o_st + t4 * 2;
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) {
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
          if (PAD && hf * W + j * 8 >= p.d) continue;  // columns past d are zero-fill
          *reinterpret_cast<__nv_bfloat162*>(orow + hf * W + j * 8) = __floats2bfloat162_rn(
              acc[hf][4 * j + 2 * r] / l_r[r], acc[hf][4 * j + 2 * r + 1] / l_r[r]);
        }
      }
      if (t4 == 0) lse[row * p.l_st] = m_r[r] + logf(l_r[r]);
    }
  }
}

// d > 128 (bf16): one block = 64 query rows x one 128-column chunk of o
// (blockIdx.z). Shared memory: the scaled Q, kSlices(d) tiles of [64 rows,
// 64 columns] (8 KB each); a ring of kWideStages stages of 16 KB, each
// holding one item of the stream: per key tile, the kSlices(d) 64-column
// slices of K (one 8 KB tile each, scaled in place by the producer), then
// the block's chunk of V ([64 keys, 128 columns], two halves; the second
// half is not loaded where it lies wholly past d, and the columns it would
// feed are not stored); then the mbarriers.
constexpr int kWideStages = 4;
constexpr int kHalf = 64 * 128;         // bytes of a [64, 64] bf16 tile
constexpr int kWideStage = 2 * kHalf;   // one ring stage
using Half = SwTile<64, kRows>;         // a [64, 64] tile, 128-byte rows
using Chunk = SwTile<128, kRows>;       // a [64, 128] tile: two halves

__host__ __device__ constexpr int kSlices(int d) { return (d + 63) / 64; }
inline int wide_smem(int d) {
  return kSlices(d) * kHalf + kWideStages * kWideStage + (2 + 3 * kWideStages) * 8 + 1024;
}
constexpr int kWideMaxSmem = 16 * kHalf + kWideStages * kWideStage + (2 + 3 * kWideStages) * 8 + 1024;

__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_fwd_bf16_wide(Params p, const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv) {
  const int nsl = kSlices(p.d);
  const int per_tile = nsl + 1;  // items of one key tile: the K slices, then V
  const int c0 = blockIdx.z * 128;  // this block's columns of o
  const bool hi = c0 + 64 < p.d;    // the chunk's second half holds columns
  unsigned char* smem = aligned_smem();
  const uint32_t s0 = smem_addr(smem);
  const uint32_t ring = s0 + nsl * kHalf;
  const uint32_t bars = ring + kWideStages * kWideStage;
  const uint32_t q_landed = bars, q_scaled = bars + 8;
  // kind 0: landed (TMA bytes), 1: scaled (the producer's 32 lanes), 2: free
  auto bar = [&](int kind, int st) { return bars + 16 + 8 * (kind * kWideStages + st); };
  auto stage = [&](int st) { return ring + st * kWideStage; };

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kRows;
  const int tiles = (p.M + kRows - 1) / kRows;
  const int items = tiles * per_tile;
  if (threadIdx.x == 0) {
    mbar_init(q_landed, 1);
    mbar_init(q_scaled, 32);
    for (int st = 0; st < kWideStages; ++st) {
      mbar_init(bar(0, st), 1);
      mbar_init(bar(1, st), 32);
      mbar_init(bar(2, st), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const float s = __bfloat162float(__float2bfloat16(p.scale));

  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    auto issue = [&](int i) {  // item i into its stage
      const int st = i % kWideStages;
      if (i >= kWideStages) mbar_wait(bar(2, st), ((i / kWideStages) & 1) ^ 1);
      if (lane == 0) {
        const int it = i / per_tile, j = i % per_tile;
        if (j < nsl) {
          mbar_arrive_expect_tx(bar(0, st), kHalf);
          tma_load_4d(stage(st), &tk, j * 64, it * kRows, h, b, bar(0, st));
        } else {
          mbar_arrive_expect_tx(bar(0, st), hi ? 2 * kHalf : kHalf);
          tma_load_4d(stage(st), &tv, c0, it * kRows, h, b, bar(0, st));
          if (hi) tma_load_4d(stage(st) + kHalf, &tv, c0 + 64, it * kRows, h, b, bar(0, st));
        }
      }
    };
    if (lane == 0) {
      mbar_arrive_expect_tx(q_landed, nsl * kHalf);
      for (int j = 0; j < nsl; ++j) tma_load_4d(s0 + j * kHalf, &tq, j * 64, q0, h, b, q_landed);
    }
    for (int i = 0; i < kWideStages - 1 && i < items; ++i) issue(i);
    mbar_wait(q_landed, 0);
    for (int j = 0; j < nsl; ++j) scale_tile<kHalf>(smem + j * kHalf, s, lane);
    mbar_arrive(q_scaled);
    // scale item i where it is a K slice, then refill the stage item i - 1
    // frees; "scaled" completes for a V item too (with nothing to wait
    // for), so that each stage's barriers complete once per item
    for (int i = 0; i < items; ++i) {
      const int st = i % kWideStages;
      if (i % per_tile < nsl) {
        mbar_wait(bar(0, st), (i / kWideStages) & 1);
        scale_tile<kHalf>(smem + (stage(st) - s0), s, lane);
      }
      mbar_arrive(bar(1, st));
      if (i + kWideStages - 1 < items) issue(i + kWideStages - 1);
    }
  } else {  // the consumer warpgroup
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    float m_r[2] = {kInitMax, kInitMax};
    float l_r[2] = {0.f, 0.f};
    float acc[2][32];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hf][i] = 0.f;
    }
    mbar_wait(q_scaled, 0);

    for (int it = 0; it < tiles; ++it) {
      // S = sum over the slices of (Q_j s)(K_j s)^T; slice j's stage is
      // freed once slice j + 1's products are issued and j's have completed
      float sc[kRows / 2];
      for (int j = 0; j < nsl; ++j) {
        const int i = it * per_tile + j;
        const int st = i % kWideStages;
        mbar_wait(bar(1, st), (i / kWideStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          Wgmma<kRows>::ss(sc, Half::k_major(s0 + j * kHalf, kk), Half::k_major(stage(st), kk),
                           j > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (j > 0) mbar_arrive(bar(2, (i - 1) % kWideStages));
      }
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(bar(2, (it * per_tile + nsl - 1) % kWideStages));
      const int k0 = it * kRows;
      if (k0 + kRows > p.M) {
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (k0 + j * 8 + t4 * 2 + (e & 1) >= p.M) sc[4 * j + e] = -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float ml[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        ml[r] = m_new * kLog2e;
        alpha[r] = ex2(fmaf(m_r[r], kLog2e, -ml[r]));
        m_r[r] = m_new;
        l_r[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = ex2(fmaf(sc[4 * j + e], kLog2e, -ml[e >> 1]));
          sc[4 * j + e] = pv;
          l_r[e >> 1] += pv;
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[hf][i] *= alpha[(i >> 1) & 1];
      }
      // O[:, chunk] += P V[:, chunk]
      uint32_t pa[kRows / 16][4];
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) a_from_c(pa[kk], &sc[8 * kk], &sc[8 * kk + 4]);
      const int i = it * per_tile + nsl;
      const int st = i % kWideStages;
      mbar_wait(bar(0, st), (i / kWideStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        Wgmma<64>::rs(acc[0], pa[kk], Chunk::mn_major(stage(st), kk, 0));
        if (hi) Wgmma<64>::rs(acc[1], pa[kk], Chunk::mn_major(stage(st), kk, 1));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
      }
      mbar_arrive(bar(2, st));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
    float* lse = p.lse + b * p.l_sb + h * p.l_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row >= p.N) continue;
      bf16* orow = o + row * p.o_st + c0 + t4 * 2;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (c0 + hf * 64 + j * 8 >= p.d) continue;
          *reinterpret_cast<__nv_bfloat162*>(orow + hf * 64 + j * 8) = __floats2bfloat162_rn(
              acc[hf][4 * j + 2 * r] / l_r[r], acc[hf][4 * j + 2 * r + 1] / l_r[r]);
        }
      }
      if (t4 == 0 && blockIdx.z == 0) lse[row * p.l_st] = m_r[r] + logf(l_r[r]);
    }
  }
}

// ---- f32: split-TF32 products on the tensor cores ----
// The layout and helpers are the f32 backward's (flash_attention_common.cuh).
// A block owns 16 query rows, one m16 tile: their q * s (one f32 multiply,
// then split into tf32 big and small parts, d <= 128) stays in shared
// memory for every warp. Its W warps split the key loop into tiles of 8
// keys: warp w takes tiles w, w + W, ..., each K and V tile through the
// warp's own cp.async ring (zero-filled past M and d; 3 stages at d <= 32,
// 4 at 64, 2 at 128). For each tile: the 16 x 8 scores in k8 steps of mma_split3
// with k * s formed in f32 before its split, a fresh accumulator every 16
// columns added in f32; keys past M masked to -inf; the running max and sum
// of each row kept by the warp (the max over a row's 4 lanes by shuffles,
// the sum in each lane's share, reduced at the end); acc rescaled by
// alpha = e^(m_old - m_new) as the tile's p v, on a fresh accumulator, is
// added (f32_accumulate with alphas), p reaching the A fragment through
// tf32_a_from_c. At the end each warp leaves (m_w, l_w, acc_w) in its slot
// and the block merges them in warp order, m = max m_w, l = sum l_w
// e^(m_w - m), o = (sum acc_w e^(m_w - m)) / l, lse = m + log(l): no
// atomics, the same bits on every run; a warp that got no tile (M < 8 W)
// adds nothing. d > 128 (WIDE): o's columns in 128-wide chunks over
// gridDim.z, q's whole d resident unsplit (scaled where it is read), K
// streamed in 128-column slices and V's chunk into a buffer kept for p v;
// every chunk recomputes the scores, chunk 0 writes lse.
// Occupancy on an H100 at the classifier's shapes, B = 8: d = 128, N = 256,
// one head: 16 x 8 = 128 blocks of 8 warps, one an SM, each warp 4 key
// tiles; d = 32, 4 heads: 16 or 17 x 32 blocks of 4 warps, five an SM.
// Bound: 4 BH N M d FLOPs at the split-TF32 rate (495 / 3 TFLOP/s) against
// reading q, k, v and writing o and lse once (at these shapes the FLOPs).
// What sets the pace instead (PERF.md): the block's fixed costs (the launch,
// the resident rows, the merge; a third of the time at d = 128) and each
// warp's serial tiles, two warps a scheduler at d = 128. Dropping the two
// small-term mma.syncs saved 15-22 %, fast exponentials 0-4 %; deeper
// rings, 4 or 8 warps at other widths, and issuing the next tile's scores
// beside this tile's p v did not help.

// Shared memory of an f32 block, in floats: W slots, each a warp's ring
// and then its partial (acc [16][S], m and l of the 16 rows); the resident
// [16][res_ld] q * s; the merge's weights e^(m_w - m) [W][16] and l [16].
template <int DC, bool WIDE>
struct FwdF32Smem {
  // warps a block: 8 at DC 64 and 128 (one block an SM), 4 at DC <= 32
  // (five blocks an SM) and for WIDE (whose resident q takes 66 KB at d =
  // 1,024)
  static constexpr int W = !WIDE && DC > 32 ? 8 : 4;
  static constexpr int S = DC + 8;  // a tile's row stride, 8 mod 16: no bank conflicts
  static constexpr int kTileF = kF32Tile * S;  // one [8][S] tile
  static constexpr int kBuf = 2 * kTileF;  // a K and a V tile
  // a warp's ring: kStages buffers by key tile (3 at DC <= 32, where five
  // blocks share an SM's shared memory), WIDE also two K slices by step
  // parity
  static constexpr int kStages = WIDE ? 2 : DC <= 32 ? 3 : DC <= 64 ? 4 : 2;
  static constexpr int kRing = kStages * kBuf + (WIDE ? 2 * kTileF : 0);
  static constexpr int kPartial = kF32Rows * S + 2 * kF32Rows;
  static constexpr int kSlot = kRing > kPartial ? kRing : kPartial;
  static constexpr int kPool = W * kSlot;
  // the resident rows' stride: raw (WIDE), or split in pairs
  __host__ __device__ static constexpr int res_ld(int d) {
    return (WIDE ? 1 : 2) * (round_up(d, DC) + 8);
  }
  __host__ __device__ static constexpr int bytes(int d) {
    return 4 * (kPool + kF32Rows * res_ld(d) + (W + 1) * kF32Rows);
  }
};

// Blocks an SM the kernel is compiled for: five blocks of 4 warps (96
// registers a thread) at DC <= 32, so that the 544 blocks of the 257-token
// classifier shape (B = 8, 4 heads) run in one wave on 132 SMs; one block
// at the wider DC, whose accumulators need the registers.
template <int DC, bool WIDE>
__global__ void __launch_bounds__(FwdF32Smem<DC, WIDE>::W * 32, DC <= 32 ? 5 : 1)
    flash_fwd_f32(Params p) {
  using L = FwdF32Smem<DC, WIDE>;
  constexpr int W = L::W, S = L::S;
  constexpr int kSteps = DC / 8 < 2 ? DC / 8 : 2;  // k8 steps a fresh score accumulator
  extern __shared__ __align__(16) float f32_smem[];
  const int ld = L::res_ld(p.d);
  float* resQ = f32_smem + L::kPool;
  float* wts = resQ + kF32Rows * ld;
  float* rowL = wts + W * kF32Rows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int r0 = blockIdx.x * kF32Rows;
  const int chunk = blockIdx.z;  // o's columns [chunk * DC, chunk * DC + DC)
  const int ns = WIDE ? (p.d + DC - 1) / DC : 1;  // slices of the head dim
  const float s = p.scale;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_resident<WIDE>(resQ, ld, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh,
                      p.q_st, r0, p.N, ns * DC, p.d, W * 32, s);
  cp_async_commit();

  float* slot = f32_smem + warp * L::kSlot;
  const int tiles = (p.M + kF32Tile - 1) / kF32Tile;
  const int mine = warp < tiles ? (tiles - warp + W - 1) / W : 0;
  const int steps = mine * ns;
  // step i: the warp's tile i / ns, K's slice i % ns; the chunk's own slice
  // and V's chunk go to the tile's buffer, K's other slices (WIDE) through
  // the slice ring
  auto chunk_buf = [&](int lt) { return slot + (lt % L::kStages) * L::kBuf; };
  auto buffer = [&](int i) {
    const int lt = i / ns, sl = i - lt * ns;
    return sl == chunk ? chunk_buf(lt) : slot + L::kStages * L::kBuf + (i & 1) * L::kTileF;
  };
  auto prefetch = [&](int i) {
    if (i < steps) {
      const int lt = i / ns, sl = i - lt * ns;
      const int k0 = (warp + lt * W) * kF32Tile;
      load_rows(buffer(i), S, kp, p.k_st, k0, p.M, kF32Tile, sl * DC, DC, p.d, lane, 32);
      if (sl == chunk)
        load_rows(chunk_buf(lt) + L::kTileF, S, vp, p.v_st, k0, p.M, kF32Tile, chunk * DC, DC,
                  p.d, lane, 32);
    }
    cp_async_commit();
  };
  for (int i = 0; i < L::kStages - 1; ++i) prefetch(i);
  cp_async_wait<L::kStages - 1>();
  __syncthreads();

  float acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // rows g and g + 8: the running max, and this lane's share of the sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float sc[4];
  const int n0 = score_row(2 * t4), n1 = score_row(2 * t4 + 1);
  const int trow = score_row(g) * S;
  for (int i = 0; i < steps; ++i) {
    prefetch(i + L::kStages - 1);
    cp_async_wait<L::kStages - 1>();
    __syncwarp();
    const int lt = i / ns, sl = i - lt * ns;
    const float* tile = buffer(i);
    if (sl == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[e] = 0.f;
    }
#pragma unroll
    for (int k0 = 0; k0 < DC / 8; k0 += kSteps) {
      float ps[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = k0; kk < k0 + kSteps; ++kk)
        tf32_score_step<WIDE>(ps, resQ + sl * DC, ld, tile + trow, g, kk * 8 + 2 * t4, s);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[e] += ps[e];
    }
    if (sl == ns - 1) {
      // column n is key k0 + pi(n); keys past M are -inf (the tile holds at
      // least one key below M, so each row's max is finite)
      const int k0 = (warp + lt * W) * kF32Tile;
      const bool ok0 = k0 + n0 < p.M, ok1 = k0 + n1 < p.M;
      if (!ok0) sc[0] = sc[2] = -INFINITY;
      if (!ok1) sc[1] = sc[3] = -INFINITY;
      float mx0 = fmaxf(sc[0], sc[1]), mx1 = fmaxf(sc[2], sc[3]);
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);  // 0 on the first tile
      m0 = mn0;
      m1 = mn1;
      float pr[4] = {expf(sc[0] - m0), expf(sc[1] - m0), expf(sc[2] - m1), expf(sc[3] - m1)};
      l0 = fmaf(l0, a0, pr[0] + pr[1]);
      l1 = fmaf(l1, a1, pr[2] + pr[3]);
      Tf32A a;
      tf32_a_from_c(a, pr);
      f32_accumulate<DC, S>(acc, a, chunk_buf(lt) + L::kTileF, g, t4, a0, a1);  // acc += p V
    }
    __syncwarp();
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  f32_partial<DC, S>(slot, acc, g, t4);
  float* stat = slot + kF32Rows * S;  // m [16], then l [16]
  if (t4 == 0) {
    stat[g] = m0;
    stat[g + 8] = m1;
    stat[kF32Rows + g] = l0;
    stat[kF32Rows + g + 8] = l1;
  }
  __syncthreads();

  // the merge, over the warps that got a tile, in warp order
  const int nw = tiles < W ? tiles : W;
  if (threadIdx.x < kF32Rows) {
    const int r = threadIdx.x;
    const float* st0 = f32_smem + kF32Rows * S;
    float m = st0[r];
    for (int w = 1; w < nw; ++w) m = fmaxf(m, st0[w * L::kSlot + r]);
    float l = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float e = expf(st0[w * L::kSlot + r] - m);
      wts[w * kF32Rows + r] = e;
      l = fmaf(st0[w * L::kSlot + kF32Rows + r], e, l);
    }
    rowL[r] = l;
    if (chunk == 0 && r0 + r < p.N)
      p.lse[b * p.l_sb + h * p.l_sh + (r0 + r) * p.l_st] = m + logf(l);
  }
  __syncthreads();
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  constexpr int kChunks = DC / 4;
  for (int i = threadIdx.x; i < kF32Rows * kChunks; i += W * 32) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    if (r0 + r >= p.N || chunk * DC + c >= p.d) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < nw; ++w) {
      const float e = wts[w * kF32Rows + r];
      const float4 v = *reinterpret_cast<const float4*>(f32_smem + w * L::kSlot + r * S + c);
      sum.x = fmaf(v.x, e, sum.x);
      sum.y = fmaf(v.y, e, sum.y);
      sum.z = fmaf(v.z, e, sum.z);
      sum.w = fmaf(v.w, e, sum.w);
    }
    const float l = rowL[r];
    *reinterpret_cast<float4*>(o + (r0 + r) * p.o_st + chunk * DC + c) =
        make_float4(sum.x / l, sum.y / l, sum.z / l, sum.w / l);
  }
}

struct Maps {
  CUtensorMap q, k, v;
};

// The q, k and v maps in boxes of W columns by 64 rows.
int encode_qkv(Maps* t, const Params& p, int B, int W) {
  const long long qs[3] = {p.q_sb, p.q_sh, p.q_st};
  const long long ks[3] = {p.k_sb, p.k_sh, p.k_st};
  const long long vs[3] = {p.v_sb, p.v_sh, p.v_st};
  int err;
  if ((err = encode(&t->q, const_cast<void*>(p.q), qs, p.d, B, p.H, p.N, kRows, W)) != 0)
    return err;
  if ((err = encode(&t->k, const_cast<void*>(p.k), ks, p.d, B, p.H, p.M, kRows, W)) != 0)
    return err;
  return encode(&t->v, const_cast<void*>(p.v), vs, p.d, B, p.H, p.M, kRows, W);
}

template <int D, bool PAD>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = FwdSmem<D>::kBytes;
  Maps t;
  int err;
  if ((err = encode_qkv(&t, p, B, SwTile<D, kRows>::W)) != 0) return err;
  static DeviceAttr attr_set;
  if ((err = set_smem(flash_fwd_bf16<D, PAD>, smem, &attr_set)) != 0) return err;
  const dim3 grid((p.N + kRows - 1) / kRows, B * p.H);
  flash_fwd_bf16<D, PAD><<<grid, kBf16Threads, smem, stream>>>(p, t.q, t.k, t.v);
  return (int)cudaGetLastError();
}

template <int D>
int launch_narrow(const Params& p, int B, cudaStream_t stream) {
  return p.d == D ? launch_bf16<D, false>(p, B, stream) : launch_bf16<D, true>(p, B, stream);
}

int launch_bf16_wide(const Params& p, int B, cudaStream_t stream) {
  Maps t;
  int err;
  if ((err = encode_qkv(&t, p, B, 64)) != 0) return err;
  static DeviceAttr attr_set;
  if ((err = set_smem(flash_fwd_bf16_wide, kWideMaxSmem, &attr_set)) != 0) return err;
  const dim3 grid((p.N + kRows - 1) / kRows, B * p.H, (p.d + 127) / 128);
  flash_fwd_bf16_wide<<<grid, kBf16Threads, wide_smem(p.d), stream>>>(p, t.q, t.k, t.v);
  return (int)cudaGetLastError();
}

template <int DC, bool WIDE>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  using L = FwdF32Smem<DC, WIDE>;
  const dim3 grid((p.N + kF32Rows - 1) / kF32Rows, B * p.H, WIDE ? (p.d + DC - 1) / DC : 1);
  static DeviceAttr attr_set;
  int err;
  if ((err = set_smem(flash_fwd_f32<DC, WIDE>, L::bytes(WIDE ? 1024 : DC), &attr_set)) != 0)
    return err;
  flash_fwd_f32<DC, WIDE><<<grid, L::W * 32, L::bytes(p.d), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, H, N|M, D] addressed by strides[0..11] (q, o, k, v: batch,
// head, token; the head dim is unit-stride); lse: [B, H, N] f32 by
// strides[12..14]. is_bf16: 1 for bfloat16, 0 for float32. D a multiple of
// 8 up to 1,024; any other D returns cudaErrorInvalidValue without
// launching. bfloat16 reads q, k and v through TMA: their addresses and
// strides are multiples of 16 bytes, and no stride along a dim longer than 1
// is 0 (else 10000 + CUDA_ERROR_INVALID_VALUE, without launching).
extern "C" int mf_flash_attention_fwd(int is_bf16, const void* q, const void* k,
                                      const void* v, void* o, void* lse, int B,
                                      int H, int N, int M, int D,
                                      const long long* strides, float scale,
                                      void* stream) {
  if (D < 8 || D > 1024 || D % 8) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.N = N;
  p.M = M;
  p.d = D;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
  p.o_sb = strides[3]; p.o_sh = strides[4]; p.o_st = strides[5];
  p.k_sb = strides[6]; p.k_sh = strides[7]; p.k_st = strides[8];
  p.v_sb = strides[9]; p.v_sh = strides[10]; p.v_st = strides[11];
  p.l_sb = strides[12]; p.l_sh = strides[13]; p.l_st = strides[14];
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D <= 16) return launch_narrow<16>(p, B, st);
    if (D <= 32) return launch_narrow<32>(p, B, st);
    if (D <= 64) return launch_narrow<64>(p, B, st);
    if (D <= 128) return launch_narrow<128>(p, B, st);
    return launch_bf16_wide(p, B, st);
  }
  if (D <= 16) return launch_f32<16, false>(p, B, st);
  if (D <= 32) return launch_f32<32, false>(p, B, st);
  if (D <= 64) return launch_f32<64, false>(p, B, st);
  if (D <= 128) return launch_f32<128, false>(p, B, st);
  return launch_f32<128, true>(p, B, st);
}
