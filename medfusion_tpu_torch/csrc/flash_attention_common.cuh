// Fragment helpers shared by the flash-attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) kernels: bf16
// packing, the A fragment of a product from the C fragments of another, the
// rounding of a scaled bf16 chunk, and the split-TF32 products, cp.async
// loads and tile layout of the f32 routes.
//
// mma.sync m16n8k16 fragments (a wgmma accumulator holds, for each warp's 16
// rows, the same C fragments; hopper_sm90.cuh), for lane = 4 * g + t4:
//   A (16x16, row-major): a0 = (row g, cols 2t4, 2t4+1), a1 = row g + 8,
//     a2 = (row g, cols 2t4 + 8, +9), a3 = row g + 8 of those;
//   C (16x8): c0, c1 = (row g, cols 2t4, 2t4+1), c2, c3 = row g + 8.
// So the C fragments of two neighbouring 8-column chunks are, packed to
// bf16, the A fragment of one 16-wide k-step: a product's result feeds the
// next product without a round trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace mf_flash {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of one 16-wide k-step from the C fragments of n-tiles
// 2kk and 2kk + 1, rounded to bf16.
__device__ __forceinline__ void a_from_c(uint32_t* a, const float* c0,
                                         const float* c1) {
  a[0] = pack_f(c0[0], c0[1]);
  a[1] = pack_f(c0[2], c0[3]);
  a[2] = pack_f(c1[0], c1[1]);
  a[3] = pack_f(c1[2], c1[3]);
}

// Eight bf16 values times s, each product rounded to bf16.
__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    h[j] = __floats2bfloat162_rn(f.x * s, f.y * s);
  }
  return v;
}


// ---- split-TF32: f32-accurate products on the tf32 tensor cores ----
//
// An f32 x is split into big = tf32(x) (cvt.rna: round to nearest, ties
// away) and small = x - big (exact in f32; the tensor core reads its top 19
// bits). A product of two f32 operands is then
//   small * big' + big * small' + big * big'
// in three tf32 mma.syncs on one f32 accumulator, the small terms first, and
// small * small' (under 2^-22 of the product) is dropped: about 22 bits of
// each product, against single-pass TF32's 11, at a third of the TF32 rate.
// It is the scheme of CUTLASS's OpMultiplyAddFastF32 (the f32 GEMMs of
// PyTorch's memory-efficient attention). Inputs and sums stay f32.
//
// mma.sync.m16n8k8 .tf32 fragments, for lane = 4 * g + t4:
//   A (16x8, row-major): a0 = (row g, col t4), a1 = (row g + 8, col t4),
//     a2 = (row g, col t4 + 4), a3 = (row g + 8, col t4 + 4);
//   B (8x8, B[k][n], "col"): b0 = (k t4, n g), b1 = (k t4 + 4, n g);
//   C (16x8): c0, c1 = (row g, cols 2 t4, 2 t4 + 1), c2, c3 = row g + 8.
// A k-step's 8 indices are summed, so A and B may take them in any order
// both agree on. The f32 kernels take k index t4 as element 2 t4 and t4 + 4
// as 2 t4 + 1 of each 8: a0 and a2 (a1 and a3) are then one 8-byte load of
// a row-major A, b0 and b1 one of a row of a [n][k] tile, and the C
// fragment of a 16x8 product, its 8 columns summed next, is the A fragment
// (c0, c2, c1, c3) with no shuffle (tf32_a_from_c).

struct Tf32A {  // a split A fragment
  uint32_t big[4], small[4];
};

__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  small = __float_as_uint(x - __uint_as_float(big));
}

// a[i] from x[i], in the fragment's order
__device__ __forceinline__ void tf32_split_a(Tf32A& a, float x0, float x1, float x2, float x3) {
  tf32_split(x0, a.big[0], a.small[0]);
  tf32_split(x1, a.big[1], a.small[1]);
  tf32_split(x2, a.big[2], a.small[2]);
  tf32_split(x3, a.big[3], a.small[3]);
}

// The A fragment of rows (g, g + 8) and elements (c, c + 1) of a row-major
// f32 matrix in shared memory with row stride `ld` (floats): k index t4 is
// element c = 2 t4 of the k-step's 8, t4 + 4 is c + 1.
// Each value is first multiplied by s in f32 (the forward's q * s; 1 for
// the backward), so the split is of the scaled value.
__device__ __forceinline__ void tf32_load_a(Tf32A& a, const float* m, int ld, int g, int c,
                                            float s) {
  const float2 r0 = *reinterpret_cast<const float2*>(m + g * ld + c);
  const float2 r1 = *reinterpret_cast<const float2*>(m + (g + 8) * ld + c);
  tf32_split_a(a, r0.x * s, r1.x * s, r0.y * s, r1.y * s);
}

// A row-major matrix kept split in shared memory: each pair of elements
// (c, c + 1) of a row as 16 bytes {big(c), big(c + 1), small(c), small(c + 1)}
// (row stride ld floats, twice the width plus padding). tf32_load_a_split
// reads tf32_load_a's fragment from it with no conversion.
__device__ __forceinline__ uint4 tf32_split_pair(float x0, float x1) {
  uint4 r;
  tf32_split(x0, r.x, r.z);
  tf32_split(x1, r.y, r.w);
  return r;
}

__device__ __forceinline__ void tf32_load_a_split(Tf32A& a, const float* m, int ld, int g,
                                                  int c) {
  const uint4 r0 = *reinterpret_cast<const uint4*>(m + g * ld + 2 * c);
  const uint4 r1 = *reinterpret_cast<const uint4*>(m + (g + 8) * ld + 2 * c);
  a.big[0] = r0.x;
  a.big[1] = r1.x;
  a.big[2] = r0.y;
  a.big[3] = r1.y;
  a.small[0] = r0.z;
  a.small[1] = r1.z;
  a.small[2] = r0.w;
  a.small[3] = r1.w;
}

// The A fragment of a k-step from the C fragment of a 16x8 product whose
// column 2 t4 (2 t4 + 1) is the k-step's index t4 (t4 + 4).
__device__ __forceinline__ void tf32_a_from_c(Tf32A& a, const float* c) {
  tf32_split_a(a, c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B in three terms, small first; b0, b1 the f32 B fragment.
__device__ __forceinline__ void mma_split3(float* c, const Tf32A& a, float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  tf32_split(b0, bb0, bs0);
  tf32_split(b1, bb1, bs1);
  mma_tf32(c, a.small, bb0, bb1);
  mma_tf32(c, a.big, bs0, bs1);
  mma_tf32(c, a.big, bb0, bb1);
}


// ---- the f32 kernels' tiles: 16 resident rows, looped tiles of 8 rows ----
//
// A block owns 16 output rows, one m16 tile, resident in shared memory; its
// warps each loop over tiles of 8 rows of the other side (one n8 tile of
// the scores, one k8 step of the accumulating products) through their own
// cp.async ring. A score tile's n-th column is the looped tile's row
// pi(n) = n ^ (n >> 2) (score_row), so that the score loads ([8][DC + 8]
// tile, lane g on row pi(g), 8-byte loads) and the accumulating products'
// loads (rows pi(2 t4) and pi(2 t4 + 1), column g) both hit 32 distinct
// banks.

constexpr int kF32Rows = 16;  // a block's output rows: one m16 tile
constexpr int kF32Tile = 8;   // a looped tile's rows: one n8 tile, one k8 step

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ int score_row(int n) { return n ^ (n >> 2); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(mf_sm90::smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(mf_sm90::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + rows) and columns [c0, c0 + cols) of a strided f32
// operand into a [rows][ld] tile, by threads tid of n; zeros past row
// `limit` and column d.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, long long st,
                                          int r0, int limit, int rows, int c0, int cols, int d,
                                          int tid, int n) {
  const int chunks = cols / 4;
#pragma unroll 4
  for (int i = tid; i < rows * chunks; i += n) {
    const int r = i / chunks, c = (i - r * chunks) * 4;
    const bool ok = r0 + r < limit && c0 + c < d;
    cp_async16(dst + r * ld + c, ok ? src + (r0 + r) * st + c0 + c : src, ok);
  }
}

// The block's 16 resident rows of one operand, zero past row `limit` and
// column d: WIDE, as they are (cp.async, columns [0, cols); a caller that
// scales them does so where it reads them); else each value times s, split
// in pairs (tf32_split_pair), converted once for every looped tile.
template <bool WIDE>
__device__ __forceinline__ void load_resident(float* dst, int ld, const float* src,
                                              long long st, int r0, int limit, int cols,
                                              int d, int n, float s = 1.f) {
  if (WIDE) {
    load_rows(dst, ld, src, st, r0, limit, kF32Rows, 0, cols, d, threadIdx.x, n);
    return;
  }
  const int chunks = cols / 4;
  for (int i = threadIdx.x; i < kF32Rows * chunks; i += n) {
    const int r = i / chunks, c = (i - r * chunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit && c < d) x = *reinterpret_cast<const float4*>(src + (r0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * ld + 2 * c) = tf32_split_pair(x.x * s, x.y * s);
    *reinterpret_cast<uint4*>(dst + r * ld + 2 * c + 4) = tf32_split_pair(x.z * s, x.w * s);
  }
}

// One k8 step of a 16x8 score tile: ps += (rows g, g + 8 of the resident
// tile x, columns c, c + 1) (row `trow` of a looped tile, the same
// columns), both operands times s in f32 before their split (WIDE: x
// raw; else x already scaled and split).
template <bool WIDE>
__device__ __forceinline__ void tf32_score_step(float* ps, const float* x, int ld,
                                                const float* trow, int g, int c, float s) {
  Tf32A a;
  if (WIDE) {
    tf32_load_a(a, x, ld, g, c, s);
  } else {
    tf32_load_a_split(a, x, ld, g, c);
  }
  const float2 b = *reinterpret_cast<const float2*>(trow + c);
  mma_split3(ps, a, b.x * s, b.y * s);
}

// acc[j] += A m[:, 8j : 8j + 8] over one k8 step: rows pi(2 t4) and
// pi(2 t4 + 1) of the looped tile m (row stride S), column g of each
// n-tile.
template <int DC, int S>
__device__ __forceinline__ void f32_accumulate(float (&acc)[DC / 8][4], const Tf32A& a,
                                               const float* m, int g, int t4) {
  const float* r0 = m + score_row(2 * t4) * S + g;
  const float* r1 = m + score_row(2 * t4 + 1) * S + g;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) mma_split3(acc[j], a, r0[8 * j], r1[8 * j]);
}

// acc[j] = alpha acc[j] + A m[:, 8j : 8j + 8], alpha0 for rows g and
// alpha1 for rows g + 8 (an online softmax's rescaling): the step's product
// on a fresh accumulator, added in f32 (fmaf, rounded to nearest), so no
// accumulator takes a chain of more than three mma.syncs, whose f32 sums
// the tensor cores round toward zero.
template <int DC, int S>
__device__ __forceinline__ void f32_accumulate(float (&acc)[DC / 8][4], const Tf32A& a,
                                               const float* m, int g, int t4, float alpha0,
                                               float alpha1) {
  const float* r0 = m + score_row(2 * t4) * S + g;
  const float* r1 = m + score_row(2 * t4 + 1) * S + g;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma_split3(t, a, r0[8 * j], r1[8 * j]);
    acc[j][0] = fmaf(acc[j][0], alpha0, t[0]);
    acc[j][1] = fmaf(acc[j][1], alpha0, t[1]);
    acc[j][2] = fmaf(acc[j][2], alpha1, t[2]);
    acc[j][3] = fmaf(acc[j][3], alpha1, t[3]);
  }
}

// A warp's partial [16][DC] sum (C fragments) into its slot, row stride S.
template <int DC, int S>
__device__ __forceinline__ void f32_partial(float* part, const float (&acc)[DC / 8][4], int g,
                                            int t4) {
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    *reinterpret_cast<float2*>(part + g * S + 8 * j + 2 * t4) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(part + (g + 8) * S + 8 * j + 2 * t4) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

}  // namespace mf_flash
