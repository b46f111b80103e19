// Fragment helpers shared by the flash-attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) kernels: bf16
// packing, the A fragment of a product from the C fragments of another, the
// rounding of a scaled bf16 chunk, and the split-TF32 products of the f32
// routes.
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
__device__ __forceinline__ void tf32_load_a(Tf32A& a, const float* m, int ld, int g, int c) {
  const float2 r0 = *reinterpret_cast<const float2*>(m + g * ld + c);
  const float2 r1 = *reinterpret_cast<const float2*>(m + (g + 8) * ld + c);
  tf32_split_a(a, r0.x, r1.x, r0.y, r1.y);
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

}  // namespace mf_flash
