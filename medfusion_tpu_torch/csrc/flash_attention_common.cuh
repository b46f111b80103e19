// Fragment helpers shared by the flash-attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) kernels:
// bf16 packing, mma.sync m16n8k16 (bf16 in, f32 accumulate) and the tile
// loader that stages a [rows, D] tile in padded shared memory.
//
// mma.sync m16n8k16 fragments, for lane = 4 * g + t4 of a warp:
//   A (16x16, row-major): a0 = (row g, cols 2t4, 2t4+1), a1 = row g + 8,
//     a2 = (row g, cols 2t4 + 8, +9), a3 = row g + 8 of those;
//   B (16x8, column-major): b0 = (rows 2t4, 2t4+1, col g), b1 = rows + 8;
//   C (16x8): c0, c1 = (row g, cols 2t4, 2t4+1), c2, c3 = row g + 8.
// So the C fragments of two neighbouring n-tiles are, packed to bf16, the A
// fragment of one 16-wide k-step: a product's result feeds the next product
// without a round trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mf_flash {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_h(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c[0..3] += A(16x16, row) * B(16x8, col); bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [row0, row0 + 16), columns [col0, col0 + 16) of a
// row-major bf16 tile in shared memory with row stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int row0,
                                       int col0, int g, int t4) {
  const bf16* p = tile + (row0 + g) * LD + col0 + t4 * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
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

// rows x D tile from global (row stride st, rows >= valid zero) into shared
// memory with row stride LD, optionally scaled.
template <int D, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int valid,
                                          bool scaled, float s) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      val = *reinterpret_cast<const uint4*>(src + r * st + c);
      if (scaled) val = scale8(val, s);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

}  // namespace mf_flash
