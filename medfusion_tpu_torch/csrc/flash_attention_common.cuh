// Fragment helpers shared by the flash-attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) kernels: bf16
// packing, the A fragment of a product from the C fragments of another, and
// the rounding of a scaled bf16 chunk.
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

}  // namespace mf_flash
