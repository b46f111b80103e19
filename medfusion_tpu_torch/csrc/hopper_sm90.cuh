// Hopper (sm_90a) building blocks for the flash-attention kernels, forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu), and the GEGLU
// MLP (geglu_mlp.cu): warpgroup matrix multiplies (wgmma) with their
// shared-memory descriptors and fences, mbarriers, TMA tile loads and the
// host-side encoders of their 4-D and 2-D tensor maps.
//
// wgmma m64nNk16, bf16 in, f32 accumulate, issued by one warpgroup (four
// consecutive warps, the first a multiple of 4). The accumulator d[N/2] of
// thread 32 * w + 4 * g + t4 holds, for each 8-column chunk j, the
// mma.sync C fragment of rows 16 w + g and 16 w + g + 8:
//   d[4j], d[4j+1] = (row 16w+g, cols 8j+2t4, +1); d[4j+2], d[4j+3] = row + 8.
// An A operand in registers is the mma.sync m16n8k16 A fragment of the
// warp's 16 rows, so the C fragments of chunks 2kk and 2kk+1, packed to
// bf16, are the A fragment of k-step kk (mf_flash::a_from_c).
//
// Shared tiles are written by TMA with the swizzle that matches their row
// width: a tile of R rows and W = min(D, 64) bf16 columns (32, 64 or 128
// bytes a row) is R rows of W columns, the 16-byte chunks of row r XORed
// with bits of r (SWIZZLE_32B/64B/128B); D = 128 is two such tiles side by
// side ("halves"). Every tile starts on a 1,024-byte boundary, so the
// swizzle, which the hardware applies to address bits, is the same for TMA
// and wgmma. A descriptor names an 8-row group's stride (SBO = 8 rows) and
// the layout; the leading offset (LBO) is unused in both ways a tile is read
// here:
//   K-major: the tile's rows are M (or N) and its columns K; k-step kk
//     starts 32 bytes further along the row (the next half at D = 128);
//   MN-major: the tile's rows are K and its columns N (at most one swizzle
//     atom, W columns, per instruction); k-step kk starts 16 rows further.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace mf_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory from its first 1,024-byte boundary (the
// launch asks for 1,024 bytes more than the layout needs).
__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t a = smem_addr(smem_raw);
  return smem_raw + ((1024 - (a & 1023)) & 1023);
}

// layout: 1 = 128-byte swizzle, 2 = 64-byte, 3 = 32-byte
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32)
         | (static_cast<uint64_t>(layout) << 62);
}

// A tile of ROWS rows and D bf16 columns, as TMA wrote it (see above).
template <int D, int ROWS>
struct SwTile {
  static constexpr int W = D < 64 ? D : 64;            // columns of one half
  static constexpr int ROW_BYTES = 2 * W;              // 32, 64 or 128
  static constexpr int HALF_BYTES = ROWS * ROW_BYTES;
  static constexpr int BYTES = ROWS * D * 2;
  static constexpr int KSTEPS_PER_HALF = ROW_BYTES / 32;
  static constexpr int LAYOUT = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
  static_assert(HALF_BYTES % 1024 == 0, "tiles must keep 1,024-byte alignment");

  // K-major operand (rows = M or N, columns = K), k-step kk of D / 16
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int kk) {
    return make_desc(base + (kk / KSTEPS_PER_HALF) * HALF_BYTES
                         + (kk % KSTEPS_PER_HALF) * 32,
                     16, 8 * ROW_BYTES, LAYOUT);
  }
  // MN-major operand (rows = K, columns of half h = N), k-step kk of ROWS / 16
  static __device__ __forceinline__ uint64_t mn_major(uint32_t base, int kk, int h) {
    return make_desc(base + h * HALF_BYTES + kk * 16 * ROW_BYTES, HALF_BYTES,
                     8 * ROW_BYTES, LAYOUT);
  }
};

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands, TMA): a thread that rewrites a
// tile in place issues it before releasing the tile to the wgmma readers.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses to accumulator registers across
// a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma m64nNk16 for the N the kernels use, each spelled out (the
// instruction names every accumulator register): ss() reads A and B from
// shared memory, both K-major, and overwrites d where accumulate is 0 (N =
// 32, 64: the score tiles; 64, 128: the GEGLU products); rs() takes A from
// registers and B MN-major, and accumulates (N = 16, 32, 64: the head dim,
// or a 64-column half of a wider one).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d[8] += A(64x16, registers) * B(16x16, smem desc b, MN-major)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<32> {
  // d[16] (+)= A(64x16, smem desc a) * B(16x32, smem desc b), both K-major
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate)
        : "memory");
  }
  // d[16] += A(64x16, registers) * B(16x32, smem desc b, MN-major)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<64> {
  // d[32] (+)= A(64x16, smem desc a) * B(16x64, smem desc b), both K-major
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate)
        : "memory");
  }
  // d[32] += A(64x16, registers) * B(16x64, smem desc b, MN-major)
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<128> {
  // d[64] (+)= A(64x16, smem desc a) * B(16x128, smem desc b), both K-major
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate)
        : "memory");
  }
};

// mbarriers (shared::cta). wait(parity) returns once the phase of that
// parity has completed: the k-th completion (k = 0, 1, ...) has parity k & 1.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// A wait that has not ended after 2^35 clocks (~17 s) traps, so that a
// broken pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

// One TMA box of a 2-D tensor map (column, row) into shared memory at dst,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// One TMA box of a 4-D tensor map (d, token, head, batch) into shared
// memory at dst, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// 2^x on the SFU (ex2.approx, subnormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- host side ----

// A function's attributes belong to the context of one device, so a kernel
// that one process launches on several cards (a model on a second card, or
// one process holding every card of a host) is opted in on each of them.
constexpr int kMaxDevices = 64;

// One attribute of one kernel: the largest value set so far on each device
// (a function-local static beside the launch). Threads that launch at once
// check it without the lock and set it under the lock.
struct DeviceAttr {
  std::atomic<int> value[kMaxDevices] = {};
  std::mutex lock;
};

// Sets `attr` of `kernel` to `value` on the current device unless *done
// holds at least `value` there. Returns 0 or the CUDA error.
template <typename Kernel>
int set_attribute(Kernel kernel, cudaFuncAttribute attr, int value, DeviceAttr* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (done->value[dev].load(std::memory_order_acquire) >= value) return 0;
  std::lock_guard<std::mutex> hold(done->lock);
  if (done->value[dev].load(std::memory_order_relaxed) >= value) return 0;
  err = cudaFuncSetAttribute(kernel, attr, value);
  if (err != cudaSuccess) return (int)err;
  done->value[dev].store(value, std::memory_order_release);
  return 0;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device.
template <typename Kernel>
int set_smem(Kernel kernel, int bytes, DeviceAttr* done) {
  return set_attribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes, done);
}

// The tensor maps of the TMA loads.

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// An entry point returns this plus the CUresult where a map cannot be encoded.
constexpr int kEncodeError = 10000;

// cuTensorMapEncodeTiled needs a context current on the calling thread, which
// a thread that has made no runtime call yet lacks (autograd's device thread
// when an attention backward is its first CUDA work: torch's device guard
// skips cudaSetDevice for the device already selected). cudaSetDevice makes
// the device's primary context current, as the runtime's first call would.
inline bool bind_context() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && cudaSetDevice(dev) == cudaSuccess;
}

// The 4-D map (d, token, head, batch) of a bf16 tensor [B, H, tokens, d]
// at `ptr` with element strides st = (batch, head, token) and a unit-stride
// head dim, in boxes of (W, rows, 1, 1) with the swizzle of a W-column tile
// (W = 16, 32 or 64: SwTile<D, rows>::W). A box that reaches past d or past
// the last token is zero-filled, so a kernel compiled for a wider head dim
// reads d's columns and zeros. A dim of extent 1 takes the stride that a
// packed tensor would have (the kernels never step along it); a zero stride
// along a longer dim is refused (the wrappers copy such an operand).
// Returns 0 or kEncodeError + the CUresult.
inline int encode(CUtensorMap* map, void* ptr, const long long* st, int d, int B, int H,
                  int tokens, int rows, int W) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  if (!bind_context()) return kEncodeError + (int)CUDA_ERROR_INVALID_CONTEXT;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)tokens, (cuuint64_t)H, (cuuint64_t)B};
  const long long by_dim[3] = {st[2], st[1], st[0]};  // token, head, batch
  cuuint64_t strides[3];
  long long packed = d;
  for (int i = 0; i < 3; ++i) {
    const long long s = dims[i + 1] == 1 ? packed : by_dim[i];
    if (s <= 0) return kEncodeError + (int)CUDA_ERROR_INVALID_VALUE;
    strides[i] = (cuuint64_t)s * 2;
    packed = s * (long long)dims[i + 1];
  }
  cuuint32_t box[4] = {(cuuint32_t)W, (cuuint32_t)rows, 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = W == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box,
                          unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + (int)res;
}

// The 2-D map (column, row) of a row-major bf16 matrix [rows, cols] at
// `ptr` (row stride cols, a multiple of 8), in boxes of 64 columns (128
// bytes, SWIZZLE_128B: the layout of SwTile<64, box_rows>) by box_rows rows;
// a box that reaches past the matrix is zero-filled. Returns 0 or
// kEncodeError + the CUresult.
inline int encode_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  if (!bind_context()) return kEncodeError + (int)CUDA_ERROR_INVALID_CONTEXT;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  cuuint32_t unit[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + (int)res;
}

}  // namespace mf_sm90
