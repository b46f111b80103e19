// GroupNorm (+ optional SiLU) for NVIDIA Hopper (sm_90a), NCHW contiguous.
//
// Replaces the Pallas TPU kernel medfusion_tpu/ops/group_norm.py::_kernel
// (launched by _pallas_group_norm_silu). Same math: per (batch, group) the
// mean, then the mean of the centred squares, both in f32 over every
// spatial position x the channels of the group; then y = (x - mean) *
// rsqrt(var + eps) * scale[c] + bias[c], then y * sigmoid(y) when
// apply_silu, stored in x's dtype.
//
// Bound: bytes. The function reads x once and writes y once (2 bytes an
// element each way in bf16) and does a dozen operations an element. In
// contiguous NCHW every (b, g) is one contiguous run of n = (C/G) * S
// values. So the design keeps a whole run on chip between its statistics
// and its normalisation: ONE launch a call, x read from device memory once
// and y written once, no scratch. The TPU kernel does the same with one
// VMEM block a run; its [C, G] membership matmul exists only because Mosaic
// rejects the group reshape, and has no counterpart here.
//
// Two routes, chosen by shape in ops/group_norm.py::launch_plan:
//
//  * block (n <= 16,384: every UNet shape). A group is held in the
//    registers of gt threads (up to 512; several groups a block where gt
//    is under 256), each thread loading its `UNITS` 16-byte vectors (8
//    bf16 or 4 f32, about 16 values a thread) with one load each and
//    keeping them packed. Both statistics passes run over the registers: a
//    warp-shuffle sum and, where a group spans several warps, one
//    shared-memory step. Then the affine and the SiLU are applied in
//    registers and stored with 16-byte stores; a vector's channel is one
//    division (then a walk across a boundary, where S is not a multiple of
//    the vector).
//  * cluster (larger groups: every VAE shape). A group is one thread-block
//    cluster of cs blocks of 512 threads (up to 16 blocks, non-portable
//    above 8), each holding a contiguous slice of the run (64 KB where the
//    cluster allows, so three blocks share an SM) in shared memory. One
//    thread issues the slice as 1-D bulk copies (cp.async.bulk, 16 KB
//    each, one mbarrier each), so the whole slice is in flight at once and
//    the first pass sums each chunk as it lands. Each block's partial sum
//    goes through distributed shared memory: every block reads the cs
//    partials in rank order, so every block (and every run) gets the same
//    bits. The mean comes first, then the centred squares over the
//    shared-memory copy, reduced the same way, then each block normalises
//    its slice and writes it. A slice larger than a block's shared memory
//    (a group of more than about 3.5 MB, or 1.75 MB under a cluster of 8)
//    keeps what fits resident and reads the rest from device memory on
//    each pass: stated in the plan (`resident` < `slice`), not a fallback.
//
// Sums are in a fixed order (per thread, then a fixed shuffle tree, then
// warps and ranks in order), so the kernel is deterministic. The means are
// sums times 1/n (rounded once on the host); the SiLU uses __expf and
// __fdividef: no IEEE division or reciprocal, with its slow-path branch, in
// the kernels. Launches go on the caller's stream; nothing is allocated here.
// Each entry point returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

namespace cgr = cooperative_groups;
using mf_sm90::DeviceAttr;
using mf_sm90::mbar_arrive_expect_tx;
using mf_sm90::mbar_init;
using mf_sm90::mbar_init_fence;
using mf_sm90::mbar_wait;
using mf_sm90::set_attribute;
using mf_sm90::set_smem;
using mf_sm90::smem_addr;

typedef __nv_bfloat16 bf16;

template <typename T> constexpr int kVec = 16 / (int)sizeof(T);  // elements a 16-byte vector
constexpr int kChunkBytes = 16384;  // one bulk copy, one mbarrier
constexpr int kMaxChunks = 16;      // 16 x 16 KB > the 227 KB a block may hold
constexpr int kBlockMaxThreads = 512;  // the block route's widest block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// The values of one 16-byte vector (8 bf16 or 4 f32) as f32, and back
// (bf16 rounded to nearest even, as XLA's convert). Element 2i of a bf16
// pair is the low half of its word.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4 u, float (&f)[kVec<T>]) {
  if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  } else {
    f[0] = __uint_as_float(u.x << 16);
    f[1] = __uint_as_float(u.x & 0xffff0000u);
    f[2] = __uint_as_float(u.y << 16);
    f[3] = __uint_as_float(u.y & 0xffff0000u);
    f[4] = __uint_as_float(u.z << 16);
    f[5] = __uint_as_float(u.z & 0xffff0000u);
    f[6] = __uint_as_float(u.w << 16);
    f[7] = __uint_as_float(u.w & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[kVec<T>]) {
  if constexpr (sizeof(T) == 4)
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  else
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                      pack_bf16(f[6], f[7]));
}

// W elements at p (W = kVec<T>: one 16-byte access; W = 1: one element).
template <typename T, int W>
__device__ __forceinline__ void load(const T* p, float (&f)[W]) {
  if constexpr (W == 1)
    f[0] = to_f(*p);
  else
    unpack<T>(*reinterpret_cast<const uint4*>(p), f);
}

template <typename T, int W>
__device__ __forceinline__ void store(T* p, const float (&f)[W]) {
  if constexpr (W == 1)
    *p = from_f<T>(f[0]);
  else
    *reinterpret_cast<uint4*>(p) = pack<T>(f);
}

// What the normalisation of one group needs.
template <typename T>
struct Affine {
  const T* scale;
  const T* bias;
  int S;   // spatial positions: the channel of group position p is c0 + p / S
  int c0;  // the group's first channel
  bool silu;
  float mean, rstd;

  // The first `cnt` of W values at group positions pos, pos + 1, ..., in
  // place: one division for the first one's channel, then a walk (a vector
  // meets a channel boundary only where S is not a multiple of it).
  template <int W>
  __device__ __forceinline__ void apply(float (&f)[W], int pos, int cnt) const {
    int c = c0 + pos / S;
    int r = pos - (c - c0) * S;
    float a = rstd * to_f(scale[c]), b = to_f(bias[c]);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j >= cnt) break;
      if (r == S) {
        ++c;
        r = 0;
        a = rstd * to_f(scale[c]);
        b = to_f(bias[c]);
      }
      f[j] = (f[j] - mean) * a + b;
      ++r;
    }
    // SiLU: fast exponential and division (no slow-path call)
    if (silu) {
#pragma unroll
      for (int j = 0; j < W; ++j) f[j] = __fdividef(f[j], 1.f + __expf(-f[j]));
    }
  }
};

// Butterfly sum over a warp: every lane ends with the same bits (each step
// adds the same two values in either order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over `warps` consecutive warps from `warp0` (every thread of them
// gets it), through red[] (one slot a warp; a buffer is used once).
// `warps` is the same for the whole block.
__device__ __forceinline__ float warps_sum(float v, float* red, int warps, int warp0) {
  v = warp_sum(v);
  if (warps == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < warps; ++w) t += red[warp0 + w];
  return t;
}

// ---- block route: a group in the registers of gt threads ----

// Thread t of a group holds vectors t, t + gt, ... (UNITS of them) of the
// run, as loaded (16 bytes each; unpacked to f32 on each pass, so a bf16
// value takes half a register). VEC: n % kVec == 0 and x 16-byte aligned,
// so each vector is one load; else element by element (ragged runs).
template <typename T, int UNITS, bool VEC>
__global__ void __launch_bounds__(kBlockMaxThreads)
gn_block_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                const T* __restrict__ bias, T* __restrict__ y, int groups, int n,
                int S, int cg, int G, int gt, float inv_n, float eps, int apply_silu) {
  constexpr int V = kVec<T>;
  __shared__ float red[2][32];
  const int gib = threadIdx.x / gt;  // group within the block
  const int t = threadIdx.x - gib * gt;
  const int g = blockIdx.x * (blockDim.x / gt) + gib;
  const bool live = g < groups;  // a dead group's threads still reach the barriers
  const int64_t base = (int64_t)(live ? g : 0) * n;
  const T* xg = x + base;
  T* yg = y + base;

  uint4 raw[UNITS];
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int pos = (u * gt + t) * V;
    raw[u] = make_uint4(0u, 0u, 0u, 0u);  // zeros past n
    if (live && pos < n) {
      if constexpr (VEC) {
        raw[u] = *reinterpret_cast<const uint4*>(xg + pos);
      } else {
        float f[V];
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = pos + j < n ? to_f(xg[pos + j]) : 0.f;
        raw[u] = pack<T>(f);  // exact: the values are T's
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    float f[V];
    unpack<T>(raw[u], f);
#pragma unroll
    for (int j = 0; j < V; ++j) s += f[j];
  }
  const int warps = gt >> 5;
  const float mean = warps_sum(s, red[0], warps, gib * warps) * inv_n;
  float q = 0.f;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int pos = (u * gt + t) * V;
    float f[V];
    unpack<T>(raw[u], f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = f[j] - mean;
      if (pos + j < n) q += d * d;
    }
  }
  const float var = warps_sum(q, red[1], warps, gib * warps) * inv_n;
  if (!live) return;  // past the last barrier
  const Affine<T> aff{scale, bias, S, (g % G) * cg, apply_silu != 0, mean,
                      rsqrtf(var + eps)};
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int pos = (u * gt + t) * V;
    if (pos >= n) continue;
    const int cnt = min(V, n - pos);
    float f[V];
    unpack<T>(raw[u], f);
    aff.template apply<V>(f, pos, cnt);
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(yg + pos) = pack<T>(f);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (j < cnt) yg[pos + j] = from_f<T>(f[j]);
    }
  }
}

// ---- cluster route: a group in the shared memory of a cluster ----

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The cluster's total of each block's part[k], read in rank order.
__device__ __forceinline__ float cluster_total(cgr::cluster_group& cluster, float* part,
                                               int cs) {
  float t = 0.f;
  for (int r = 0; r < cs; ++r) t += *cluster.map_shared_rank(part, r);
  return t;
}

// Block `rank` of a cluster holds run positions [rank * slice, + len): the
// first `resident` in shared memory, the rest read from device memory on
// each pass. W: kVec<T> with 16-byte vectors and bulk copies (n and slice
// multiples of kVec, x 16-byte aligned), else 1.
template <typename T, int W>
__global__ void __launch_bounds__(1024)
gn_cluster_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ bias, T* __restrict__ y, int n, int S, int cg,
                  int G, int slice, int resident, float inv_n, float eps,
                  int apply_silu) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  __shared__ float red[2][32];
  __shared__ float part[2];
  cgr::cluster_group cluster = cgr::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t g = blockIdx.x / cs;
  const int start = rank * slice;
  const int len = max(0, min(slice, n - start));
  const int res = min(len, resident);
  const T* xs = x + g * n + start;
  T* ys = y + g * n + start;
  const T* buf = reinterpret_cast<const T*>(smem_raw);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int units = res / W, tail_units = (len - res) / W;  // W divides both
  const int warps = nt >> 5;

  float s = 0.f;
  if constexpr (W > 1) {
    const int bytes = res * (int)sizeof(T);
    const int nchunk = (bytes + kChunkBytes - 1) / kChunkBytes;
    if (tid == 0) {
      for (int k = 0; k < nchunk; ++k) mbar_init(smem_addr(&bars[k]), 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = 0; k < nchunk; ++k) {
        const int off = k * kChunkBytes;
        const int b = min(kChunkBytes, bytes - off);
        mbar_arrive_expect_tx(smem_addr(&bars[k]), b);
        bulk_load(smem_addr(smem_raw + off), reinterpret_cast<const char*>(xs) + off, b,
                  smem_addr(&bars[k]));
      }
    }
    constexpr int kChunkUnits = kChunkBytes / 16;
    for (int k = 0; k < nchunk; ++k) {  // sum each chunk as it lands
      mbar_wait(smem_addr(&bars[k]), 0);
      const int end = min(units, (k + 1) * kChunkUnits);
      for (int i = k * kChunkUnits + tid; i < end; i += nt) {
        float f[W];
        load<T, W>(buf + i * W, f);
#pragma unroll
        for (int j = 0; j < W; ++j) s += f[j];
      }
    }
  } else {
    T* dst = reinterpret_cast<T*>(smem_raw);
    for (int i = tid; i < res; i += nt) dst[i] = xs[i];
    __syncthreads();
    for (int i = tid; i < res; i += nt) s += to_f(buf[i]);
  }
  for (int i = tid; i < tail_units; i += nt) {
    float f[W];
    load<T, W>(xs + res + i * W, f);
#pragma unroll
    for (int j = 0; j < W; ++j) s += f[j];
  }
  s = warps_sum(s, red[0], warps, 0);
  if (tid == 0) part[0] = s;
  cluster.sync();
  const float mean = cluster_total(cluster, &part[0], cs) * inv_n;

  float q = 0.f;
  for (int i = tid; i < units; i += nt) {
    float f[W];
    load<T, W>(buf + i * W, f);
#pragma unroll
    for (int j = 0; j < W; ++j) q += (f[j] - mean) * (f[j] - mean);
  }
  for (int i = tid; i < tail_units; i += nt) {
    float f[W];
    load<T, W>(xs + res + i * W, f);
#pragma unroll
    for (int j = 0; j < W; ++j) q += (f[j] - mean) * (f[j] - mean);
  }
  q = warps_sum(q, red[1], warps, 0);
  if (tid == 0) part[1] = q;
  cluster.sync();
  const float var = cluster_total(cluster, &part[1], cs) * inv_n;
  cluster_arrive();  // this block has read every part[1]; waited for before exit

  const Affine<T> aff{scale, bias, S, (int)(g % G) * cg, apply_silu != 0, mean,
                      rsqrtf(var + eps)};
  for (int i = tid; i < units; i += nt) {
    float f[W];
    load<T, W>(buf + i * W, f);
    aff.template apply<W>(f, start + i * W, W);
    store<T, W>(ys + i * W, f);
  }
  for (int i = tid; i < tail_units; i += nt) {
    float f[W];
    load<T, W>(xs + res + i * W, f);
    aff.template apply<W>(f, start + res + i * W, W);
    store<T, W>(ys + res + i * W, f);
  }
  cluster_wait();  // no block leaves while another may read its part[]
}

// ---- host side ----

template <typename T, int UNITS, bool VEC>
int launch_block(const void* x, const void* scale, const void* bias, void* y, int groups,
                 int n, int S, int cg, int G, float eps, int apply_silu, int threads,
                 int gt, cudaStream_t stream) {
  const int per_block = threads / gt;
  const int blocks = (groups + per_block - 1) / per_block;
  gn_block_kernel<T, UNITS, VEC><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(y), groups, n, S, cg, G, gt, 1.f / (float)n, eps, apply_silu);
  return (int)cudaGetLastError();
}

template <typename T, int UNITS>
int launch_block_units(bool vec, const void* x, const void* scale, const void* bias,
                       void* y, int groups, int n, int S, int cg, int G, float eps,
                       int apply_silu, int threads, int gt, cudaStream_t stream) {
  return vec ? launch_block<T, UNITS, true>(x, scale, bias, y, groups, n, S, cg, G, eps,
                                            apply_silu, threads, gt, stream)
             : launch_block<T, UNITS, false>(x, scale, bias, y, groups, n, S, cg, G, eps,
                                             apply_silu, threads, gt, stream);
}

template <typename T>
int launch_block_route(int units, bool vec, const void* x, const void* scale,
                       const void* bias, void* y, int groups, int n, int S, int cg, int G,
                       float eps, int apply_silu, int threads, int gt,
                       cudaStream_t stream) {
  // at most 32 values a thread: 4 bf16 vectors or 8 f32 ones
  switch (units) {
    case 1: return launch_block_units<T, 1>(vec, x, scale, bias, y, groups, n, S, cg, G,
                                            eps, apply_silu, threads, gt, stream);
    case 2: return launch_block_units<T, 2>(vec, x, scale, bias, y, groups, n, S, cg, G,
                                            eps, apply_silu, threads, gt, stream);
    case 4: return launch_block_units<T, 4>(vec, x, scale, bias, y, groups, n, S, cg, G,
                                            eps, apply_silu, threads, gt, stream);
    case 8:
      if constexpr (sizeof(T) == 4)
        return launch_block_units<T, 8>(vec, x, scale, bias, y, groups, n, S, cg, G, eps,
                                        apply_silu, threads, gt, stream);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// Lets the cluster kernel take `smem` bytes of dynamic shared memory and
// clusters above the portable 8 (once for each, per instantiation and
// device).
template <typename T, int W>
int prepare_cluster(int cs, int smem) {
  static DeviceAttr smem_set, nonportable_set;
  const auto kernel = gn_cluster_kernel<T, W>;
  const int err = set_smem(kernel, smem, &smem_set);
  if (err != 0 || cs <= 8) return err;
  return set_attribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1,
                       &nonportable_set);
}

cudaLaunchConfig_t cluster_config(int blocks, int threads, int cs, int smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int W>
int launch_cluster(const void* x, const void* scale, const void* bias, void* y, int groups,
                   int n, int S, int cg, int G, float eps, int apply_silu, int threads,
                   int cs, int slice, int resident, int smem, cudaStream_t stream) {
  int err = prepare_cluster<T, W>(cs, smem);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(groups * cs, threads, cs, smem, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gn_cluster_kernel<T, W>, static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(y), n, S, cg, G, slice, resident,
      1.f / (float)n, eps, apply_silu);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int W>
int max_clusters(int threads, int cs, int smem) {
  int err = prepare_cluster<T, W>(cs, smem);
  if (err) return -err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cs, threads, cs, smem, 0, attr);
  int num = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&num, gn_cluster_kernel<T, W>, &cfg);
  return e == cudaSuccess ? num : -(int)e;
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y, int groups, int n,
           int S, int cg, int G, float eps, int apply_silu, int route, int vec,
           int threads, int group_threads, int units, int cs, int slice, int resident,
           int smem, cudaStream_t stream) {
  if (route == 0)
    return launch_block_route<T>(units, vec != 0, x, scale, bias, y, groups, n, S, cg, G,
                                 eps, apply_silu, threads, group_threads, stream);
  return vec ? launch_cluster<T, kVec<T>>(x, scale, bias, y, groups, n, S, cg, G, eps,
                                          apply_silu, threads, cs, slice, resident, smem,
                                          stream)
             : launch_cluster<T, 1>(x, scale, bias, y, groups, n, S, cg, G, eps,
                                    apply_silu, threads, cs, slice, resident, smem, stream);
}

}  // namespace

// One launch of the plan ops/group_norm.py::launch_plan gives: route 0
// (block: `threads` a block, `group_threads` a group, `units` vectors a
// thread) or 1 (cluster: `cs` blocks of `threads` a group, `slice`
// positions a block, the first `resident` of them in `smem` bytes of shared
// memory); vec: 16-byte accesses. groups = B * G, n = (C / G) * S.
extern "C" int mf_group_norm_silu(int is_bf16, const void* x, const void* scale,
                                  const void* bias, void* y, int groups, int n, int S,
                                  int cg, int G, float eps, int apply_silu, int route,
                                  int vec, int threads, int group_threads, int units,
                                  int cs, int slice, int resident, int smem,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(x, scale, bias, y, groups, n, S, cg, G, eps, apply_silu,
                                route, vec, threads, group_threads, units, cs, slice,
                                resident, smem, st)
                 : launch<float>(x, scale, bias, y, groups, n, S, cg, G, eps, apply_silu,
                                 route, vec, threads, group_threads, units, cs, slice,
                                 resident, smem, st);
}

// cudaOccupancyMaxActiveClusters for the cluster route's plan (>= 0), or
// minus the CUDA error.
extern "C" int mf_group_norm_silu_max_clusters(int is_bf16, int vec, int threads, int cs,
                                               int smem) {
  if (is_bf16)
    return vec ? max_clusters<bf16, kVec<bf16>>(threads, cs, smem)
               : max_clusters<bf16, 1>(threads, cs, smem);
  return vec ? max_clusters<float, kVec<float>>(threads, cs, smem)
             : max_clusters<float, 1>(threads, cs, smem);
}
