// Shared helpers for the port's CUDA kernels (plain C interface,
// loaded with ctypes; no PyTorch headers). Built with g++ and
// -DREPRO_HOST_EMULATION, the CUDA primitives come from
// host_emulation.cuh instead (a CPU stand-in: tools/*_host_check.py),
// and the helpers below them are the same code.
#pragma once

#include <stdint.h>

#ifdef REPRO_HOST_EMULATION
#include "host_emulation.cuh"
#else
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// 16-byte asynchronous global -> shared copy (cp.async.cg, bypassing
// L1); with pred false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

// 4-byte asynchronous global -> shared copy (cp.async.ca: the 16-byte
// .cg form is the only one that bypasses L1); zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- tensor cores: mma.sync m16n8k16 (f32 accumulators) and ldmatrix
// Mma<T>::run: c += a b with a a 16x16 row-major fragment (4 regs) and
// b a 16x8 column-major fragment (2 regs); Mma<T>::pack rounds two
// floats into one register of the input type
template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 address
// the rows of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// a kernel's dynamic shared memory, and a launch (host_emulation.cuh
// gives both on the CPU)
#define BWD_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#define BWD_LAUNCH(kern, grid, block, smem, stream, ...) \
  kern<<<grid, block, smem, stream>>>(__VA_ARGS__)
#define REPRO_WARPS 1

// ---- thread block clusters: a launch whose grid's z axis is cut into
// clusters of cz blocks (cz <= 8, dividing gridDim.z), this block's rank
// in its cluster and their count (1 under a plain launch), a barrier of
// every thread of the cluster (release / acquire: the shared-memory
// writes before it are seen after it), and an address of this block's
// shared memory mapped to the same offset in the cluster's block `rank`
// (distributed shared memory, read with plain loads)
template <typename... Exp, typename... Act>
inline cudaError_t repro_cluster_z_launch(void (*kern)(Exp...), dim3 grid,
                                          dim3 block, size_t smem,
                                          cudaStream_t stream, unsigned cz,
                                          Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cz;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}
#define CLUSTER_Z_LAUNCH(kern, grid, block, smem, stream, cz, ...) \
  repro_cluster_z_launch(kern, grid, block, smem, stream, cz, __VA_ARGS__)
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
template <typename T>
__device__ __forceinline__ const T* cluster_peer(const T* p, unsigned rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const T*>(out);
}
#endif  // REPRO_HOST_EMULATION

// dtype codes passed by the Python wrappers
enum ReproDtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

#define REPRO_NEG_INF (-1e30f)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Python's floor // and mod (as jnp's) for a divisor b > 0
__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {  // b > 0
  int r = a % b;
  return r < 0 ? r + b : r;
}

// a masked logit: exp of it is exactly 0, and it never raises a max
#define REPRO_MASKED __int_as_float(0xff800000u)

// ROWS rows of D elements from row0 of src (row stride `stride`) into
// dst (row stride D + 8: the 16-byte pad puts the eight row addresses
// of an ldmatrix in distinct bank groups), 16 bytes per cp.async by
// NT threads; rows at and past nrows are zero-filled
template <int ROWS, int D, int NT, typename T>
__device__ __forceinline__ void cp_async_rows(T* dst, const T* src, int row0,
                                              int nrows, size_t stride,
                                              int tid) {
  constexpr int CPR = D * (int)sizeof(T) / 16;   // 16-byte chunks a row
  constexpr int EPC = 16 / (int)sizeof(T);       // elements a chunk
  static_assert((ROWS * CPR) % NT == 0, "whole rounds");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / CPR, cc = c - r * CPR;
    const bool ok = row0 + r < nrows;
    cp_async16(dst + r * (D + 8) + cc * EPC,
               src + (ok ? (size_t)(row0 + r) * stride + cc * EPC : 0), ok);
  }
}

// 8 consecutive elements (16-byte aligned) -> float
__device__ __forceinline__ void load8_f32(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8_f32(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8_f32(const __half* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// (a, b) -> hi + lo as two register pairs of T: hi = T(v), lo = T(v -
// hi), ~16 bits of each value's mantissa between them in bf16 (two
// products where one would do)
template <typename T>
__device__ __forceinline__ void split_hi_lo(float a, float b, uint32_t& hi,
                                            uint32_t& lo) {
  const uint32_t h = Mma<T>::pack(a, b);
  const T* hv = reinterpret_cast<const T*>(&h);
  hi = h;
  lo = Mma<T>::pack(a - to_f32(hv[0]), b - to_f32(hv[1]));
}

// once a library: a source built in parts (kernels/_build.py PARTS)
// defines it in part 0
#if !defined(REPRO_PART) || REPRO_PART == 0
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif
