// A CPU stand-in for the CUDA runtime and the warp primitives the
// attention and scan kernels use, so that their C++ runs on a machine
// with no card: common.cuh includes it in place of the CUDA headers when
// a source is built with g++ and -DREPRO_HOST_EMULATION
// (tools/mamba_scan_bwd_host_check.py, tools/flash_bwd_host_check.py,
// tools/flash_fwd_host_check.py, tools/paged_attention_host_check.py).
//
// - A launch (BWD_LAUNCH) runs the grid's blocks one after another
//   (CLUSTER_Z_LAUNCH: a thread block cluster's blocks at once);
//   each CUDA thread of a block is a CPU thread, and __syncthreads() is
//   a std::barrier of the block. The dynamic shared memory (BWD_SMEM)
//   is filled with NaN before each block, so a read of a word no phase
//   wrote shows; static __shared__ arrays are function statics.
// - Each warp's 32 lanes meet at a barrier of their own in every warp
//   primitive: the shuffles, ballots and reductions, ldmatrix (plain
//   and transposed) and mma.sync.m16n8k16 with their fragment layouts
//   (a product summed in f32 in k order), __syncwarp.
// - cp.async is a copy (zero-fill when the predicate is false); commit
//   and wait do nothing.
// - bf16 is its 16 bits with round-to-nearest-even; f16 is _Float16.
// REPRO_WARPS is 1 with -DREPRO_HOST_WARPS (the tensor-core bodies are
// built) and 0 without (a source may compile them out).
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(n) alignas(n)
#define __shared__ static

#ifdef REPRO_HOST_WARPS
#define REPRO_WARPS 1
#else
#define REPRO_WARPS 0
#endif

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
template <typename F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// an H100's 132 SMs
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 132;
  return 0;
}
inline const char* cudaGetErrorString(cudaError_t) { return "host emulation"; }

struct int2 { int x, y; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { uint32_t x, y, z, w; };
inline int2 make_int2(int a, int b) { return {a, b}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline float __int_as_float(int v) {
  float f;
  std::memcpy(&f, &v, 4);
  return f;
}
inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
template <typename T>
inline T __ldg(const T* p) { return *p; }
inline float __fdividef(float a, float b) { return a / b; }
inline float __expf(float x) { return expf(x); }
// global-memory primitives of the split combine: loads past L1, the
// ticket's atomic and the fence (blocks run one after another, but a
// block's threads at once)
template <typename T>
inline T __ldcg(const T* p) { return *p; }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }

// the 2-byte types as their bits
struct __nv_bfloat16 { uint16_t bits; };
struct __half { uint16_t bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
struct __half2 { __half x, y; };
inline float to_f32(float v) { return v; }
inline float to_f32(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float to_f32(__half v) {
  _Float16 h;
  std::memcpy(&h, &v.bits, 2);
  return (float)h;
}
template <typename T> T from_f32(float v);
template <> inline float from_f32<float>(float v) { return v; }
template <> inline __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
template <> inline __half from_f32<__half>(float v) {
  const _Float16 h = (_Float16)v;
  __half r;
  std::memcpy(&r.bits, &h, 2);
  return r;
}
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {to_f32(v.x), to_f32(v.y)};
}
inline float2 __half22float2(__half2 v) { return {to_f32(v.x), to_f32(v.y)}; }
inline __nv_bfloat16 __float2bfloat16(float v) {
  return from_f32<__nv_bfloat16>(v);
}

// ---- warps: each lane a thread meeting its warp at a barrier
struct ReproWarp {
  std::barrier<> bar{32};
  uint32_t word[32];
  const void* addr[32];
  uint32_t a[32][4], b[32][2];
};
inline thread_local ReproWarp* repro_host_warps;
inline ReproWarp& repro_warp() { return repro_host_warps[threadIdx.x >> 5]; }
inline int repro_lane() { return (int)(threadIdx.x & 31); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  repro_warp().bar.arrive_and_wait();
}
// every lane's 32-bit value, then f(lane, values) on each lane
template <typename V, typename F>
inline auto repro_exchange(V v, F f) {
  static_assert(sizeof(V) == 4, "32-bit lanes");
  ReproWarp& w = repro_warp();
  std::memcpy(&w.word[repro_lane()], &v, 4);
  w.bar.arrive_and_wait();
  const auto r = f(repro_lane(), w.word);
  w.bar.arrive_and_wait();
  return r;
}
template <typename V>
inline V repro_lane_value(const uint32_t* words, int l) {
  V v;
  std::memcpy(&v, &words[l], 4);
  return v;
}
template <typename V>
inline V __shfl_xor_sync(unsigned, V v, int m) {
  return repro_exchange(v, [m](int l, const uint32_t* w) {
    return repro_lane_value<V>(w, l ^ m);
  });
}
template <typename V>
inline V __shfl_up_sync(unsigned, V v, int d) {
  return repro_exchange(v, [d, v](int l, const uint32_t* w) {
    return l >= d ? repro_lane_value<V>(w, l - d) : v;
  });
}
template <typename V>
inline V __shfl_down_sync(unsigned, V v, int d) {
  return repro_exchange(v, [d, v](int l, const uint32_t* w) {
    return l + d < 32 ? repro_lane_value<V>(w, l + d) : v;
  });
}
template <typename V>
inline V __shfl_sync(unsigned, V v, int s) {
  return repro_exchange(v, [s](int, const uint32_t* w) {
    return repro_lane_value<V>(w, s);
  });
}
inline unsigned __ballot_sync(unsigned, int pred) {
  return repro_exchange(pred ? 1u : 0u, [](int, const uint32_t* w) {
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m |= (w[i] & 1u) << i;
    return m;
  });
}
inline int __reduce_min_sync(unsigned, int v) {
  return repro_exchange(v, [](int, const uint32_t* w) {
    int m = repro_lane_value<int>(w, 0);
    for (int i = 1; i < 32; ++i) m = min(m, repro_lane_value<int>(w, i));
    return m;
  });
}
inline int __reduce_max_sync(unsigned, int v) {
  return repro_exchange(v, [](int, const uint32_t* w) {
    int m = repro_lane_value<int>(w, 0);
    for (int i = 1; i < 32; ++i) m = max(m, repro_lane_value<int>(w, i));
    return m;
  });
}

// ---- cp.async: a copy
inline void cp_async16(void* d, const void* s, bool ok) {
  if (ok) std::memcpy(d, s, 16); else std::memset(d, 0, 16);
}
inline void cp_async4(void* d, const void* s, bool ok) {
  if (ok) std::memcpy(d, s, 4); else std::memset(d, 0, 4);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

// ---- ldmatrix x4: lanes 8i .. 8i+7 address the rows of matrix i; lane
// l gets row l/4, elements 2(l%4), 2(l%4)+1 of each (transposed: rows
// 2(l%4) and 2(l%4)+1, element l/4)
template <bool TRANS>
inline void repro_ldsm(uint32_t* r, const void* p) {
  ReproWarp& w = repro_warp();
  const int l = repro_lane();
  w.addr[l] = p;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    if (TRANS) {
      const uint16_t* r0 = (const uint16_t*)w.addr[8 * i + 2 * (l % 4)];
      const uint16_t* r1 = (const uint16_t*)w.addr[8 * i + 2 * (l % 4) + 1];
      r[i] = r0[l / 4] | (uint32_t)r1[l / 4] << 16;
    } else {
      const uint16_t* row = (const uint16_t*)w.addr[8 * i + l / 4];
      r[i] = row[2 * (l % 4)] | (uint32_t)row[2 * (l % 4) + 1] << 16;
    }
  }
  w.bar.arrive_and_wait();
}
inline void ldsm_x4(uint32_t* r, const void* p) { repro_ldsm<false>(r, p); }
inline void ldsm_x4_trans(uint32_t* r, const void* p) {
  repro_ldsm<true>(r, p);
}

// ---- mma.sync.m16n8k16, f32 accumulators: c (rows l/4 and l/4 + 8,
// columns 2(l%4) and + 1) += a b; a's element (r, k) in register (r >=
// 8) + 2 (k >= 8) of lane (r%8) 4 + (k%8)/2, b's (k, n) in register k
// >= 8 of lane 4 n + (k%8)/2, the low half the even k
template <typename T>
inline float repro_half_bits(uint32_t v, int k) {
  return to_f32(T{(uint16_t)(k % 2 ? v >> 16 : v & 0xffff)});
}
template <typename T>
struct Mma {
  static void run(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    ReproWarp& w = repro_warp();
    const int l = repro_lane();
    std::memcpy(w.a[l], a, 16);
    w.b[l][0] = b0;
    w.b[l][1] = b1;
    w.bar.arrive_and_wait();
    float out[4];
    for (int e = 0; e < 4; ++e) {
      const int r = l / 4 + 8 * (e >> 1), n = 2 * (l % 4) + (e & 1);
      float s = 0.f;
      for (int k = 0; k < 16; ++k)
        s += repro_half_bits<T>(
                 w.a[(r % 8) * 4 + (k % 8) / 2][(r >= 8) + 2 * (k >= 8)], k) *
             repro_half_bits<T>(w.b[n * 4 + (k % 8) / 2][k >= 8], k);
      out[e] = c[e] + s;
    }
    w.bar.arrive_and_wait();
    for (int e = 0; e < 4; ++e) c[e] = out[e];
  }
  static uint32_t pack(float lo, float hi) {
    return from_f32<T>(lo).bits | (uint32_t)from_f32<T>(hi).bits << 16;
  }
};

// ---- launches
inline thread_local std::barrier<>* repro_host_bar;
inline thread_local unsigned char* repro_host_smem;
#define __syncthreads() repro_host_bar->arrive_and_wait()
#define BWD_SMEM(name) unsigned char* name = repro_host_smem
#define BWD_LAUNCH(kern, grid, block, smem, stream, ...) \
  repro_host_launch(grid, block, smem, [=] { kern(__VA_ARGS__); })

// ---- thread block clusters along z (CLUSTER_Z_LAUNCH): a cluster's
// blocks run at once, each with its own shared memory, barrier and
// warps; cluster_sync() meets every thread of the cluster and
// cluster_peer() maps an address of this block's shared memory to the
// same offset in another block's (distributed shared memory)
inline thread_local unsigned char* const* repro_cluster_smem;
inline thread_local unsigned repro_cluster_rank, repro_cluster_size;
inline thread_local std::barrier<>* repro_cluster_bar;
#define CLUSTER_Z_LAUNCH(kern, grid, block, smem, stream, cz, ...) \
  (repro_host_launch(grid, block, smem, [=] { kern(__VA_ARGS__); }, cz), 0)
inline unsigned cluster_rank() { return repro_cluster_rank; }
inline unsigned cluster_size() { return repro_cluster_size; }
inline void cluster_sync() { repro_cluster_bar->arrive_and_wait(); }
template <typename T>
inline const T* cluster_peer(const T* p, unsigned rank) {
  return reinterpret_cast<const T*>(
      repro_cluster_smem[rank] +
      (reinterpret_cast<const unsigned char*>(p) - repro_host_smem));
}

// the grid's clusters (cz blocks along z; 1: every block alone) one
// after another
template <typename F>
void repro_host_launch(dim3 grid, dim3 block, size_t smem, F fn,
                       unsigned cz = 1) {
  gridDim = grid;
  blockDim = block;
  const unsigned nw = (block.x + 31) / 32;
  std::vector<std::vector<float>> bufs(cz, std::vector<float>(smem / 4 + 1));
  std::vector<unsigned char*> bases(cz);
  std::unique_ptr<ReproWarp[]> warps(new ReproWarp[nw * cz]);
  for (unsigned bz = 0; bz < grid.z; bz += cz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::vector<std::unique_ptr<std::barrier<>>> bars;
        for (unsigned c = 0; c < cz; ++c) {
          for (auto& w : bufs[c]) w = NAN;
          bases[c] = reinterpret_cast<unsigned char*>(bufs[c].data());
          bars.emplace_back(new std::barrier<>(block.x));
        }
        std::barrier<> cluster_bar(block.x * cz);
        std::vector<std::thread> ts;
        for (unsigned c = 0; c < cz; ++c)
          for (unsigned t = 0; t < block.x; ++t)
            ts.emplace_back([&, c, t] {
              threadIdx = dim3(t);
              blockIdx = dim3(bx, by, bz + c);
              repro_host_bar = bars[c].get();
              repro_host_smem = bases[c];
              repro_host_warps = warps.get() + nw * c;
              repro_cluster_smem = bases.data();
              repro_cluster_rank = c;
              repro_cluster_size = cz;
              repro_cluster_bar = &cluster_bar;
              fn();
            });
        for (auto& th : ts) th.join();
      }
}
