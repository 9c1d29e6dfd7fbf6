// Mamba2 SSD scan for Hopper (sm_90a): the prefill of every SSM layer.
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py
// (`mamba_chunk_scan`, body `_ms_kernel`): x [Bt,S,H,P], dt [Bt,S,H]
// f32, A/D [H] f32, B/C [Bt,S,N] (one group, shared by every head),
// optional initial state [Bt,H,P,N] f32 -> y [Bt,S,H,P] in x's dtype
// and the final state [Bt,H,P,N] f32, the function of
// `mamba_chunk_scan_naive`:
//   state_t = exp(dt_t A) state_{t-1} + dt_t x_t B_t^T,
//   y_t     = state_t C_t + D x_t.
//
// What bounds it here: bytes, at the card's bf16 rates. The recurrence
// does ~4 flops per state element per token, H*P*N elements, against
// 2*H*P + 2*N values in or out per token: at the serving shape (S=1024,
// H=64, P=64, N=128, bf16) 2.1 GFLOP against 17 MB, ~124 flops per
// byte, under the tensor cores' ridge (~295), so the floor is streaming
// x in and y out once (~5 us). The same flops on the CUDA cores in f32
// (67 TFLOP/s, ridge ~20 flops per byte) take >= 32 us: this first
// version is bound by its f32 instruction rate, not by memory.
//
// What the design does about it, in this first version: the TPU kernel
// uses the chunked SSD form, which turns the scan into (chunk x chunk)
// and (chunk x N) matrix products for the MXU at ~4x the flops of the
// recurrence. On CUDA cores without wgmma that trade does not pay, so
// this kernel runs the recurrence itself, which is also the oracle's
// arithmetic. A row p of the state depends only on x[..., p], so the
// state is split by rows across blocks: one block per (batch, head,
// 32-row slice of P), 4 threads per row, each thread holding N/4
// columns of its row in registers for the whole sequence (no state
// traffic at all until the final store). Tokens are staged 64 at a
// time in shared memory (B, C, x converted to f32, and the per-token
// decay exp(dt A)); B and C come in as 16-byte vector loads, all of a
// tile's loads in flight before the first store (a first version with
// scalar loads in a runtime-bounded loop spent about half its time
// waiting on them), and are read as float4 broadcasts, interleaved
// so the 4 threads of a row hit distinct banks. y of a row is a sum
// over N: each thread's partial sum is combined with two shuffles. The
// y tile goes back through shared memory so the stores are coalesced.
// Any S >= 1 works: the last tile is simply shorter, so a ragged or
// short prompt needs no padding (and no dt = 0 masking, which the
// chunked form would need). The chunk size of the reference does not
// enter: the result is the sequential recurrence's up to the order of
// the N-sum. Tensor-core (wgmma) chunked SSD is the known next step.
// Built for d_state 16 (the smoke configuration) and 128 (mamba2-1.3b),
// in f32 and bf16, the engine's compute dtypes.
#include "common.cuh"

constexpr int kRows = 32;     // state rows (of P) per block
constexpr int kTpr = 4;       // threads per row
constexpr int kTile = 64;     // tokens staged in shared memory per step
constexpr int kThreads = kRows * kTpr;

// 16 bytes of T -> 16 / sizeof(T) floats at dst (16-byte aligned)
template <typename T>
__device__ __forceinline__ void unpack_f32(uint4 v, float* dst);
template <>
__device__ __forceinline__ void unpack_f32<float>(uint4 v, float* dst) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                  __uint_as_float(v.z), __uint_as_float(v.w));
}
template <typename H2>
__device__ __forceinline__ void unpack_pairs(uint4 v, float* dst) {
  const H2* h = reinterpret_cast<const H2*>(&v);
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = to_f32(h[i].x);
    f[2 * i + 1] = to_f32(h[i].y);
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
template <>
__device__ __forceinline__ void unpack_f32<__nv_bfloat16>(uint4 v,
                                                          float* dst) {
  unpack_pairs<__nv_bfloat162>(v, dst);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ s0, T* __restrict__ y,
    float* __restrict__ fin, int S, int H, int P) {
  constexpr int kCols = N / kTpr;      // state columns per thread
  constexpr int kVec = kCols / 4;      // float4 groups per thread
  constexpr int kPerVec = 16 / sizeof(T);             // values per uint4
  constexpr int kVecLoads = kTile * N / kPerVec / kThreads;
  // loads in flight per matrix (registers: 4 per uint4)
  constexpr int kBatch = kVecLoads < 8 ? kVecLoads : 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sB = smem;                    // [kTile][N]
  float* sC = sB + kTile * N;          // [kTile][N]
  float* sX = sC + kTile * N;          // [kTile][kRows]
  float* sY = sX + kTile * kRows;      // [kTile][kRows]
  float* sDa = sY + kTile * kRows;     // [kTile] exp(dt A)
  float* sDt = sDa + kTile;            // [kTile] dt

  const int p0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x / kTpr, g = threadIdx.x % kTpr;
  const int p = p0 + r;
  const bool live = p < P;
  const int rows = min(kRows, P - p0);
  const float a = A[h], dskip = D[h];

  // this thread's columns: float4 groups q = g + kTpr * j, i.e. columns
  // 4q .. 4q+3, so the 4 threads of a row read 4 consecutive float4s
  float st[kCols];
  const size_t sbase = (((size_t)b * H + h) * P + p) * N;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = 4 * (g + kTpr * j);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st[4 * j + i] = (s0 != nullptr && live) ? s0[sbase + c + i] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int L = min(kTile, S - t0);
    __syncthreads();  // the previous tile's y is written out
    // B and C: L*N contiguous values each, moved as 16-byte vectors;
    // the trip counts are compile-time, so every load of a tile is in
    // flight before the first store
    const size_t bc = ((size_t)b * S + t0) * N;
    const uint4* gB = reinterpret_cast<const uint4*>(Bm + bc);
    const uint4* gC = reinterpret_cast<const uint4*>(Cm + bc);
    const int n_vec = L * N / kPerVec;
#pragma unroll
    for (int k0 = 0; k0 < kVecLoads; k0 += kBatch) {
      uint4 vb[kBatch], vc[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = threadIdx.x + (k0 + k) * kThreads;
        if (i < n_vec) {
          vb[k] = gB[i];
          vc[k] = gC[i];
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = threadIdx.x + (k0 + k) * kThreads;
        if (i < n_vec) {
          unpack_f32<T>(vb[k], sB + i * kPerVec);
          unpack_f32<T>(vc[k], sC + i * kPerVec);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kTile * kRows / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int t = i / kRows, rr = i % kRows;
      if (t < L && rr < rows)
        sX[i] = to_f32(x[(((size_t)b * S + t0 + t) * H + h) * P + p0 + rr]);
    }
    for (int t = threadIdx.x; t < L; t += kThreads) {
      const float d = dt[((size_t)b * S + t0 + t) * H + h];
      sDt[t] = d;
      sDa[t] = expf(d * a);
    }
    __syncthreads();

    const float4* sB4 = reinterpret_cast<const float4*>(sB);
    const float4* sC4 = reinterpret_cast<const float4*>(sC);
    for (int t = 0; t < L; ++t) {
      const float da = sDa[t];
      const float xv = sX[t * kRows + r];
      const float dtx = sDt[t] * xv;
      // four partial sums, so the N-sum is not one serial FMA chain
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int q = t * (N / 4) + g + kTpr * j;
        const float4 bv = sB4[q];
        const float4 cv = sC4[q];
        st[4 * j + 0] = st[4 * j + 0] * da + dtx * bv.x;
        st[4 * j + 1] = st[4 * j + 1] * da + dtx * bv.y;
        st[4 * j + 2] = st[4 * j + 2] * da + dtx * bv.z;
        st[4 * j + 3] = st[4 * j + 3] * da + dtx * bv.w;
        a0 += st[4 * j + 0] * cv.x;
        a1 += st[4 * j + 1] * cv.y;
        a2 += st[4 * j + 2] * cv.z;
        a3 += st[4 * j + 3] * cv.w;
      }
      float acc = (a0 + a1) + (a2 + a3);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (g == 0) sY[t * kRows + r] = acc + dskip * xv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < L * rows; i += kThreads) {
      const int t = i / rows, rr = i % rows;
      y[(((size_t)b * S + t0 + t) * H + h) * P + p0 + rr] =
          from_f32<T>(sY[t * kRows + rr]);
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = 4 * (g + kTpr * j);
      float4 v = make_float4(st[4 * j], st[4 * j + 1], st[4 * j + 2],
                             st[4 * j + 3]);
      *reinterpret_cast<float4*>(fin + sbase + c) = v;
    }
  }
}

static size_t smem_bytes(int N) {
  return sizeof(float) *
         ((size_t)2 * kTile * N + (size_t)2 * kTile * kRows + 2 * kTile);
}

template <typename T, int N>
static int launch_n(const void* x, const void* dt, const void* A,
                    const void* B, const void* C, const void* D,
                    const void* s0, void* y, void* fin, int Bt, int S,
                    int H, int P, cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + kRows - 1) / kRows, H, Bt);
  mamba_scan_kernel<T, N><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (const float*)D, (const float*)s0, (T*)y, (float*)fin,
      S, H, P);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* x, const void* dt, const void* A,
                  const void* B, const void* C, const void* D,
                  const void* s0, void* y, void* fin, int Bt, int S, int H,
                  int P, int N, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch_n<T, 16>(x, dt, A, B, C, D, s0, y, fin, Bt, S, H, P,
                             stream);
    case 128:
      return launch_n<T, 128>(x, dt, A, B, C, D, s0, y, fin, Bt, S, H, P,
                              stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int mamba_scan_launch(const void* x, const void* dt,
                                 const void* A, const void* B, const void* C,
                                 const void* D, const void* s0, void* y,
                                 void* fin, int Bt, int S, int H, int P,
                                 int N, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return launch<float>(x, dt, A, B, C, D, s0, y, fin, Bt, S, H, P, N, s);
    case kBF16:
      return launch<__nv_bfloat16>(x, dt, A, B, C, D, s0, y, fin, Bt, S, H,
                                   P, N, s);
  }
  return (int)cudaErrorInvalidValue;
}
