// Causal / sliding-window / softcapped GQA flash attention for Hopper
// (sm_90a): the prefill attention of the serving path.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (`flash_attention`, body `_fa_kernel`): q [B,Sq,H,D] over k/v
// [B,Skv,KV,D] -> [B,Sq,H,D], causal masking right-aligned (query row i
// sits at position i + Skv - Sq), optional window, softcap and
// bidirectional attention, KV head = h // (H/KV), float32 statistics.
//
// What bounds it here: arithmetic. Causal prefill does ~2*Sq*Skv*D
// multiply-adds per head (about half of them masked away by the tile
// skip), which at Sq = Skv = 1024 is hundreds of flops per byte moved,
// so the work belongs on the tensor cores (989 TFLOP/s bf16 dense).
//
// What the design does about it, in this first version: one block per
// (batch, q head, 64-row q tile), one thread per query row, with the
// row's scaled q and its float32 accumulator in registers. K/V tiles of
// 64 (32 at D=128) rows are staged once per block in shared memory and
// read by every thread as broadcasts, so each K/V byte is loaded from
// device memory once per q tile. Tiles wholly past the causal frontier
// or below the window are never loaded (the Pallas kernel's skipped
// grid steps), and positions >= Skv are masked, so prompt lengths need
// no padding. The softmax is online per key: the accumulator is
// rescaled only when a row's running max grows. The arithmetic runs on
// the CUDA cores in float32, far below the tensor-core peak;
// mma.sync/wgmma tiles with TMA loads are the known next step. A row
// with no valid key (only possible when Sq > Skv) returns 0.
#include "common.cuh"

constexpr int kBQ = 64;  // query rows per block, one per thread

template <typename T, int D>
__global__ void flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv, int H,
    int KV, float scale, float softcap, int window, int causal,
    int q_offset) {
  constexpr int BK = D <= 64 ? 64 : 32;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int r0 = blockIdx.x * kBQ;
  const int row = r0 + threadIdx.x;
  const bool live_row = row < Sq;
  const int qpos = q_offset + row;

  float qr[D], acc[D];
  if (live_row) {
    const T* qp = q + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f32(qp[d]) * scale;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = REPRO_NEG_INF, l = 0.f;

  // KV tiles this q tile can see
  const int r_last = min(r0 + kBQ, Sq) - 1;
  const int hi_pos = causal ? min(Skv - 1, q_offset + r_last) : Skv - 1;
  const int lo_pos = window > 0 ? max(0, q_offset + r0 - window + 1) : 0;
  const int kt_lo = lo_pos / BK;
  const int kt_hi = hi_pos < 0 ? -1 : hi_pos / BK;
  // this row's valid keys: [k_lo, k_hi]
  const int k_hi = causal ? min(Skv - 1, qpos) : Skv - 1;
  const int k_lo = window > 0 ? qpos - window + 1 : 0;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    const int nk = min(BK, Skv - k0);
    __syncthreads();  // previous tile fully consumed
    for (int idx = threadIdx.x; idx < nk * D; idx += kBQ) {
      const int t = idx / D, d = idx - t * D;
      const size_t off = (((size_t)b * Skv + k0 + t) * KV + kvh) * D + d;
      ks[t][d] = to_f32(k[off]);
      vs[t][d] = to_f32(v[off]);
    }
    __syncthreads();
    if (!live_row) continue;
    const int t_lo = max(0, k_lo - k0);
    const int t_hi = min(nk - 1, k_hi - k0);
    for (int t = t_lo; t <= t_hi; ++t) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s += qr[d] * ks[t][d];
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      if (s > m) {
        const float a = expf(m - s);
        l *= a;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= a;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += p * vs[t][d];
    }
  }
  if (live_row) {
    T* op = out + (((size_t)b * Sq + row) * H + h) * D;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T, int D>
static int launch_d(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Skv, int H, int KV, float scale,
                    float softcap, int window, int causal,
                    cudaStream_t stream) {
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, D><<<grid, kBQ, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, H, KV, scale,
      softcap, window, causal, Skv - Sq);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int Sq, int Skv, int H, int KV, int D, float scale,
                  float softcap, int window, int causal,
                  cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, out, B, Sq, Skv, H, KV, scale, softcap,
                             window, causal, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, out, B, Sq, Skv, H, KV, scale, softcap,
                             window, causal, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, scale, softcap,
                             window, causal, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, scale,
                              softcap, window, causal, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Skv, int H, int KV, int D, float scale, float softcap, int window,
    int causal, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return launch<float>(q, k, v, out, B, Sq, Skv, H, KV, D, scale,
                           softcap, window, causal, s);
    case kBF16:
      return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, D, scale,
                                   softcap, window, causal, s);
    case kF16:
      return launch<__half>(q, k, v, out, B, Sq, Skv, H, KV, D, scale,
                            softcap, window, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
