// One-token GQA decode attention over a paged KV pool, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (`paged_attention`, body `_pa_kernel`): q [B,H,D] against pools
// [NB,P,KV,D] read through block_table [B,MAXP] up to ctx_lens [B],
// online softmax in float32, optional logit softcap and sliding window,
// optional (m, l) statistics.
//
// What bounds it here: device-memory bytes. Each live page's K and V
// rows of one KV head are read once, and the arithmetic is 4*G*D
// flops per cached token (G = H/KV query heads per KV head), far below
// the ~295 flop/byte at which the H100's tensor cores would bind. At
// 8 slots x 1024 tokens, KV=8, D=64, bf16 that is 16.8 MB per layer,
// ~5 us at 3.35 TB/s.
//
// What the design does about it: one block per (sequence, KV head)
// loads its own block-table row and walks only the live pages (i*P <
// ctx and, with a window, (i+1)*P > ctx - window), so dead pages cost
// no bytes. The G query heads that share a KV head are served from
// one load of each K/V tile (GQA reuse), staged in shared memory as
// float32 with a padded row stride so the per-token dot products are
// bank-conflict free. Pages are consumed in tiles of up to 64 tokens,
// so page sizes 8..256 and head_dim 16..128 fit. A lane with ctx 0
// walks no page and returns 0 with m = -1e30, l = 0, as the Pallas
// kernel does. This first version does scalar loads with one
// __syncthreads per tile; wider loads and more blocks per sequence
// (split-K over pages) are the known next steps.
#include "common.cuh"

template <typename T>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ ctx_lens, T* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int H, int KV,
    int D, int P, int maxp, int tile, float scale, float softcap,
    int window) {
  const int G = H / KV;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int KS = D + 1;  // padded K/V row stride (bank conflicts)
  extern __shared__ float sm[];
  float* qs = sm;                  // [G, D]
  float* acc = qs + G * D;         // [G, D]
  float* ks = acc + G * D;         // [tile, KS]
  float* vs = ks + tile * KS;      // [tile, KS]
  float* ss = vs + tile * KS;      // [G, tile] scores, then weights
  float* mrow = ss + G * tile;     // [G]
  float* lrow = mrow + G;          // [G]
  float* alpha = lrow + G;         // [G]
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;

  const size_t qbase = ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += nth) {
    qs[i] = to_f32(q[qbase + i]) * scale;
    acc[i] = 0.f;
  }
  if (tid < G) {
    mrow[tid] = REPRO_NEG_INF;
    lrow[tid] = 0.f;
  }
  const int ctx = ctx_lens[b];
  const int lo = ctx - window;  // first in-window position (window > 0)
  const int first = (window > 0 && lo > 0) ? lo / P : 0;
  const int last = min((ctx + P - 1) / P, maxp);
  __syncthreads();

  for (int i = first; i < last; ++i) {
    const size_t blk = (size_t)table[(size_t)b * maxp + i];
    const int live = min(P, ctx - i * P);  // positions below ctx
    for (int t0 = 0; t0 < live; t0 += tile) {
      const int nt = min(tile, live - t0);
      for (int idx = tid; idx < nt * D; idx += nth) {
        const int t = idx / D, d = idx - t * D;
        const size_t off = ((blk * P + t0 + t) * KV + kvh) * D + d;
        ks[t * KS + d] = to_f32(k_pool[off]);
        vs[t * KS + d] = to_f32(v_pool[off]);
      }
      __syncthreads();
      for (int idx = tid; idx < G * nt; idx += nth) {
        const int g = idx / nt, t = idx - g * nt;
        const float* qg = qs + g * D;
        const float* kt = ks + t * KS;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += qg[d] * kt[d];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        ss[g * tile + t] = s;
      }
      __syncthreads();
      for (int g = warp; g < G; g += nwarps) {
        float mx = REPRO_NEG_INF;
        for (int t = lane; t < nt; t += 32) {
          const int pos = i * P + t0 + t;
          if (window <= 0 || pos >= lo) mx = fmaxf(mx, ss[g * tile + t]);
        }
        mx = warp_max(mx);
        const float m_old = mrow[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int t = lane; t < nt; t += 32) {
          const int pos = i * P + t0 + t;
          const bool ok = window <= 0 || pos >= lo;
          const float p = ok ? expf(ss[g * tile + t] - m_new) : 0.f;
          ss[g * tile + t] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float a = expf(m_old - m_new);
          alpha[g] = a;
          lrow[g] = lrow[g] * a + sum;
          mrow[g] = m_new;
        }
      }
      __syncthreads();
      for (int idx = tid; idx < G * D; idx += nth) {
        const int g = idx / D, d = idx - g * D;
        const float* pg = ss + g * tile;
        float pv = 0.f;
        for (int t = 0; t < nt; ++t) pv += pg[t] * vs[t * KS + d];
        acc[idx] = acc[idx] * alpha[g] + pv;
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < G * D; i += nth)
    out[qbase + i] = from_f32<T>(acc[i] / fmaxf(lrow[i / D], 1e-30f));
  if (m_out != nullptr && tid < G) {
    m_out[(size_t)b * H + kvh * G + tid] = mrow[tid];
    l_out[(size_t)b * H + kvh * G + tid] = lrow[tid];
  }
}

template <typename T>
static int launch(const void* q, const void* k_pool, const void* v_pool,
                  const void* table, const void* ctx_lens, void* out,
                  void* m_out, void* l_out, int B, int H, int KV, int D,
                  int P, int maxp, float scale, float softcap, int window,
                  cudaStream_t stream) {
  const int G = H / KV;
  const int tile = P < 64 ? P : 64;
  const size_t smem = sizeof(float) *
      ((size_t)2 * G * D + 2 * (size_t)tile * (D + 1) + (size_t)G * tile +
       3 * G);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_attention_kernel<T><<<dim3(KV, B), 128, smem, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int*)table,
      (const int*)ctx_lens, (T*)out, (float*)m_out, (float*)l_out, H, KV, D,
      P, maxp, tile, scale, softcap, window);
  return (int)cudaGetLastError();
}

extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* table, const void* ctx_lens, void* out, void* m_out,
    void* l_out, int B, int H, int KV, int D, int P, int maxp, float scale,
    float softcap, int window, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return launch<float>(q, k_pool, v_pool, table, ctx_lens, out, m_out,
                           l_out, B, H, KV, D, P, maxp, scale, softcap,
                           window, s);
    case kBF16:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, table, ctx_lens, out,
                                   m_out, l_out, B, H, KV, D, P, maxp, scale,
                                   softcap, window, s);
    case kF16:
      return launch<__half>(q, k_pool, v_pool, table, ctx_lens, out, m_out,
                            l_out, B, H, KV, D, P, maxp, scale, softcap,
                            window, s);
  }
  return (int)cudaErrorInvalidValue;
}
