// The backward pass of the causal / sliding-window / softcapped /
// segmented GQA flash attention (flash_attention.cu) for Hopper
// (sm_90a): the training path's attention gradient.
//
// Replaces the gradient the reference takes with jax.grad through its
// blocked jnp lowering of repro/kernels/flash_attention.py's function
// (repro/kernels/ops.py sends packed segment ids there, ref.py's
// flash_attention_blocked); the Pallas kernel has no backward. Given q
// [B,Sq,H,D], k/v [B,Skv,KV,D], the forward's out [B,Sq,H,D] and row
// log-sum-exp lse [B,H,Sq] (float32, scaled softcapped logits, -inf for
// a row with no valid key), and dout [B,Sq,H,D]:
//   P = exp(softcap(scale q k^T) - lse) on the visible pairs,
//   delta = rowsum(dout * out), dP = dout v^T,
//   dS = P * (dP - delta) * (1 - tanh^2) (the softcap's derivative),
//   dq = scale dS k, dk = scale dS^T q, dv = P^T dout,
// dk and dv summed over each KV head's G query heads. The mask is the
// forward's: causal right-aligned (query row i at position i + Skv -
// Sq), window, segment ids seg_q [B,Sq] / seg_k [B,Skv] (null: none). A
// row with no valid key (its output is 0) has zero gradient and adds
// nothing to dk / dv.
//
// What bounds it: arithmetic. Five products over the visible (q, k)
// pairs (Q K^T and dO V^T recomputed in both kernels, then dS K, P^T dO
// and dS^T Q): at the training shape (B 8, S 1024, H 32, D 64, causal)
// ~86 GFLOP a layer against ~40 MB moved. This first version runs them
// on the CUDA cores in float32 (inputs of any type are staged as f32),
// which bounds it far above the tensor cores' time; mma.sync / wgmma
// bodies as in the forward are later work.
//
// Two kernels, deterministic: each output element is written once by
// one thread, with no float atomics, so repeated calls are
// bit-identical.
// - dq: one block per (b, head, 64-row query tile), TPR threads per
//   row (each holding D / TPR elements of its q, dout and dq in
//   registers). The row's delta is reduced here and written to scratch
//   for the second kernel. It walks the key tiles the tile can see (the
//   forward's skip of tiles past the causal frontier or below the
//   window), staging each tile's K, V and key segment ids in shared
//   memory, recomputes s and p per key and accumulates dq in f32.
// - dk/dv: one block per (b, KV head, 64-row key tile), TPR threads
//   per key row (its k, v, dk, dv in registers). It walks the group's G
//   query heads and, for each, the query tiles that can see the key
//   tile, staging Q (pre-scaled), dO, lse, delta and the query segment
//   ids, and accumulates dk and dv; GQA needs no reduction across
//   blocks. It runs after the dq kernel on the same stream (delta).
#include "common.cuh"

// threads per row: a row's D elements in chunks of 32 a thread (all D
// at D <= 32), interleaved (element part + TPR * i) so the threads of a
// row read distinct banks of a staged row
template <int D>
__host__ __device__ constexpr int bwd_tpr() { return D <= 32 ? 1 : D / 32; }
// rows (queries or keys) a block owns: 64, 32 at D = 256 (so a block
// of 256 threads keeps up to 255 registers a thread)
template <int D>
__host__ __device__ constexpr int bwd_rows() { return D >= 256 ? 32 : 64; }
// rows of a staged tile: two [tile][D] float arrays in 32 KB
template <int D>
__host__ __device__ constexpr int bwd_tile() {
  return D <= 64 ? 64 : D <= 128 ? 32 : 16;
}

// a row with no valid key has lse = -inf
__device__ __forceinline__ bool has_keys(float lse) { return lse > -3.0e38f; }

template <int TPR>
__device__ __forceinline__ float group_sum(float x, unsigned group) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(group, x, o);
  return x;
}

template <int TPR>
__device__ __forceinline__ unsigned group_mask() {
  return TPR >= 32 ? 0xffffffffu
                   : ((1u << TPR) - 1u) << ((threadIdx.x & 31) & ~(TPR - 1));
}

// p and dS of one visible pair from the raw scaled logit s and dp
__device__ __forceinline__ void pair_grads(float s, float dp, float lse,
                                           float delta, float softcap,
                                           float* p, float* ds) {
  float deriv = 1.f;
  if (softcap > 0.f) {
    const float c = tanhf(s / softcap);
    s = softcap * c;
    deriv = 1.f - c * c;
  }
  *p = expf(s - lse);
  *ds = *p * (dp - delta) * deriv;
}

template <typename T, int D>
__global__ void __launch_bounds__(bwd_rows<D>() * bwd_tpr<D>())
    flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ out,
    const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k, int Sq,
    int Skv, int H, int KV, float scale, float softcap, int window,
    int causal, int q_offset) {
  constexpr int TPR = bwd_tpr<D>(), DP = D / TPR, ROWS = bwd_rows<D>();
  constexpr int NT = ROWS * TPR, BK = bwd_tile<D>();
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  __shared__ int segs[BK];
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int r0 = blockIdx.x * ROWS;
  const int row = r0 + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const unsigned group = group_mask<TPR>();
  const bool live_row = row < Sq;
  const int qpos = q_offset + row;
  const int* sk = seg_k ? seg_k + (size_t)b * Skv : nullptr;
  const int seg_row = sk && live_row ? seg_q[(size_t)b * Sq + row] : 0;
  const size_t stat = ((size_t)b * H + h) * Sq + row;

  float qr[DP], dor[DP], acc[DP];
  float lse_r = REPRO_MASKED, dl = 0.f;
#pragma unroll
  for (int i = 0; i < DP; ++i) acc[i] = 0.f;
  if (live_row) {
    const size_t base = (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      const int d = part + TPR * i;
      qr[i] = to_f32(q[base + d]) * scale;
      dor[i] = to_f32(dout[base + d]);
      dl += dor[i] * to_f32(out[base + d]);
    }
    dl = group_sum<TPR>(dl, group);
    lse_r = lse[stat];
    if (part == 0) delta[stat] = dl;
  }
  const bool active = live_row && has_keys(lse_r);

  // key tiles this query tile can see (the forward's)
  const int r_last = min(r0 + ROWS, Sq) - 1;
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
    for (int idx = threadIdx.x; idx < nk * D; idx += NT) {
      const int t = idx / D, d = idx - t * D;
      const size_t off = (((size_t)b * Skv + k0 + t) * KV + kvh) * D + d;
      ks[t][d] = to_f32(k[off]);
      vs[t][d] = to_f32(v[off]);
    }
    if (sk)
      for (int t = threadIdx.x; t < nk; t += NT) segs[t] = sk[k0 + t];
    __syncthreads();
    if (!active) continue;
    const int t_lo = max(0, k_lo - k0);
    const int t_hi = min(nk - 1, k_hi - k0);
    for (int t = t_lo; t <= t_hi; ++t) {
      if (sk && segs[t] != seg_row) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        s += qr[i] * ks[t][part + TPR * i];
        dp += dor[i] * vs[t][part + TPR * i];
      }
      s = group_sum<TPR>(s, group);
      dp = group_sum<TPR>(dp, group);
      float p, ds;
      pair_grads(s, dp, lse_r, dl, softcap, &p, &ds);
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] += ds * ks[t][part + TPR * i];
    }
  }
  if (live_row) {
    T* op = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i)
      op[part + TPR * i] = from_f32<T>(acc[i] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(bwd_rows<D>() * bwd_tpr<D>())
    flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, int Sq, int Skv, int H, int KV,
    float scale, float softcap, int window, int causal, int q_offset) {
  constexpr int TPR = bwd_tpr<D>(), DP = D / TPR, ROWS = bwd_rows<D>();
  constexpr int NT = ROWS * TPR, BQ = bwd_tile<D>();
  __shared__ float qs[BQ][D];   // q * scale
  __shared__ float dos[BQ][D];
  __shared__ float lses[BQ], dels[BQ];
  __shared__ int segs[BQ];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int c0 = blockIdx.x * ROWS;
  const int key = c0 + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const unsigned group = group_mask<TPR>();
  const bool live_key = key < Skv;
  const int* sq = seg_q ? seg_q + (size_t)b * Sq : nullptr;
  const int seg_key = sq && live_key ? seg_k[(size_t)b * Skv + key] : 0;

  float kr[DP], vr[DP], dkr[DP], dvr[DP];
  const size_t kbase = (((size_t)b * Skv + key) * KV + kvh) * D;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    dkr[i] = dvr[i] = 0.f;
    kr[i] = live_key ? to_f32(k[kbase + part + TPR * i]) : 0.f;
    vr[i] = live_key ? to_f32(v[kbase + part + TPR * i]) : 0.f;
  }
  // query rows that can see a key of this tile: [i_lo, i_hi]
  const int c_last = min(c0 + ROWS, Skv) - 1;
  const int i_lo = causal ? max(0, c0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(Sq - 1, c_last + window - 1 - q_offset)
                              : Sq - 1;
  // this key's query rows: causal qpos >= key, window qpos < key + window
  const int q_lo = causal ? key - q_offset : 0;
  const int q_hi = window > 0 ? key + window - 1 - q_offset : Sq - 1;

  if (i_lo <= i_hi) {
    const int qt_lo = i_lo / BQ, qt_hi = i_hi / BQ;
    for (int g = 0; g < G; ++g) {
      const int h = kvh * G + g;
      const float* lh = lse + ((size_t)b * H + h) * Sq;
      const float* dh = delta + ((size_t)b * H + h) * Sq;
      for (int qt = qt_lo; qt <= qt_hi; ++qt) {
        const int i0 = qt * BQ;
        const int nq = min(BQ, Sq - i0);
        __syncthreads();  // previous tile fully consumed
        for (int idx = threadIdx.x; idx < nq * D; idx += NT) {
          const int t = idx / D, d = idx - t * D;
          const size_t off = (((size_t)b * Sq + i0 + t) * H + h) * D + d;
          qs[t][d] = to_f32(q[off]) * scale;
          dos[t][d] = to_f32(dout[off]);
        }
        for (int t = threadIdx.x; t < nq; t += NT) {
          lses[t] = lh[i0 + t];
          dels[t] = dh[i0 + t];
          if (sq) segs[t] = sq[i0 + t];
        }
        __syncthreads();
        if (!live_key) continue;
        const int t_lo = max(0, q_lo - i0);
        const int t_hi = min(nq - 1, q_hi - i0);
        for (int t = t_lo; t <= t_hi; ++t) {
          if ((sq && segs[t] != seg_key) || !has_keys(lses[t])) continue;
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int i = 0; i < DP; ++i) {
            s += kr[i] * qs[t][part + TPR * i];
            dp += vr[i] * dos[t][part + TPR * i];
          }
          s = group_sum<TPR>(s, group);
          dp = group_sum<TPR>(dp, group);
          float p, ds;
          pair_grads(s, dp, lses[t], dels[t], softcap, &p, &ds);
#pragma unroll
          for (int i = 0; i < DP; ++i) {
            dvr[i] += p * dos[t][part + TPR * i];
            dkr[i] += ds * qs[t][part + TPR * i];
          }
        }
      }
    }
  }
  if (live_key) {
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      dk[kbase + part + TPR * i] = from_f32<T>(dkr[i]);
      dv[kbase + part + TPR * i] = from_f32<T>(dvr[i]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  const int *seg_q, *seg_k;
  int B, Sq, Skv, H, KV;
  float scale, softcap;
  int window, causal;
  cudaStream_t stream;
};

template <typename T, int D>
static int launch_d(const BwdArgs& a) {
  constexpr int rows = bwd_rows<D>(), threads = rows * bwd_tpr<D>();
  const int q_offset = a.Skv - a.Sq;
  dim3 gq((a.Sq + rows - 1) / rows, a.H, a.B);
  flash_bwd_dq_kernel<T, D><<<gq, threads, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.out,
      (const T*)a.dout, a.lse, a.delta, (T*)a.dq, a.seg_q, a.seg_k, a.Sq,
      a.Skv, a.H, a.KV, a.scale, a.softcap, a.window, a.causal, q_offset);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 gk((a.Skv + rows - 1) / rows, a.KV, a.B);
  flash_bwd_dkdv_kernel<T, D><<<gk, threads, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.dk, (T*)a.dv, a.seg_q, a.seg_k, a.Sq, a.Skv, a.H, a.KV,
      a.scale, a.softcap, a.window, a.causal, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const BwdArgs& a, int D) {
  switch (D) {
    case 16: return launch_d<T, 16>(a);
    case 32: return launch_d<T, 32>(a);
    case 64: return launch_d<T, 64>(a);
    case 128: return launch_d<T, 128>(a);
    case 256: return launch_d<T, 256>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// delta: float32 scratch [B,H,Sq], written by the dq kernel
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const void* seg_q, const void* seg_k, int B, int Sq, int Skv,
    int H, int KV, int D, float scale, float softcap, int window,
    int causal, int dtype, void* stream) {
  if ((seg_q == nullptr) != (seg_k == nullptr))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, out, dout, (const float*)lse, (float*)delta,
                  dq, dk, dv, (const int*)seg_q, (const int*)seg_k, B, Sq,
                  Skv, H, KV, scale, softcap, window, causal,
                  (cudaStream_t)stream};
  switch (dtype) {
    case kF32: return launch<float>(a, D);
    case kBF16: return launch<__nv_bfloat16>(a, D);
    case kF16: return launch<__half>(a, D);
  }
  return (int)cudaErrorInvalidValue;
}
