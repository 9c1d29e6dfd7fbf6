// One-token GQA decode attention over a paged KV pool, for Hopper
// (sm_90a): split-context flash-decoding in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (`paged_attention`, body `_pa_kernel`): q [B,H,D] against pools
// [NB,P,KV,D] read through block_table [B,MAXP] up to ctx_lens [B],
// online softmax in float32, optional logit softcap and sliding window,
// optional (m, l) statistics.
//
// What bounds it: device-memory bytes. Each live K and V row of each KV
// head is read once; the arithmetic is 4*G*D flops per cached token
// (G = H/KV query heads per KV head), ~4 flops per byte at G = 4, far
// below the ~295 at which the tensor cores would bind. At 8 slots x
// 1024 tokens, KV=8, D=64, bf16 that is 16.8 MB per call, ~5 us at
// 3.35 TB/s. Reaching it takes many bytes in flight on every SM, so the
// design is about parallelism and load width, not flops.
//
// What the design does about it:
// - The grid is (KV head x head chunk, sequence, split): the context
//   is cut into n_split ranges of whole pages, chosen on the host from
//   shapes only (never from ctx_lens, so no host sync), the split
//   length not even from the table's width up to 256 splits: at 8
//   slots, 8 pages (128 tokens) a split, so 8 splits and 512 blocks (~4
//   per SM) at 64 pages; a wider table appends splits, and its empty
//   ones add exactly nothing (past 256 splits the host doubles the
//   split length instead, in steps). A block
//   reads its split's block-table entries once into shared memory and
//   serves the G query heads of its KV head from one load of each K/V
//   row (GQA reuse). A split wholly past ctx or below the window loads
//   no row and writes the empty partial (m = -1e30, l = 0); rows below
//   the window and past ctx are never read.
// - K/V rows move in 64-row tiles (32 for f32 at D=128), 16 bytes per
//   thread with cp.async, double-buffered so the next tile is in flight
//   while this one is consumed; rows stay in the input type in shared
//   memory. Two barriers per tile.
// - Compute: D/8 threads per row, 8 elements each (one 16-byte shared
//   load for bf16/f16). The row's dot products reduce by xor shuffles
//   within those lanes. Each row group runs its own online softmax over
//   its rows of the split, rescaling once per 4 rows; the 1024/D streams
//   of a block merge by shuffles and one shared-memory pass at the end.
// - Combine in the same launch: each split writes its partial (o
//   normalised by its own l, m, l) in float32 to scratch; after a
//   barrier one thread fences (cumulative over the block's writes) and
//   takes a ticket from a per-(sequence, head chunk) counter. The block
//   with the last ticket combines all splits in split-index order as
//   one online pass (M = max m_k, w_k = exp(m_k - M) l_k, out =
//   sum w_k o_k / max(sum w_k, 1e-30): the reference's
//   combine_partial_attention, with the max kept running so the loads
//   of a batch of splits do not wait on each other), so the result does
//   not depend on block arrival order and repeated calls are
//   bit-identical; it writes the global (m, l) and resets its counter to
//   0 for the next call. One split needs no combine.
// - A lane with ctx 0 returns 0 with m = -1e30, l = 0, as the Pallas
//   kernel does.
//
// What is left: at the serving shape about half of the time is a fixed
// chain that the bytes do not hide (block-table read, then the K/V
// rows, then partial write, fence, ticket and the combine's loads);
// a thread-block cluster per (sequence, KV head) could combine through
// distributed shared memory instead of global memory. No tensor cores
// (not needed at G <= 8); a TMA box per page could replace the
// per-thread addresses.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kEpt = 8;  // row elements per thread in the compute
constexpr int kMaxSplits = 256;  // the host plan's MAX_SPLITS

// fold one split's partial (m_k, l_k, o_k: o normalised by l_k) into the
// running combine (m, den, num). An empty split (l_k = 0: no live row;
// a live split has l_k >= 1) is skipped, so it adds exactly nothing: a
// lane's result does not depend on how many empty splits its table
// appends, i.e. on the table's width.
__device__ __forceinline__ void fold_split(float& m, float& den, float& num,
                                           float mk, float lk, float ok) {
  if (!(lk > 0.f)) return;
  const float mn = fmaxf(m, mk);
  const float a = __expf(m - mn), w = __expf(mk - mn) * lk;
  den = fmaf(den, a, w);
  num = fmaf(num, a, w * ok);
  m = mn;
}

// K/V rows per tile: 64, or 32 where one stage would pass 32 KB
template <typename T, int D>
__host__ __device__ constexpr int tile_rows() {
  return 2 * D * (int)sizeof(T) * 64 <= 32768 ? 64 : 32;
}

// resident blocks per SM asked of the register allocator: 4 (128
// registers each) where the state fits without spilling, fewer for the
// wider states
template <typename T, int D, int GC>
__host__ __device__ constexpr int min_blocks() {
  return GC >= 8 ? 2 : (D >= 128 || sizeof(T) == 4) ? 3 : 4;
}

template <typename T, int D, int GC>
__global__ void __launch_bounds__(kThreads, min_blocks<T, D, GC>())
    paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ ctx_lens, T* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ part, int* __restrict__ counters, int H, int KV,
    int P, int maxp, int n_split, int pps, float scale, float softcap,
    int window) {
  constexpr int TG = D / kEpt;           // threads per row
  constexpr int TPP = kThreads / TG;     // rows per pass (row groups)
  constexpr int TILE = tile_rows<T, D>();
  constexpr int TPT = TILE / TPP;        // rows per thread per tile
  constexpr int CH = TPT < 4 ? TPT : 4;  // rows per softmax rescale
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CPR = D / VEC;           // 16-byte chunks per row
  static_assert(TILE % TPP == 0 && TPT % CH == 0 &&
                (TILE * CPR) % kThreads == 0, "tile shape");

  const int G = H / KV;
  const int nhc = (G + GC - 1) / GC;
  const int kvh = blockIdx.x / nhc;
  const int hc = blockIdx.x - kvh * nhc;
  const int b = blockIdx.y, split = blockIdx.z;
  const int h0 = kvh * G + hc * GC;
  const int gn = min(GC, G - hc * GC);  // live heads of this chunk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = tid / TG, j = tid % TG;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kbuf = reinterpret_cast<T*>(smem_raw);           // [2][TILE][D]
  T* vbuf = kbuf + 2 * TILE * D;                      // [2][TILE][D]
  float* red_m = reinterpret_cast<float*>(vbuf + 2 * TILE * D);  // [W][GC]
  float* red_l = red_m + kWarps * GC;                 // [W][GC]
  float* red_a = red_l + kWarps * GC;                 // [W][GC][D]
  int* tbl = reinterpret_cast<int*>(red_a + kWarps * GC * D);  // [pps]
  __shared__ int s_last;

  // this split's live rows: [t_begin, t_end)
  const int ctx = ctx_lens[b];
  const int lo = window > 0 ? max(0, ctx - window) : 0;
  const int p0 = split * pps;
  const int s_begin = p0 * P;
  const int t_begin = max(s_begin, lo);
  const int t_end = min(min(s_begin + pps * P, ctx), maxp * P);
  const int ntiles = t_end > t_begin ? (t_end - t_begin + TILE - 1) / TILE
                                     : 0;
  const int npg = min(pps, maxp - p0);
  for (int i = tid; i < npg; i += kThreads)
    tbl[i] = table[(size_t)b * maxp + p0 + i];

  float qr[GC][kEpt], acc[GC][kEpt], m[GC], l[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < gn) {
      load8_f32(q + ((size_t)b * H + h0 + g) * D + j * kEpt, qr[g]);
#pragma unroll
      for (int e = 0; e < kEpt; ++e) qr[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < kEpt; ++e) qr[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kEpt; ++e) acc[g][e] = 0.f;
    m[g] = REPRO_NEG_INF;
    l[g] = 0.f;
  }
  __syncthreads();  // tbl

  auto issue = [&](int kt) {
    const int t0 = t_begin + kt * TILE;
    T* ks = kbuf + (kt & 1) * TILE * D;
    T* vs = vbuf + (kt & 1) * TILE * D;
#pragma unroll
    for (int i = 0; i < TILE * CPR / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / CPR, cc = c - r * CPR;
      const int pos = t0 + r;
      const bool ok = pos < t_end;
      size_t off = 0;
      if (ok) {
        const int pg = pos / P;
        const size_t blk = (size_t)tbl[pg - p0];
        off = ((blk * P + (pos - pg * P)) * KV + kvh) * D + cc * VEC;
      }
      cp_async16(ks + r * D + cc * VEC, k_pool + off, ok);
      cp_async16(vs + r * D + cc * VEC, v_pool + off, ok);
    }
    cp_async_commit();
  };

  if (ntiles > 0) issue(0);
  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles) {
      issue(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = kbuf + (kt & 1) * TILE * D;
    const T* vs = vbuf + (kt & 1) * TILE * D;
    const int t0 = t_begin + kt * TILE;
#pragma unroll
    for (int c0 = 0; c0 < TPT; c0 += CH) {
      float s[CH][GC];
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int r = grp + (c0 + u) * TPP;
        float kr[kEpt];
        load8_f32(ks + r * D + j * kEpt, kr);
        const bool ok = t0 + r < t_end;
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < kEpt; ++e) d = fmaf(qr[g][e], kr[e], d);
#pragma unroll
          for (int o = TG / 2; o > 0; o >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          if (softcap > 0.f) d = softcap * tanhf(d / softcap);
          s[u][g] = ok ? d : REPRO_MASKED;
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < CH; ++u) mx = fmaxf(mx, s[u][g]);
        const float a = __expf(m[g] - mx);
        m[g] = mx;
        l[g] *= a;
#pragma unroll
        for (int e = 0; e < kEpt; ++e) acc[g][e] *= a;
      }
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int r = grp + (c0 + u) * TPP;
        float vr[kEpt];
        load8_f32(vs + r * D + j * kEpt, vr);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float p = __expf(s[u][g] - m[g]);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < kEpt; ++e) acc[g][e] = fmaf(p, vr[e], acc[g][e]);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  // merge the row groups' streams: within a warp by shuffles over the
  // lanes that hold the same row slice, then across warps in shared
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    float mw = m[g];
#pragma unroll
    for (int o = TG; o < 32; o <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
    if (lane == 0) red_m[warp * GC + g] = mw;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    float mb = red_m[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mb = fmaxf(mb, red_m[w * GC + g]);
    const float f = __expf(m[g] - mb);
    float lg = l[g] * f;
#pragma unroll
    for (int o = TG; o < 32; o <<= 1) lg += __shfl_xor_sync(0xffffffffu, lg, o);
#pragma unroll
    for (int e = 0; e < kEpt; ++e) {
      float a = acc[g][e] * f;
#pragma unroll
      for (int o = TG; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane < TG) red_a[(warp * GC + g) * D + j * kEpt + e] = a;
    }
    if (lane == 0) red_l[warp * GC + g] = lg;
  }
  __syncthreads();

  const int nidx = gn * D;
  if (n_split == 1) {
    for (int idx = tid; idx < nidx; idx += kThreads) {
      const int g = idx / D, d = idx - g * D;
      float mb = red_m[g], lb = red_l[g], ab = red_a[g * D + d];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        mb = fmaxf(mb, red_m[w * GC + g]);
        lb += red_l[w * GC + g];
        ab += red_a[(w * GC + g) * D + d];
      }
      // the combine of this one split, as a wider table's launch
      // combines it with empty splits: the same bits at any width
      float m = REPRO_NEG_INF, den = 0.f, num = 0.f;
      fold_split(m, den, num, mb, lb, ab / fmaxf(lb, 1e-30f));
      out[((size_t)b * H + h0 + g) * D + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
      if (m_out != nullptr && d == 0) {
        m_out[(size_t)b * H + h0 + g] = m;
        l_out[(size_t)b * H + h0 + g] = den;
      }
    }
    return;
  }

  // this split's partial: [o (GC x D) | m (GC) | l (GC)] in float32
  const int cell = b * gridDim.x + blockIdx.x;
  constexpr int kStride = GC * (D + 2);
  float* mine = part + ((size_t)cell * n_split + split) * kStride;
  for (int idx = tid; idx < nidx; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    float mb = red_m[g], lb = red_l[g], ab = red_a[g * D + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      mb = fmaxf(mb, red_m[w * GC + g]);
      lb += red_l[w * GC + g];
      ab += red_a[(w * GC + g) * D + d];
    }
    mine[g * D + d] = ab / fmaxf(lb, 1e-30f);
    if (d == 0) {
      mine[GC * D + g] = mb;
      mine[GC * D + GC + g] = lb;
    }
  }
  __syncthreads();
  if (tid == 0) {  // a cumulative fence: the whole block's partial
    __threadfence();
    s_last = atomicAdd(&counters[cell], 1) == n_split - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block of this cell combines every split, in split-index
  // order, as one online pass (running max, rescaled sums): the loads of
  // a batch of splits do not wait on each other's math
  const float* base = part + (size_t)cell * n_split * kStride;
  for (int idx = tid; idx < nidx; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    float mb = REPRO_NEG_INF, den = 0.f, num = 0.f;
#pragma unroll 8
    for (int k = 0; k < n_split; ++k) {
      const float* pk = base + k * kStride;
      const float mk = __ldcg(pk + GC * D + g);
      const float lk = __ldcg(pk + GC * D + GC + g);
      const float ok = __ldcg(pk + g * D + d);
      fold_split(mb, den, num, mk, lk, ok);
    }
    out[((size_t)b * H + h0 + g) * D + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
    if (m_out != nullptr && d == 0) {
      m_out[(size_t)b * H + h0 + g] = mb;
      l_out[(size_t)b * H + h0 + g] = den;
    }
  }
  if (tid == 0) counters[cell] = 0;
}

template <typename T, int D, int GC>
int launch_gc(const void* q, const void* k_pool, const void* v_pool,
              const void* table, const void* ctx_lens, void* out,
              void* m_out, void* l_out, void* part, void* counters, int B,
              int H, int KV, int P, int maxp, int n_split, int pps,
              float scale, float softcap, int window, cudaStream_t stream) {
  constexpr int TILE = tile_rows<T, D>();
  const size_t smem = 4 * (size_t)TILE * D * sizeof(T) +
                      sizeof(float) * kWarps * GC * (D + 2) +
                      sizeof(int) * (size_t)(pps > 0 ? pps : 1);
  if (smem > 48 * 1024) {  // above the default cap: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, D, GC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nhc = (H / KV + GC - 1) / GC;
  paged_attention_kernel<T, D, GC>
      <<<dim3(KV * nhc, B, n_split), kThreads, smem, stream>>>(
          (const T*)q, (const T*)k_pool, (const T*)v_pool,
          (const int*)table, (const int*)ctx_lens, (T*)out, (float*)m_out,
          (float*)l_out, (float*)part, (int*)counters, H, KV, P, maxp,
          n_split, pps, scale, softcap, window);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_d(int gc, const void* q, const void* k_pool, const void* v_pool,
             const void* table, const void* ctx_lens, void* out, void* m_out,
             void* l_out, void* part, void* counters, int B, int H, int KV,
             int P, int maxp, int n_split, int pps, float scale,
             float softcap, int window, cudaStream_t s) {
  switch (gc) {
    case 1:
      return launch_gc<T, D, 1>(q, k_pool, v_pool, table, ctx_lens, out,
                                m_out, l_out, part, counters, B, H, KV, P,
                                maxp, n_split, pps, scale, softcap, window, s);
    case 4:
      return launch_gc<T, D, 4>(q, k_pool, v_pool, table, ctx_lens, out,
                                m_out, l_out, part, counters, B, H, KV, P,
                                maxp, n_split, pps, scale, softcap, window, s);
    case 8:
      return launch_gc<T, D, 8>(q, k_pool, v_pool, table, ctx_lens, out,
                                m_out, l_out, part, counters, B, H, KV, P,
                                maxp, n_split, pps, scale, softcap, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_t(int D, int gc, const void* q, const void* k_pool,
             const void* v_pool, const void* table, const void* ctx_lens,
             void* out, void* m_out, void* l_out, void* part, void* counters,
             int B, int H, int KV, int P, int maxp, int n_split, int pps,
             float scale, float softcap, int window, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(gc, q, k_pool, v_pool, table, ctx_lens, out,
                             m_out, l_out, part, counters, B, H, KV, P, maxp,
                             n_split, pps, scale, softcap, window, s);
    case 32:
      return launch_d<T, 32>(gc, q, k_pool, v_pool, table, ctx_lens, out,
                             m_out, l_out, part, counters, B, H, KV, P, maxp,
                             n_split, pps, scale, softcap, window, s);
    case 64:
      return launch_d<T, 64>(gc, q, k_pool, v_pool, table, ctx_lens, out,
                             m_out, l_out, part, counters, B, H, KV, P, maxp,
                             n_split, pps, scale, softcap, window, s);
    case 128:
      return launch_d<T, 128>(gc, q, k_pool, v_pool, table, ctx_lens, out,
                              m_out, l_out, part, counters, B, H, KV, P, maxp,
                              n_split, pps, scale, softcap, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// gc: query heads per block (1, 4 or 8; G = H/KV heads in ceil(G/gc)
// chunks); n_split splits of pps pages each; part: n_split partials per
// (sequence, KV head, head chunk) when n_split > 1; counters: one int
// per (sequence, KV head, head chunk), zero before the call and after.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* table, const void* ctx_lens, void* out, void* m_out,
    void* l_out, void* part, void* counters, int B, int H, int KV, int D,
    int P, int maxp, int gc, int n_split, int pps, float scale,
    float softcap, int window, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_split < 1 || n_split > kMaxSplits ||
      (n_split > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch_t<float>(D, gc, q, k_pool, v_pool, table, ctx_lens, out,
                             m_out, l_out, part, counters, B, H, KV, P, maxp,
                             n_split, pps, scale, softcap, window, s);
    case kBF16:
      return launch_t<__nv_bfloat16>(D, gc, q, k_pool, v_pool, table,
                                     ctx_lens, out, m_out, l_out, part,
                                     counters, B, H, KV, P, maxp, n_split,
                                     pps, scale, softcap, window, s);
    case kF16:
      return launch_t<__half>(D, gc, q, k_pool, v_pool, table, ctx_lens, out,
                              m_out, l_out, part, counters, B, H, KV, P, maxp,
                              n_split, pps, scale, softcap, window, s);
  }
  return (int)cudaErrorInvalidValue;
}
