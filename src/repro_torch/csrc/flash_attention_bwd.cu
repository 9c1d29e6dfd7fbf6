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
// pairs, seven with Q K^T and dO V^T recomputed in the second kernel
// (ten in bf16, where P and dS are two operands each):
// at the training shape (B 8, S 1024, H 32, D 64, causal) ~120 GFLOP
// against ~40 MB moved, so the products belong on the tensor cores.
//
// Two kernels, deterministic: each output element is written by one
// block and none is summed across blocks, so repeated calls are
// bit-identical.
// The dq kernel writes delta to a float32 scratch; the dk/dv kernel
// runs after it on the same stream and reads it.
//
// bf16 / f16 at head_dim 16-128 (the training path): tensor-core
// bodies, four warps of 16 rows, mma.sync.m16n8k16 with f32
// accumulators, operands from padded shared tiles through ldmatrix,
// tiles double-buffered by cp.async so the next tile loads while this
// one is multiplied (the forward's tile code). P and dS are rounded to
// the input type only as operands of their products (as FA2 does); in
// bf16 each is two operands, hi + lo (kSplit).
// - dq: one block per (b, q head, 64-row query tile), taking query
//   tiles p and nqt-1-p in turn so that under causal masking the blocks
//   finish together. Q and dO are A fragments (in registers up to D 64,
//   re-read from shared memory at D 128, where dQ's accumulator takes 64
//   registers). Per 64-key tile: S = Q K^T and dP = dO V^T, P and dS in
//   registers, dQ += dS K with dS packed from the accumulator layout
//   straight into A fragments and K read by ldmatrix.trans.
// - dk/dv: one block per (b, KV head, 64-key tile), key tiles p and
//   nkt-1-p in turn. K and V are A fragments; it walks the group's G
//   query heads and, for each, the query tiles that can see the key
//   tile (64 rows, 32 at D 128, where dK and dV take 128 f32 registers
//   a thread), staging Q, dO, lse, delta and the query ids: S^T = K Q^T,
//   dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.
// Segment-aware tile skipping: a first launch reduces the ids of every
// key tile and every query tile to [min, max] (scratch `spans`); a
// block reduces its own tile's ids once, and a candidate tile whose
// span does not meet its own is neither loaded nor multiplied: lane i
// of each warp tests tile base + i, and the warp's ballot keeps the
// answers for 32 tiles. The test never drops a visible pair, whatever
// the ids; for packed nondecreasing ids it drops most off-diagonal
// tiles. Inside a staged tile the per-element mask is the forward's.
// Candidate tiles are first cut to the causal frontier and the window,
// as in the forward.
//
// bf16 / f16 at head_dim 256 (gemma2's training path): the same walk
// and tile skip in eight-warp bodies whose warps split dQ, dK and dV
// along D, with P and dS staged in shared memory (see "head_dim 256"
// below): four warps of 16 rows would hold 128 (dq) or 256 (dk/dv) f32
// accumulators a thread.
//
// f32 (1e-4 tolerance; TF32 tensor cores would not meet it): the first
// version, on the CUDA cores. TPR threads per row hold D / TPR elements
// of its q, dout and dq (dq kernel) or k, v, dk, dv (dk/dv kernel) in
// registers; tiles are staged as f32, and a pair's dot products reduce
// over the row's threads by shuffles.
//
// The launches go through BWD_LAUNCH, so the whole file also builds
// with g++ against host_emulation.cuh (tools/flash_bwd_host_check.py).
#include "common.cuh"

// ======================================================================
// the first version: float32

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


// ======================================================================
// the bf16 / f16 bodies: tensor cores
constexpr int kBwdThreads = 128;   // four warps of 16 rows
constexpr int kBwdBQ = 64;         // query rows of a dq block
constexpr int kBwdBK = 64;         // key rows of a dq tile and a dk/dv block
constexpr float kLog2e = 1.4426950408889634f;

// query rows of a dk/dv tile
template <int D>
__host__ __device__ constexpr int kv_bq() { return D >= 128 ? 32 : 64; }

template <typename T, int D>
constexpr size_t dq_smem_bytes() {  // Q, dO, two stages of K, V and ids;
  return (size_t)(2 * kBwdBQ + 4 * kBwdBK) * (D + 8) * sizeof(T) +
         2 * kBwdBK * sizeof(int) + 2 * kBwdBQ * sizeof(float);  // stats
}

template <typename T, int D>
constexpr size_t dkdv_smem_bytes() {  // K, V, two stages of Q, dO, stats
  return (size_t)(2 * kBwdBK + 4 * kv_bq<D>()) * (D + 8) * sizeof(T) +
         2 * kv_bq<D>() * (2 * sizeof(float) + sizeof(int));
}

// [min, max] of the ids of each `tile`-row tile: grid (ntiles, B), one
// warp a tile
__global__ void flash_bwd_spans_kernel(const int* __restrict__ ids, int S,
                                       int tile, int ntiles,
                                       int2* __restrict__ spans) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int* p = ids + (size_t)b * S;
  int lo = 0x7fffffff, hi = (int)0x80000000;
  for (int i = t * tile + (int)threadIdx.x; i < min(S, (t + 1) * tile);
       i += 32) {
    lo = min(lo, p[i]);
    hi = max(hi, p[i]);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (threadIdx.x == 0) spans[(size_t)b * ntiles + t] = make_int2(lo, hi);
}

// the block's own [min, max] of its rows' ids (rows past the end
// excluded): every thread of the NW warps passes its two rows
template <int NW = kBwdThreads / 32>
__device__ __forceinline__ int2 block_span(const int* id, const bool* live,
                                           int2* red) {
  int lo = 0x7fffffff, hi = (int)0x80000000;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (live[i]) {
      lo = min(lo, id[i]);
      hi = max(hi, id[i]);
    }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_int2(lo, hi);
  __syncthreads();
  int2 m = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) {
    m.x = min(m.x, red[w].x);
    m.y = max(m.y, red[w].y);
  }
  return m;
}

// The candidate tiles [lo, hi] whose id span meets `mine`, 32 at a time:
// lane i tests tile base + i and the warp's ballot keeps the answers.
// Every thread of the block calls next() with the same t. SEG false:
// every tile.
template <bool SEG>
struct SpanWalk {
  const int2* spans;
  int2 mine;
  int lo, hi, base;
  unsigned bits;

  __device__ SpanWalk(const int2* s, int2 m, int l, int h)
      : spans(s), mine(m), lo(l), hi(h), base(l - 64), bits(0u) {}

  // the first tile >= t that meets; hi + 1 if none
  __device__ int next(int t) {
    if constexpr (!SEG) return t;
    while (t <= hi) {
      if (t < base || t >= base + 32) {
        base = lo + ((t - lo) & ~31);
        const int u = base + (int)(threadIdx.x & 31);
        bool meet = false;
        if (u <= hi) {
          const int2 sp = spans[u];
          meet = max(sp.x, mine.x) <= min(sp.y, mine.y);
        }
        bits = __ballot_sync(0xffffffffu, meet);
      }
      const unsigned m = bits >> (t - base);
      if (m) return t + __ffs(m) - 1;
      t = base + 32;
    }
    return hi + 1;
  }
};

// A fragment of a 16x16 tile at row r0, column c0 of a padded shared
// array (row stride LD)
template <int LD, typename T>
__device__ __forceinline__ void ld_a(uint32_t* a, const T* s, int r0,
                                     int c0, int lane) {
  ldsm_x4(a, s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 +
                 (lane >> 4) * 8);
}

// acc[NT][4] += A (16 x 16*NKS fragments, in registers or re-read from
// `as` at row ar0) times the rows [0, 8*NT) of `bs` transposed (B
// operand rows = output columns): the S / dP products
template <int NKS, int NT, int LD, bool AREGS, typename T>
__device__ __forceinline__ void mma_abt(float (*acc)[4],
                                        const uint32_t (*af)[4],
                                        const T* as, int ar0, const T* bs,
                                        int lane) {
#pragma unroll
  for (int s = 0; s < NKS; ++s) {
    uint32_t areg[4];
    const uint32_t* a = af[AREGS ? s : 0];
    if constexpr (!AREGS) {
      ld_a<LD>(areg, as, ar0, s * 16, lane);
      a = areg;
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bb[4];
      ldsm_x4(bb, bs + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                      s * 16 + ((lane >> 3) & 1) * 8);
      Mma<T>::run(acc[2 * np], a, bb[0], bb[1]);
      Mma<T>::run(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// acc[NDT][4] += X (16 x 8*NT, f32 in the accumulator layout, rounded
// to T here) times the rows [0, 8*NT) of `bs` (B operand rows = the
// contraction): dQ += dS K, dV += P^T dO, dK += dS^T Q. SPLIT: X as
// hi + lo operands, two products (see kSplit).
template <int NT, int NDT, int LD, bool SPLIT, typename T>
__device__ __forceinline__ void mma_xb(float (*acc)[4], const float (*x)[4],
                                       const T* bs, int lane) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t a[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* xi = x[2 * j + (i >> 1)] + 2 * (i & 1);
      if constexpr (SPLIT)
        split_hi_lo<T>(xi[0], xi[1], a[i], al[i]);
      else
        a[i] = Mma<T>::pack(xi[0], xi[1]);
    }
#pragma unroll
    for (int dp = 0; dp < NDT / 2; ++dp) {
      uint32_t bb[4];
      ldsm_x4_trans(bb, bs + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LD +
                            dp * 16 + (lane >> 4) * 8);
      Mma<T>::run(acc[2 * dp], a, bb[0], bb[1]);
      Mma<T>::run(acc[2 * dp + 1], a, bb[2], bb[3]);
      if constexpr (SPLIT) {
        Mma<T>::run(acc[2 * dp], al, bb[0], bb[1]);
        Mma<T>::run(acc[2 * dp + 1], al, bb[2], bb[3]);
      }
    }
  }
}

// P and dS as two operands each in bf16 (8 mantissa bits): dV, dK and
// dQ sum P dO, dS Q and dS K with cancellation (dO, dS and Q change
// sign). With one bf16 operand each the training shape's gradients
// reached 0.0195 of max(1, |want|) from the f32 plain version
// (chip_smoke.py on an H100 80GB HBM3 at 700 W), against a 2e-2 gate;
// hi + lo leaves the bf16 output's own rounding. f16's 11 bits meet its tolerance (1e-2) with one operand.
template <typename T>
constexpr bool kSplit = false;
template <>
constexpr bool kSplit<__nv_bfloat16> = true;

// P and dS of one pair from its raw product s, dP, the row's lse (log2
// units; +inf for a row with no key: P = 0) and delta
__device__ __forceinline__ void pair_p_ds(float s, float dp, float lse2,
                                          float delta, float scale,
                                          float softcap, float* p,
                                          float* ds) {
  float x = s * scale, deriv = 1.f;
  if (softcap > 0.f) {
    const float c = tanhf(x / softcap);
    x = softcap * c;
    deriv = 1.f - c * c;
  }
  *p = exp2f(x * kLog2e - lse2);
  *ds = *p * (dp - delta) * deriv;
}

// a row's lse in log2 units; +inf for a row with no valid key (-inf)
__device__ __forceinline__ float lse_log2(float lse) {
  return lse > -3.0e38f ? lse * kLog2e : __int_as_float(0x7f800000);
}

// rows [row0, row0 + 16) x 8*NDT columns of f32 accumulators, times
// `mul`, into dst (row stride `stride` elements) for rows < nrows
template <int NDT, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (*acc)[4],
                                           float mul, int row0, int nrows,
                                           size_t stride, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + (lane >> 2) + 8 * i;
    if (row >= nrows) continue;
    uint32_t* op = reinterpret_cast<uint32_t*>(dst + (size_t)row * stride +
                                               2 * (lane & 3));
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      op[dt * 4] =
          Mma<T>::pack(acc[dt][2 * i] * mul, acc[dt][2 * i + 1] * mul);
  }
}

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ out,
    const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    const int2* __restrict__ spans_k, int Sq, int Skv, int H, int KV,
    float scale, float softcap, int window, int causal, int q_offset) {
  constexpr int BQ = kBwdBQ, BK = kBwdBK, NT = kBwdThreads;
  constexpr int NNT = BK / 8;   // 8-wide key tiles of S
  constexpr int LD = D + 8;     // padded shared row (elements)
  constexpr int NKS = D / 16;   // k-steps of Q K^T
  constexpr int NDT = D / 8;    // 8-wide column tiles of dQ
  constexpr bool kRegs = D <= 64;   // Q, dO fragments held in registers
  static_assert(NDT % 2 == 0, "pairs of 8-wide output tiles");
  BWD_SMEM(smem_raw);
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* dos = qs + BQ * LD;                   // [BQ][LD]
  T* ks = dos + BQ * LD;                   // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;                // [2][BK][LD]
  int* sks = reinterpret_cast<int*>(vs + 2 * BK * LD);   // [2][BK] key ids
  float* stat = reinterpret_cast<float*>(sks + 2 * BK);  // [2][BQ]
  __shared__ int2 red[kBwdThreads / 32];

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t qstride = (size_t)H * D, kstride = (size_t)KV * D;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* ob = out + ((size_t)b * Sq * H + h) * D;
  const T* dob = dout + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Skv * KV + kvh) * D;
  const T* vb = v + ((size_t)b * Skv * KV + kvh) * D;
  const int* sk = SEG ? seg_k + (size_t)b * Skv : nullptr;
  const size_t srow = ((size_t)b * H + h) * Sq;   // lse / delta row 0
  const int nkt = (Skv + BK - 1) / BK;

  const int nqt = (Sq + BQ - 1) / BQ;
  const int heavy = nqt - 1 - blockIdx.x, light = blockIdx.x;
#pragma unroll 1
  for (int rep = 0; rep < 2; ++rep) {
    if (rep == 1) {
      if (light >= heavy) break;
      __syncthreads();  // the first tile's shared arrays are no longer read
    }
    const int r0 = (rep == 0 ? heavy : light) * BQ;

    // delta = rowsum(dO * O): two threads a row, D / 2 elements each
    {
      const int row = tid >> 1, half = tid & 1;
      float dl = 0.f;
      if (r0 + row < Sq) {
        const size_t off = (size_t)(r0 + row) * qstride + half * (D / 2);
#pragma unroll
        for (int c = 0; c < D / 2; c += 8) {
          float o8[8], d8[8];
          load8_f32(ob + off + c, o8);
          load8_f32(dob + off + c, d8);
#pragma unroll
          for (int e = 0; e < 8; ++e) dl += o8[e] * d8[e];
        }
      }
      dl += __shfl_xor_sync(0xffffffffu, dl, 1);
      if (half == 0) {
        const bool live = r0 + row < Sq;
        stat[row] = dl;
        stat[BQ + row] =
            live ? lse_log2(lse[srow + r0 + row]) : __int_as_float(0x7f800000);
        if (live) delta[srow + r0 + row] = dl;
      }
    }
    // this thread's rows g8 and g8 + 8 of the warp's 16
    int seg_row[2] = {0, 0};
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + warp * 16 + g8 + 8 * i;
      live[i] = row < Sq;
      if (SEG && live[i]) seg_row[i] = seg_q[(size_t)b * Sq + row];
    }
    int2 mine = make_int2(0, 0);
    if constexpr (SEG) mine = block_span(seg_row, live, red);
    __syncthreads();  // stat written
    float dl[2], l2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dl[i] = stat[warp * 16 + g8 + 8 * i];
      l2[i] = stat[BQ + warp * 16 + g8 + 8 * i];
    }

    // key tiles this query tile can see (the forward's), then the spans
    const int r_last = min(r0 + BQ, Sq) - 1;
    const int hi_pos = causal ? min(Skv - 1, q_offset + r_last) : Skv - 1;
    const int lo_pos = window > 0 ? max(0, q_offset + r0 - window + 1) : 0;
    const int kt_lo = lo_pos / BK;
    const int kt_hi = hi_pos < 0 ? -1 : hi_pos / BK;
    SpanWalk<SEG> walk(SEG ? spans_k + (size_t)b * nkt : nullptr, mine,
                       kt_lo, kt_hi);

    float acc[NDT][4];
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    uint32_t qf[kRegs ? NKS : 1][4], df[kRegs ? NKS : 1][4];

    auto load_kv = [&](int kt, int st) {
      cp_async_rows<BK, D, NT>(ks + st * BK * LD, kb, kt * BK, Skv, kstride,
                               tid);
      cp_async_rows<BK, D, NT>(vs + st * BK * LD, vb, kt * BK, Skv, kstride,
                               tid);
      if (SEG && tid < BK)
        cp_async4(sks + st * BK + tid, sk + min(kt * BK + tid, Skv - 1),
                  kt * BK + tid < Skv);
    };
    int kt = walk.next(kt_lo);
    if (kt <= kt_hi) {
      cp_async_rows<BQ, D, NT>(qs, qb, r0, Sq, qstride, tid);
      cp_async_rows<BQ, D, NT>(dos, dob, r0, Sq, qstride, tid);
      load_kv(kt, 0);
      cp_async_commit();
    }
    for (int st = 0, first = 1; kt <= kt_hi; st ^= 1, first = 0) {
      const int nxt = walk.next(kt + 1);
      if (nxt <= kt_hi) {
        load_kv(nxt, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (kRegs && first) {
#pragma unroll
        for (int s = 0; s < NKS; ++s) {
          ld_a<LD>(qf[kRegs ? s : 0], qs, warp * 16, s * 16, lane);
          ld_a<LD>(df[kRegs ? s : 0], dos, warp * 16, s * 16, lane);
        }
      }
      const T* kts = ks + st * BK * LD;
      const T* vts = vs + st * BK * LD;
      const int* skt = sks + st * BK;

      // S = Q K^T and dP = dO V^T: this warp's 16 rows x BK keys
      float sc[NNT][4], dp[NNT][4];
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
      mma_abt<NKS, NNT, LD, kRegs>(sc, qf, qs, warp * 16, kts, lane);
      mma_abt<NKS, NNT, LD, kRegs>(dp, df, dos, warp * 16, vts, lane);

      // P and dS in registers; this thread holds rows g8 (e = 0, 1) and
      // g8 + 8 (e = 2, 3)
      const int k0 = kt * BK;
      const int qp0 = q_offset + r0 + warp * 16 + g8;
      const bool need_mask = SEG || k0 + BK > Skv ||
                             (causal && k0 + BK - 1 > q_offset + r0) ||
                             (window > 0 && k0 < q_offset + r0 + BQ - window);
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p, ds;
          pair_p_ds(sc[nt][e], dp[nt][e], l2[e >> 1], dl[e >> 1], scale,
                    softcap, &p, &ds);
          if (need_mask) {
            const int kk = nt * 8 + 2 * t4 + (e & 1);
            const int kp = k0 + kk;
            const int qp = qp0 + (e >> 1) * 8;
            const bool ok = kp < Skv && (!causal || kp <= qp) &&
                            (window <= 0 || kp > qp - window) &&
                            (!SEG || skt[kk] == seg_row[e >> 1]);
            if (!ok) ds = 0.f;
          }
          dp[nt][e] = ds;
        }
      }
      // dQ += dS K
      mma_xb<NNT, NDT, LD, kSplit<T>>(acc, dp, kts, lane);
      __syncthreads();  // this stage is refilled two tiles on
      kt = nxt;
    }
    store_rows<NDT>(dq + ((size_t)b * Sq * H + h) * D, acc, scale,
                    r0 + warp * 16, Sq, qstride, lane);
  }
}

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkdv_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, const int2* __restrict__ spans_q,
    int Sq, int Skv, int H, int KV, float scale, float softcap, int window,
    int causal, int q_offset) {
  constexpr int BK = kBwdBK, BQ = kv_bq<D>(), NT = kBwdThreads;
  constexpr int NNT = BQ / 8;   // 8-wide query tiles of S^T
  constexpr int LD = D + 8;
  constexpr int NKS = D / 16;
  constexpr int NDT = D / 8;
  constexpr bool kRegs = D <= 64;   // K, V fragments held in registers
  static_assert(NDT % 2 == 0 && NNT % 2 == 0, "pairs of 8-wide tiles");
  BWD_SMEM(smem_raw);
  T* ks = reinterpret_cast<T*>(smem_raw);  // [BK][LD]
  T* vs = ks + BK * LD;                    // [BK][LD]
  T* qs = vs + BK * LD;                    // [2][BQ][LD]
  T* dos = qs + 2 * BQ * LD;               // [2][BQ][LD]
  float* lses = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* dels = lses + 2 * BQ;                                // [2][BQ]
  int* sqs = reinterpret_cast<int*>(dels + 2 * BQ);           // [2][BQ]
  __shared__ int2 red[kBwdThreads / 32];

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t qstride = (size_t)H * D, kstride = (size_t)KV * D;
  const T* kb = k + ((size_t)b * Skv * KV + kvh) * D;
  const T* vb = v + ((size_t)b * Skv * KV + kvh) * D;
  const int* sq = SEG ? seg_q + (size_t)b * Sq : nullptr;
  const int nqt = (Sq + BQ - 1) / BQ;

  const int nkt = (Skv + BK - 1) / BK;
  const int light = nkt - 1 - blockIdx.x, heavy = blockIdx.x;
#pragma unroll 1
  for (int rep = 0; rep < 2; ++rep) {
    if (rep == 1) {
      if (heavy >= light) break;
      __syncthreads();  // the first tile's shared arrays are no longer read
    }
    const int c0 = (rep == 0 ? heavy : light) * BK;

    // this thread's keys g8 and g8 + 8 of the warp's 16
    int seg_key[2] = {0, 0};
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = c0 + warp * 16 + g8 + 8 * i;
      live[i] = key < Skv;
      if (SEG && live[i]) seg_key[i] = seg_k[(size_t)b * Skv + key];
    }
    int2 mine = make_int2(0, 0);
    if constexpr (SEG) mine = block_span(seg_key, live, red);

    // query rows that can see a key of this tile: [i_lo, i_hi]
    const int c_last = min(c0 + BK, Skv) - 1;
    const int i_lo = causal ? max(0, c0 - q_offset) : 0;
    const int i_hi = window > 0 ? min(Sq - 1, c_last + window - 1 - q_offset)
                                : Sq - 1;
    const int qt_lo = i_lo / BQ;
    const int qt_hi = i_lo <= i_hi ? i_hi / BQ : -1;
    SpanWalk<SEG> walk(SEG ? spans_q + (size_t)b * nqt : nullptr, mine,
                       qt_lo, qt_hi);

    float dka[NDT][4], dva[NDT][4];
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;
    uint32_t kf[kRegs ? NKS : 1][4], vf[kRegs ? NKS : 1][4];

    // items (g, qt): the group's heads, each over the query tiles whose
    // span meets this key tile's
    auto load_item = [&](int g, int qt, int st) {
      const int h = kvh * G + g, i0 = qt * BQ;
      const size_t hq = ((size_t)b * Sq * H + h) * D;
      cp_async_rows<BQ, D, NT>(qs + st * BQ * LD, q + hq, i0, Sq, qstride,
                               tid);
      cp_async_rows<BQ, D, NT>(dos + st * BQ * LD, dout + hq, i0, Sq,
                               qstride, tid);
      if (tid < BQ) {
        const size_t r = ((size_t)b * H + h) * Sq + min(i0 + tid, Sq - 1);
        const bool ok = i0 + tid < Sq;
        cp_async4(lses + st * BQ + tid, lse + r, ok);
        cp_async4(dels + st * BQ + tid, delta + r, ok);
        if (SEG) cp_async4(sqs + st * BQ + tid, sq + min(i0 + tid, Sq - 1), ok);
      }
    };
    const int first_qt = walk.next(qt_lo);
    int g = 0, qt = first_qt;
    if (qt <= qt_hi) {
      cp_async_rows<BK, D, NT>(ks, kb, c0, Skv, kstride, tid);
      cp_async_rows<BK, D, NT>(vs, vb, c0, Skv, kstride, tid);
      load_item(g, qt, 0);
      cp_async_commit();
    } else {
      g = G;   // no query tile sees this key tile
    }
    for (int st = 0, first = 1; g < G; st ^= 1, first = 0) {
      int ng = g, nq = walk.next(qt + 1);
      if (nq > qt_hi) {
        ++ng;
        nq = first_qt;
      }
      if (ng < G) {
        load_item(ng, nq, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (kRegs && first) {
#pragma unroll
        for (int s = 0; s < NKS; ++s) {
          ld_a<LD>(kf[kRegs ? s : 0], ks, warp * 16, s * 16, lane);
          ld_a<LD>(vf[kRegs ? s : 0], vs, warp * 16, s * 16, lane);
        }
      }
      const T* qts = qs + st * BQ * LD;
      const T* dots = dos + st * BQ * LD;
      const float* lt = lses + st * BQ;
      const float* dlt = dels + st * BQ;
      const int* sqt = sqs + st * BQ;

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
      float sc[NNT][4], dp[NNT][4];
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
      mma_abt<NKS, NNT, LD, kRegs>(sc, kf, ks, warp * 16, qts, lane);
      mma_abt<NKS, NNT, LD, kRegs>(dp, vf, vs, warp * 16, dots, lane);

      // P^T and dS^T; this thread holds keys g8 (e = 0, 1) and g8 + 8
      // (e = 2, 3), queries nt * 8 + 2 * t4 + (e & 1). Rows past Sq are
      // zero in Q and dO (and their lse and delta 0): they add nothing
      const int i0 = qt * BQ;
      const int kp0 = c0 + warp * 16 + g8;
      const bool need_mask =
          SEG || (causal && c0 + BK - 1 > q_offset + i0) ||
          (window > 0 && c0 <= q_offset + i0 + BQ - 1 - window);
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt) {
        const int col = nt * 8 + 2 * t4;
        const float2 l2 = make_float2(lse_log2(lt[col]), lse_log2(lt[col + 1]));
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = col + (e & 1);
          float p, ds;
          pair_p_ds(sc[nt][e], dp[nt][e], (e & 1) ? l2.y : l2.x,
                    (e & 1) ? d2.y : d2.x, scale, softcap, &p, &ds);
          if (need_mask) {
            const int qp = q_offset + i0 + c;
            const int kp = kp0 + (e >> 1) * 8;
            const bool ok = (!causal || kp <= qp) &&
                            (window <= 0 || kp > qp - window) &&
                            (!SEG || sqt[c] == seg_key[e >> 1]);
            if (!ok) p = ds = 0.f;
          }
          sc[nt][e] = p;
          dp[nt][e] = ds;
        }
      }
      // dV += P^T dO, dK += dS^T Q
      mma_xb<NNT, NDT, LD, kSplit<T>>(dva, sc, dots, lane);
      mma_xb<NNT, NDT, LD, kSplit<T>>(dka, dp, qts, lane);
      __syncthreads();  // this stage is refilled two items on
      g = ng;
      qt = nq;
    }
    const size_t kbase = ((size_t)b * Skv * KV + kvh) * D;
    store_rows<NDT>(dk + kbase, dka, scale, c0 + warp * 16, Skv, kstride,
                    lane);
    store_rows<NDT>(dv + kbase, dva, 1.f, c0 + warp * 16, Skv, kstride,
                    lane);
  }
}

// ======================================================================
// head_dim 256, bf16 / f16: eight warps a block, P and dS staged in
// shared memory (FlashAttention-2's layout at this width)
//
// A warp of 16 rows that held a whole 256-wide f32 accumulator would
// need 128 registers a thread for dQ, and 256 for dK + dV. Here each
// block has eight warps in a 4 x 2 grid: warp w takes the 16-row group
// rw = w % 4 and the half hf = w / 4. For S and dP the half picks 16 of
// the walked tile's 32 columns, so no product is computed twice; for the
// output products it picks 128 of the 256 columns of dQ, or of dK and
// dV. P and dS cross between the halves through shared memory: each
// warp writes its 16 x 16 block of them, rounded to the input type (hi
// + lo in bf16, kSplit), and after a barrier each warp reads its 16
// rows x 32 back as A fragments by ldmatrix.
// - dq: one block per (b, q head, 64-row query tile), tiles p and
//   nqt-1-p in turn, walking 32-key tiles. Q and dO stay in shared
//   memory and are re-read as A fragments for every tile (as the
//   forward does at D 256); dQ += dS K reads K by ldmatrix.trans.
// - dk/dv: one block per (b, KV head, 64-key tile), key tiles p and
//   nkt-1-p in turn, walking the group's G heads and, for each, the
//   32-row query tiles that can see the key tile: S^T = K Q^T, dP^T =
//   V dO^T, then dV += P^T dO and dK += dS^T Q.
// Tiles are double-buffered by cp.async; the causal / window cut and
// the ids' span skip are the D <= 128 bodies' (spans of 32-row tiles).
// Resources a block (bf16; f16 the same less the lo arrays):
//   dq    shared: Q, dO 2 x 64 x 264 x 2 B = 67,584; K, V two stages
//         4 x 32 x 264 x 2 = 67,584; dS hi + lo 2 x 64 x 40 x 2 =
//         10,240; key ids 256; delta and lse 512: 146,176 B.
//         registers: dQ 16 tiles x 4 = 64 f32, S and dP 2 x 2 x 4 = 16.
//   dk/dv shared: K, V 67,584; Q, dO two stages 67,584; P and dS hi +
//         lo 4 x 64 x 40 x 2 = 20,480; lse, delta, ids 768: 156,416 B.
//         registers: dK and dV 2 x 16 x 4 = 128 f32, S^T and dP^T 16.
//   One 256-thread block an SM: shared memory allows one, and 255
//   registers a thread are 65,280 of the SM's 65,536. The launch bounds
//   say one block an SM: with the thread count alone ptxas capped the
//   bf16 dq body with ids at 128 registers and spilled.
constexpr int kWideThreads = 256;   // eight warps: 4 row groups x 2 halves
constexpr int kWideRows = 64;       // a dq block's queries, dk/dv's keys
constexpr int kWideTile = 32;       // rows of a walked tile

// Q, dO, two stages of K and V, dS (hi and lo), two stages of key ids,
// delta and lse
template <typename T, int D>
constexpr size_t dq_wide_smem_bytes() {
  return (size_t)(2 * kWideRows + 4 * kWideTile) * (D + 8) * sizeof(T) +
         (kSplit<T> ? 2 : 1) * kWideRows * (kWideTile + 8) * sizeof(T) +
         2 * kWideTile * sizeof(int) + 2 * kWideRows * sizeof(float);
}

// K, V, two stages of Q and dO, P and dS (hi and lo), two stages of
// lse, delta and query ids
template <typename T, int D>
constexpr size_t dkdv_wide_smem_bytes() {
  return (size_t)(2 * kWideRows + 4 * kWideTile) * (D + 8) * sizeof(T) +
         2 * (kSplit<T> ? 2 : 1) * kWideRows * (kWideTile + 8) * sizeof(T) +
         2 * kWideTile * (2 * sizeof(float) + sizeof(int));
}

// rows [r0, r0 + 16) x 8*NT columns from c0 of f32 accumulators into
// shared `hi` (row stride LD) rounded to T; with SPLIT the remainder
// into `lo`
template <int NT, int LD, bool SPLIT, typename T>
__device__ __forceinline__ void stage_x(T* hi, T* lo, const float (*x)[4],
                                        int r0, int c0, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int off = (r0 + (lane >> 2) + 8 * i) * LD + c0 + nt * 8 +
                      2 * (lane & 3);
      uint32_t h, l;
      if constexpr (SPLIT) {
        split_hi_lo<T>(x[nt][2 * i], x[nt][2 * i + 1], h, l);
        *reinterpret_cast<uint32_t*>(lo + off) = l;
      } else {
        h = Mma<T>::pack(x[nt][2 * i], x[nt][2 * i + 1]);
      }
      *reinterpret_cast<uint32_t*>(hi + off) = h;
    }
}

// acc[NDT][4] += A (the 16 rows from ar0 x 16*NKS columns of shared
// `ah`, with SPLIT plus the same of `al`) times rows [0, 16*NKS) x
// 8*NDT columns of `bs`: dQ += dS K, dV += P^T dO, dK += dS^T Q from
// the staged P and dS
template <int NKS, int NDT, int LDA, int LDB, bool SPLIT, typename T>
__device__ __forceinline__ void mma_sb(float (*acc)[4], const T* ah,
                                       const T* al, int ar0, const T* bs,
                                       int lane) {
#pragma unroll
  for (int s = 0; s < NKS; ++s) {
    uint32_t a[4], alo[4];
    ld_a<LDA>(a, ah, ar0, s * 16, lane);
    if constexpr (SPLIT) ld_a<LDA>(alo, al, ar0, s * 16, lane);
#pragma unroll
    for (int dp = 0; dp < NDT / 2; ++dp) {
      uint32_t bb[4];
      ldsm_x4_trans(bb, bs + (s * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LDB +
                            dp * 16 + (lane >> 4) * 8);
      Mma<T>::run(acc[2 * dp], a, bb[0], bb[1]);
      Mma<T>::run(acc[2 * dp + 1], a, bb[2], bb[3]);
      if constexpr (SPLIT) {
        Mma<T>::run(acc[2 * dp], alo, bb[0], bb[1]);
        Mma<T>::run(acc[2 * dp + 1], alo, bb[2], bb[3]);
      }
    }
  }
}

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(kWideThreads, 1) flash_bwd_dq_wide_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ out,
    const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    const int2* __restrict__ spans_k, int Sq, int Skv, int H, int KV,
    float scale, float softcap, int window, int causal, int q_offset) {
  constexpr int BQ = kWideRows, BK = kWideTile, NT = kWideThreads;
  constexpr int LD = D + 8, LDS = BK + 8;   // padded shared rows
  constexpr int NKS = D / 16;    // k-steps of Q K^T
  constexpr int HALF = D / 2;    // dQ columns a warp
  constexpr int NDT = HALF / 8;  // their 8-wide tiles
  constexpr int RPT = NT / BQ;   // threads a row of the delta sum
  BWD_SMEM(smem_raw);
  T* qs = reinterpret_cast<T*>(smem_raw);       // [BQ][LD]
  T* dos = qs + BQ * LD;                        // [BQ][LD]
  T* ks = dos + BQ * LD;                        // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;                     // [2][BK][LD]
  T* dsh = vs + 2 * BK * LD;                    // [BQ][LDS] dS (hi)
  T* dsl = dsh + (kSplit<T> ? BQ * LDS : 0);    // [BQ][LDS] its lo
  int* sks = reinterpret_cast<int*>(dsl + BQ * LDS);     // [2][BK] key ids
  float* stat = reinterpret_cast<float*>(sks + 2 * BK);  // [2][BQ]
  __shared__ int2 red[NT / 32];

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rw = warp & 3, hf = warp >> 2;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t qstride = (size_t)H * D, kstride = (size_t)KV * D;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* ob = out + ((size_t)b * Sq * H + h) * D;
  const T* dob = dout + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Skv * KV + kvh) * D;
  const T* vb = v + ((size_t)b * Skv * KV + kvh) * D;
  const int* sk = SEG ? seg_k + (size_t)b * Skv : nullptr;
  const size_t srow = ((size_t)b * H + h) * Sq;   // lse / delta row 0
  const int nkt = (Skv + BK - 1) / BK;
  const uint32_t (*no_frags)[4] = nullptr;        // A read from shared

  const int nqt = (Sq + BQ - 1) / BQ;
  const int heavy = nqt - 1 - blockIdx.x, light = blockIdx.x;
#pragma unroll 1
  for (int rep = 0; rep < 2; ++rep) {
    if (rep == 1) {
      if (light >= heavy) break;
      __syncthreads();  // the first tile's shared arrays are no longer read
    }
    const int r0 = (rep == 0 ? heavy : light) * BQ;

    // delta = rowsum(dO * O): RPT threads a row, D / RPT elements each
    {
      const int row = tid / RPT, part = tid % RPT;
      float dl = 0.f;
      if (r0 + row < Sq) {
        const size_t off = (size_t)(r0 + row) * qstride + part * (D / RPT);
#pragma unroll
        for (int c = 0; c < D / RPT; c += 8) {
          float o8[8], d8[8];
          load8_f32(ob + off + c, o8);
          load8_f32(dob + off + c, d8);
#pragma unroll
          for (int e = 0; e < 8; ++e) dl += o8[e] * d8[e];
        }
      }
#pragma unroll
      for (int o = 1; o < RPT; o <<= 1)
        dl += __shfl_xor_sync(0xffffffffu, dl, o);
      if (part == 0) {
        const bool live = r0 + row < Sq;
        stat[row] = dl;
        stat[BQ + row] =
            live ? lse_log2(lse[srow + r0 + row]) : __int_as_float(0x7f800000);
        if (live) delta[srow + r0 + row] = dl;
      }
    }
    // this thread's rows g8 and g8 + 8 of its group's 16
    int seg_row[2] = {0, 0};
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + rw * 16 + g8 + 8 * i;
      live[i] = row < Sq;
      if (SEG && live[i]) seg_row[i] = seg_q[(size_t)b * Sq + row];
    }
    int2 mine = make_int2(0, 0);
    if constexpr (SEG) mine = block_span<NT / 32>(seg_row, live, red);
    __syncthreads();  // stat written
    float dl[2], l2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dl[i] = stat[rw * 16 + g8 + 8 * i];
      l2[i] = stat[BQ + rw * 16 + g8 + 8 * i];
    }

    // key tiles this query tile can see (the forward's), then the spans
    const int r_last = min(r0 + BQ, Sq) - 1;
    const int hi_pos = causal ? min(Skv - 1, q_offset + r_last) : Skv - 1;
    const int lo_pos = window > 0 ? max(0, q_offset + r0 - window + 1) : 0;
    const int kt_lo = lo_pos / BK;
    const int kt_hi = hi_pos < 0 ? -1 : hi_pos / BK;
    SpanWalk<SEG> walk(SEG ? spans_k + (size_t)b * nkt : nullptr, mine,
                       kt_lo, kt_hi);

    float acc[NDT][4];
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    auto load_kv = [&](int kt, int st) {
      cp_async_rows<BK, D, NT>(ks + st * BK * LD, kb, kt * BK, Skv, kstride,
                               tid);
      cp_async_rows<BK, D, NT>(vs + st * BK * LD, vb, kt * BK, Skv, kstride,
                               tid);
      if (SEG && tid < BK)
        cp_async4(sks + st * BK + tid, sk + min(kt * BK + tid, Skv - 1),
                  kt * BK + tid < Skv);
    };
    int kt = walk.next(kt_lo);
    if (kt <= kt_hi) {
      cp_async_rows<BQ, D, NT>(qs, qb, r0, Sq, qstride, tid);
      cp_async_rows<BQ, D, NT>(dos, dob, r0, Sq, qstride, tid);
      load_kv(kt, 0);
      cp_async_commit();
    }
    for (int st = 0; kt <= kt_hi; st ^= 1) {
      const int nxt = walk.next(kt + 1);
      if (nxt <= kt_hi) {
        load_kv(nxt, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* kts = ks + st * BK * LD;
      const T* vts = vs + st * BK * LD;
      const int* skt = sks + st * BK;

      // S = Q K^T and dP = dO V^T: this warp's 16 rows x 16 keys
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
      mma_abt<NKS, 2, LD, false>(sc, no_frags, qs, rw * 16,
                                 kts + hf * 16 * LD, lane);
      mma_abt<NKS, 2, LD, false>(dp, no_frags, dos, rw * 16,
                                 vts + hf * 16 * LD, lane);

      // dS; this thread holds rows g8 (e = 0, 1) and g8 + 8 (e = 2, 3)
      const int k0 = kt * BK;
      const int qp0 = q_offset + r0 + rw * 16 + g8;
      const bool need_mask = SEG || k0 + BK > Skv ||
                             (causal && k0 + BK - 1 > q_offset + r0) ||
                             (window > 0 && k0 < q_offset + r0 + BQ - window);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p, ds;
          pair_p_ds(sc[nt][e], dp[nt][e], l2[e >> 1], dl[e >> 1], scale,
                    softcap, &p, &ds);
          if (need_mask) {
            const int kk = hf * 16 + nt * 8 + 2 * t4 + (e & 1);
            const int kp = k0 + kk;
            const int qp = qp0 + (e >> 1) * 8;
            const bool ok = kp < Skv && (!causal || kp <= qp) &&
                            (window <= 0 || kp > qp - window) &&
                            (!SEG || skt[kk] == seg_row[e >> 1]);
            if (!ok) ds = 0.f;
          }
          dp[nt][e] = ds;
        }
      }
      stage_x<2, LDS, kSplit<T>>(dsh, dsl, dp, rw * 16, hf * 16, lane);
      __syncthreads();  // the tile's dS staged
      // dQ (this warp's half) += dS K
      mma_sb<BK / 16, NDT, LDS, LD, kSplit<T>>(acc, dsh, dsl, rw * 16,
                                                kts + hf * HALF, lane);
      __syncthreads();  // dS read; this stage is refilled two tiles on
      kt = nxt;
    }
    store_rows<NDT>(dq + ((size_t)b * Sq * H + h) * D + hf * HALF, acc,
                    scale, r0 + rw * 16, Sq, qstride, lane);
  }
}

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_bwd_dkdv_wide_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, const int2* __restrict__ spans_q,
    int Sq, int Skv, int H, int KV, float scale, float softcap, int window,
    int causal, int q_offset) {
  constexpr int BK = kWideRows, BQ = kWideTile, NT = kWideThreads;
  constexpr int LD = D + 8, LDP = BQ + 8;   // padded shared rows
  constexpr int NKS = D / 16;
  constexpr int HALF = D / 2;    // dK / dV columns a warp
  constexpr int NDT = HALF / 8;
  constexpr int NX = kSplit<T> ? BK * LDP : 0;   // a lo array's elements
  BWD_SMEM(smem_raw);
  T* ks = reinterpret_cast<T*>(smem_raw);  // [BK][LD]
  T* vs = ks + BK * LD;                    // [BK][LD]
  T* qs = vs + BK * LD;                    // [2][BQ][LD]
  T* dos = qs + 2 * BQ * LD;               // [2][BQ][LD]
  T* ph = dos + 2 * BQ * LD;               // [BK][LDP] P^T (hi)
  T* pl = ph + NX;                         // its lo
  T* dsh = pl + BK * LDP;                  // [BK][LDP] dS^T (hi)
  T* dsl = dsh + NX;                       // its lo
  float* lses = reinterpret_cast<float*>(dsl + BK * LDP);   // [2][BQ]
  float* dels = lses + 2 * BQ;                              // [2][BQ]
  int* sqs = reinterpret_cast<int*>(dels + 2 * BQ);         // [2][BQ]
  __shared__ int2 red[NT / 32];

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rw = warp & 3, hf = warp >> 2;
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t qstride = (size_t)H * D, kstride = (size_t)KV * D;
  const T* kb = k + ((size_t)b * Skv * KV + kvh) * D;
  const T* vb = v + ((size_t)b * Skv * KV + kvh) * D;
  const int* sq = SEG ? seg_q + (size_t)b * Sq : nullptr;
  const int nqt = (Sq + BQ - 1) / BQ;
  const uint32_t (*no_frags)[4] = nullptr;   // A read from shared

  const int nkt = (Skv + BK - 1) / BK;
  const int light = nkt - 1 - blockIdx.x, heavy = blockIdx.x;
#pragma unroll 1
  for (int rep = 0; rep < 2; ++rep) {
    if (rep == 1) {
      if (heavy >= light) break;
      __syncthreads();  // the first tile's shared arrays are no longer read
    }
    const int c0 = (rep == 0 ? heavy : light) * BK;

    // this thread's keys g8 and g8 + 8 of its group's 16
    int seg_key[2] = {0, 0};
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = c0 + rw * 16 + g8 + 8 * i;
      live[i] = key < Skv;
      if (SEG && live[i]) seg_key[i] = seg_k[(size_t)b * Skv + key];
    }
    int2 mine = make_int2(0, 0);
    if constexpr (SEG) mine = block_span<NT / 32>(seg_key, live, red);

    // query rows that can see a key of this tile: [i_lo, i_hi]
    const int c_last = min(c0 + BK, Skv) - 1;
    const int i_lo = causal ? max(0, c0 - q_offset) : 0;
    const int i_hi = window > 0 ? min(Sq - 1, c_last + window - 1 - q_offset)
                                : Sq - 1;
    const int qt_lo = i_lo / BQ;
    const int qt_hi = i_lo <= i_hi ? i_hi / BQ : -1;
    SpanWalk<SEG> walk(SEG ? spans_q + (size_t)b * nqt : nullptr, mine,
                       qt_lo, qt_hi);

    float dka[NDT][4], dva[NDT][4];
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

    // items (g, qt): the group's heads, each over the query tiles whose
    // span meets this key tile's
    auto load_item = [&](int g, int qt, int st) {
      const int h = kvh * G + g, i0 = qt * BQ;
      const size_t hq = ((size_t)b * Sq * H + h) * D;
      cp_async_rows<BQ, D, NT>(qs + st * BQ * LD, q + hq, i0, Sq, qstride,
                               tid);
      cp_async_rows<BQ, D, NT>(dos + st * BQ * LD, dout + hq, i0, Sq,
                               qstride, tid);
      if (tid < BQ) {
        const size_t r = ((size_t)b * H + h) * Sq + min(i0 + tid, Sq - 1);
        const bool ok = i0 + tid < Sq;
        cp_async4(lses + st * BQ + tid, lse + r, ok);
        cp_async4(dels + st * BQ + tid, delta + r, ok);
        if (SEG) cp_async4(sqs + st * BQ + tid, sq + min(i0 + tid, Sq - 1), ok);
      }
    };
    const int first_qt = walk.next(qt_lo);
    int g = 0, qt = first_qt;
    if (qt <= qt_hi) {
      cp_async_rows<BK, D, NT>(ks, kb, c0, Skv, kstride, tid);
      cp_async_rows<BK, D, NT>(vs, vb, c0, Skv, kstride, tid);
      load_item(g, qt, 0);
      cp_async_commit();
    } else {
      g = G;   // no query tile sees this key tile
    }
    for (int st = 0; g < G; st ^= 1) {
      int ng = g, nq = walk.next(qt + 1);
      if (nq > qt_hi) {
        ++ng;
        nq = first_qt;
      }
      if (ng < G) {
        load_item(ng, nq, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* qts = qs + st * BQ * LD;
      const T* dots = dos + st * BQ * LD;
      const float* lt = lses + st * BQ;
      const float* dlt = dels + st * BQ;
      const int* sqt = sqs + st * BQ;

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 16 queries
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
      mma_abt<NKS, 2, LD, false>(sc, no_frags, ks, rw * 16,
                                 qts + hf * 16 * LD, lane);
      mma_abt<NKS, 2, LD, false>(dp, no_frags, vs, rw * 16,
                                 dots + hf * 16 * LD, lane);

      // P^T and dS^T; this thread holds keys g8 (e = 0, 1) and g8 + 8
      // (e = 2, 3), queries hf * 16 + nt * 8 + 2 * t4 + (e & 1). Rows
      // past Sq are zero in Q and dO (and their lse and delta 0): they
      // add nothing
      const int i0 = qt * BQ;
      const int kp0 = c0 + rw * 16 + g8;
      const bool need_mask =
          SEG || (causal && c0 + BK - 1 > q_offset + i0) ||
          (window > 0 && c0 <= q_offset + i0 + BQ - 1 - window);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = hf * 16 + nt * 8 + 2 * t4;
        const float2 l2 = make_float2(lse_log2(lt[col]), lse_log2(lt[col + 1]));
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = col + (e & 1);
          float p, ds;
          pair_p_ds(sc[nt][e], dp[nt][e], (e & 1) ? l2.y : l2.x,
                    (e & 1) ? d2.y : d2.x, scale, softcap, &p, &ds);
          if (need_mask) {
            const int qp = q_offset + i0 + c;
            const int kp = kp0 + (e >> 1) * 8;
            const bool ok = (!causal || kp <= qp) &&
                            (window <= 0 || kp > qp - window) &&
                            (!SEG || sqt[c] == seg_key[e >> 1]);
            if (!ok) p = ds = 0.f;
          }
          sc[nt][e] = p;
          dp[nt][e] = ds;
        }
      }
      stage_x<2, LDP, kSplit<T>>(ph, pl, sc, rw * 16, hf * 16, lane);
      stage_x<2, LDP, kSplit<T>>(dsh, dsl, dp, rw * 16, hf * 16, lane);
      __syncthreads();  // the item's P and dS staged
      // this warp's half of dV += P^T dO and dK += dS^T Q
      mma_sb<BQ / 16, NDT, LDP, LD, kSplit<T>>(dva, ph, pl, rw * 16,
                                                dots + hf * HALF, lane);
      mma_sb<BQ / 16, NDT, LDP, LD, kSplit<T>>(dka, dsh, dsl, rw * 16,
                                                qts + hf * HALF, lane);
      __syncthreads();  // P, dS read; this stage is refilled two items on
      g = ng;
      qt = nq;
    }
    const size_t kbase = ((size_t)b * Skv * KV + kvh) * D + hf * HALF;
    store_rows<NDT>(dk + kbase, dka, scale, c0 + rw * 16, Skv, kstride,
                    lane);
    store_rows<NDT>(dv + kbase, dva, 1.f, c0 + rw * 16, Skv, kstride,
                    lane);
  }
}

struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  int2* spans;
  void *dq, *dk, *dv;
  const int *seg_q, *seg_k;
  int B, Sq, Skv, H, KV;
  float scale, softcap;
  int window, causal;
  cudaStream_t stream;
};

template <typename T, int D>
static int launch_first(const BwdArgs& a) {
  constexpr int rows = bwd_rows<D>(), threads = rows * bwd_tpr<D>();
  const int q_offset = a.Skv - a.Sq;
  const dim3 gq((a.Sq + rows - 1) / rows, a.H, a.B);
  auto* dq_kern = flash_bwd_dq_kernel<T, D>;
  BWD_LAUNCH(dq_kern, gq, dim3(threads), 0, a.stream,
             (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.out,
             (const T*)a.dout, a.lse, a.delta, (T*)a.dq, a.seg_q, a.seg_k,
             a.Sq, a.Skv, a.H, a.KV, a.scale, a.softcap, a.window, a.causal,
             q_offset);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 gk((a.Skv + rows - 1) / rows, a.KV, a.B);
  auto* kv_kern = flash_bwd_dkdv_kernel<T, D>;
  BWD_LAUNCH(kv_kern, gk, dim3(threads), 0, a.stream,
             (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
             a.lse, a.delta, (T*)a.dk, (T*)a.dv, a.seg_q, a.seg_k, a.Sq,
             a.Skv, a.H, a.KV, a.scale, a.softcap, a.window, a.causal,
             q_offset);
  return (int)cudaGetLastError();
}

template <typename Kern>
static cudaError_t opt_in_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;   // under the default cap
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// the [min, max] ids of each `tile`-row tile of ids [B, S]
static void launch_spans(const BwdArgs& a, const int* ids, int S, int tile,
                         int ntiles, int2* spans) {
  BWD_LAUNCH(flash_bwd_spans_kernel, dim3(ntiles, a.B), dim3(32), 0, a.stream,
             ids, S, tile, ntiles, spans);
}

template <typename T, int D, bool SEG>
static int launch_tc_seg(const BwdArgs& a) {
  constexpr int KBQ = kv_bq<D>();
  const int q_offset = a.Skv - a.Sq;
  const int nqt = (a.Sq + kBwdBQ - 1) / kBwdBQ;
  const int nkt = (a.Skv + kBwdBK - 1) / kBwdBK;
  const int nqt_kv = (a.Sq + KBQ - 1) / KBQ;
  int2 *spans_k = nullptr, *spans_q = nullptr;
  cudaError_t err;
  if constexpr (SEG) {   // key tiles of the dq kernel, query tiles of dk/dv
    spans_k = a.spans;
    spans_q = a.spans + (size_t)a.B * nkt;
    launch_spans(a, a.seg_k, a.Skv, kBwdBK, nkt, spans_k);
    launch_spans(a, a.seg_q, a.Sq, KBQ, nqt_kv, spans_q);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  constexpr size_t smem_dq = dq_smem_bytes<T, D>();
  auto* dq_kern = flash_bwd_dq_tc_kernel<T, D, SEG>;
  if ((err = opt_in_smem(dq_kern, smem_dq)) != cudaSuccess) return (int)err;
  BWD_LAUNCH(dq_kern,
             dim3((nqt + 1) / 2, a.H, a.B), dim3(kBwdThreads), smem_dq,
             a.stream, (const T*)a.q, (const T*)a.k, (const T*)a.v,
             (const T*)a.out, (const T*)a.dout, a.lse, a.delta, (T*)a.dq,
             a.seg_q, a.seg_k, spans_k, a.Sq, a.Skv, a.H, a.KV, a.scale,
             a.softcap, a.window, a.causal, q_offset);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  constexpr size_t smem_kv = dkdv_smem_bytes<T, D>();
  auto* kv_kern = flash_bwd_dkdv_tc_kernel<T, D, SEG>;
  if ((err = opt_in_smem(kv_kern, smem_kv)) != cudaSuccess) return (int)err;
  BWD_LAUNCH(kv_kern,
             dim3((nkt + 1) / 2, a.KV, a.B), dim3(kBwdThreads), smem_kv,
             a.stream, (const T*)a.q, (const T*)a.k, (const T*)a.v,
             (const T*)a.dout, a.lse, a.delta, (T*)a.dk, (T*)a.dv, a.seg_q,
             a.seg_k, spans_q, a.Sq, a.Skv, a.H, a.KV, a.scale, a.softcap,
             a.window, a.causal, q_offset);
  return (int)cudaGetLastError();
}

// head_dim 256 in bf16 / f16: the eight-warp bodies; with ids the spans
// of 32-row tiles (the dq kernel's key tiles, the dk/dv kernel's query
// tiles)
template <typename T, int D, bool SEG>
static int launch_wide_seg(const BwdArgs& a) {
  const int q_offset = a.Skv - a.Sq;
  const int nqb = (a.Sq + kWideRows - 1) / kWideRows;    // dq blocks' tiles
  const int nkb = (a.Skv + kWideRows - 1) / kWideRows;   // dk/dv blocks'
  const int nkt = (a.Skv + kWideTile - 1) / kWideTile;   // walked by dq
  const int nqt = (a.Sq + kWideTile - 1) / kWideTile;    // walked by dk/dv
  int2 *spans_k = nullptr, *spans_q = nullptr;
  cudaError_t err;
  if constexpr (SEG) {
    spans_k = a.spans;
    spans_q = a.spans + (size_t)a.B * nkt;
    launch_spans(a, a.seg_k, a.Skv, kWideTile, nkt, spans_k);
    launch_spans(a, a.seg_q, a.Sq, kWideTile, nqt, spans_q);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  constexpr size_t smem_dq = dq_wide_smem_bytes<T, D>();
  auto* dq_kern = flash_bwd_dq_wide_tc_kernel<T, D, SEG>;
  if ((err = opt_in_smem(dq_kern, smem_dq)) != cudaSuccess) return (int)err;
  BWD_LAUNCH(dq_kern,
             dim3((nqb + 1) / 2, a.H, a.B), dim3(kWideThreads), smem_dq,
             a.stream, (const T*)a.q, (const T*)a.k, (const T*)a.v,
             (const T*)a.out, (const T*)a.dout, a.lse, a.delta, (T*)a.dq,
             a.seg_q, a.seg_k, spans_k, a.Sq, a.Skv, a.H, a.KV, a.scale,
             a.softcap, a.window, a.causal, q_offset);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  constexpr size_t smem_kv = dkdv_wide_smem_bytes<T, D>();
  auto* kv_kern = flash_bwd_dkdv_wide_tc_kernel<T, D, SEG>;
  if ((err = opt_in_smem(kv_kern, smem_kv)) != cudaSuccess) return (int)err;
  BWD_LAUNCH(kv_kern,
             dim3((nkb + 1) / 2, a.KV, a.B), dim3(kWideThreads), smem_kv,
             a.stream, (const T*)a.q, (const T*)a.k, (const T*)a.v,
             (const T*)a.dout, a.lse, a.delta, (T*)a.dk, (T*)a.dv, a.seg_q,
             a.seg_k, spans_q, a.Sq, a.Skv, a.H, a.KV, a.scale, a.softcap,
             a.window, a.causal, q_offset);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_d(const BwdArgs& a) {
  if constexpr (sizeof(T) == 4)
    return launch_first<T, D>(a);
  else if constexpr (D >= 256)
    return a.seg_k ? launch_wide_seg<T, D, true>(a)
                   : launch_wide_seg<T, D, false>(a);
  else
    return a.seg_k ? launch_tc_seg<T, D, true>(a)
                   : launch_tc_seg<T, D, false>(a);
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

// delta: float32 scratch [B,H,Sq], written by the dq kernel; spans:
// int32 scratch of 2 * B * (ceil(Sq / 32) + ceil(Skv / 32)) words (the
// ids' tile spans), read only with segment ids
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* spans, void* dq,
    void* dk, void* dv, const void* seg_q, const void* seg_k, int B, int Sq,
    int Skv, int H, int KV, int D, float scale, float softcap, int window,
    int causal, int dtype, void* stream) {
  if ((seg_q == nullptr) != (seg_k == nullptr) ||
      (seg_q != nullptr && spans == nullptr))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, out, dout, (const float*)lse, (float*)delta,
                  (int2*)spans, dq, dk, dv, (const int*)seg_q,
                  (const int*)seg_k, B, Sq, Skv, H, KV, scale, softcap,
                  window, causal, (cudaStream_t)stream};
  switch (dtype) {
    case kF32: return launch<float>(a, D);
    case kBF16: return launch<__nv_bfloat16>(a, D);
    case kF16: return launch<__half>(a, D);
  }
  return (int)cudaErrorInvalidValue;
}
