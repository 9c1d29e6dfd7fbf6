// Causal / sliding-window / softcapped GQA flash attention for Hopper
// (sm_90a): the prefill attention of the serving path.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (`flash_attention`, body `_fa_kernel`): q [B,Sq,H,D] over k/v
// [B,Skv,KV,D] -> [B,Sq,H,D], causal masking right-aligned (query row i
// sits at position i + Skv - Sq), optional window, softcap and
// bidirectional attention, KV head = h // (H/KV), float32 statistics.
// Optional segment ids seg_q [B,Sq] / seg_k [B,Skv] (int32; null: no
// mask) restrict query row i to keys j with seg_q[i] == seg_k[j]: packed
// sequences, and cross-attention's valid source frames (the decoder's
// cross-attention runs here on every decode step, Sq = 1). The Pallas
// kernel raises on segments and the reference sends them to its blocked
// jnp lowering (repro/kernels/ops.py:36-52); here they are one more term
// of the same mask, and no KV tile is skipped because of them.
//
// What bounds it: arithmetic. Causal prefill does ~2*Sq*Skv*D
// multiply-adds per head (about half of them masked away by the tile
// skip): at Sq = Skv = 1000, H = 32, D = 64 that is ~4 GFLOP against
// ~10 MB moved, hundreds of flops per byte, so the work belongs on the
// tensor cores (989 TFLOP/s bf16/f16 dense).
//
// Two hand-written bodies, chosen by dtype:
// - bf16 / f16 (the serving path): `flash_attention_tc_kernel`. Four
//   warps per block, each owning 16 rows of a 64-row q tile of one q
//   head. Q K^T and P V run on the tensor cores as mma.sync.m16n8k16
//   with f32 accumulators, operands from shared memory through ldmatrix
//   (.trans for V). K/V tiles of 64 rows are double-buffered with
//   16-byte cp.async, so tile j+1 loads while tile j is multiplied;
//   shared rows are padded by 16 bytes so the eight row addresses of
//   each ldmatrix fall in distinct bank groups. The online softmax
//   stays in registers in the FA2 layout: each thread holds two rows'
//   scores, row max and sum reduce over the quad by shuffles, and the
//   accumulator is rescaled once per KV tile. P is rounded to the input
//   type for the P V product (as FA2 does). Each block takes q tiles p
//   and nqt-1-p in turn, so under causal masking every block walks
//   nqt + 1 KV tiles and no block is left running alone at the end.
// - f32: `flash_attention_f32_kernel`, on the CUDA cores: TF32 tensor
//   cores would not meet the f32 tolerance (1e-4). One thread per query
//   row (four at D = 256, where a row's q and accumulator, 512 floats,
//   would spill from registers), K/V staged as f32, the softmax rescaled
//   when a row's max grows.
// Both: KV tiles wholly past the causal frontier or below the window
// are never loaded (the Pallas kernel's skipped grid steps), positions
// >= Skv are masked (prompts need no padding), and a row with no valid
// key (Sq > Skv, or no key of its segment) returns 0.
// Optional lse [B,H,Sq] float32 (null on every serving call): the row's
// log-sum-exp m + log(l) of the scaled, softcapped logits, -inf for a
// row with no valid key, which the training path saves for the
// backward kernel (flash_attention_bwd.cu). Both bodies hold m and l in
// registers at the end of the row, so it costs one store a row.
// Segment ids and lse are template parameters of both bodies (SEG, LSE),
// the instantiation chosen from the null-ness of their pointers: the
// one without them (every serving prefill) carries no id register, no
// id term in the mask and no lse store. As runtime operands they cost
// the no-ids calls 1.6-2.0x on the card (H100, tensor-core body).
//
// What is left: wgmma with TMA loads and a producer warp. mma.sync
// issues one 16x8x16 product per instruction per warp and bounds this
// body well below the card's peak; tried on the card and slower here
// at S = 1000: two 16-row m-tiles per warp (247 registers, fewer
// resident warps), two q heads per block sharing K/V tiles, 128-row
// K/V tiles.
#include "common.cuh"

// ---- the float32 body: CUDA cores, TPR threads per query row ----------
constexpr int kBQ = 64;  // query rows per block

// threads per query row: one, or four at D = 256. A row's threads hold
// every TPR-th element of its q and accumulator (so their shared-memory
// reads of one K/V row fall in distinct banks) and sum the dot products
// by shuffles within the row's group of lanes
template <int D>
__host__ __device__ constexpr int f32_tpr() { return D >= 256 ? 4 : 1; }

template <typename T, int D, bool SEG, bool LSE>
__global__ void __launch_bounds__(kBQ * f32_tpr<D>())
    flash_attention_f32_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    float* __restrict__ lse, int Sq, int Skv, int H, int KV, float scale,
    float softcap, int window, int causal, int q_offset) {
  constexpr int TPR = f32_tpr<D>();
  constexpr int DP = D / TPR;       // elements of a row a thread holds
  constexpr int NT = kBQ * TPR;     // threads
  // 2 x BK x D floats of static shared memory, under the 48 KB cap
  constexpr int BK = D <= 64 ? 64 : D <= 128 ? 32 : 16;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  __shared__ int segs[SEG ? BK : 1];   // the tile's key segment ids
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int r0 = blockIdx.x * kBQ;
  const int row = r0 + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;   // holds elements part + TPR * i
  const unsigned group = ((1u << TPR) - 1u)
                         << ((threadIdx.x & 31) & ~(TPR - 1));
  const bool live_row = row < Sq;
  const int qpos = q_offset + row;
  // the row's segment (one value for the TPR threads of a row, so the
  // skip below keeps their shuffles converged)
  const int* sk = SEG ? seg_k + (size_t)b * Skv : nullptr;
  const int seg_row = SEG && live_row ? seg_q[(size_t)b * Sq + row] : 0;

  float qr[DP], acc[DP];
  if (live_row) {
    const T* qp = q + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) qr[i] = to_f32(qp[part + TPR * i]) * scale;
  }
#pragma unroll
  for (int i = 0; i < DP; ++i) acc[i] = 0.f;
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
    for (int idx = threadIdx.x; idx < nk * D; idx += NT) {
      const int t = idx / D, d = idx - t * D;
      const size_t off = (((size_t)b * Skv + k0 + t) * KV + kvh) * D + d;
      ks[t][d] = to_f32(k[off]);
      vs[t][d] = to_f32(v[off]);
    }
    if (SEG)
      for (int t = threadIdx.x; t < nk; t += NT) segs[t] = sk[k0 + t];
    __syncthreads();
    if (!live_row) continue;
    const int t_lo = max(0, k_lo - k0);
    const int t_hi = min(nk - 1, k_hi - k0);
    for (int t = t_lo; t <= t_hi; ++t) {
      if (SEG && segs[t] != seg_row) continue;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) s += qr[i] * ks[t][part + TPR * i];
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) s += __shfl_xor_sync(group, s, o);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      if (s > m) {
        const float a = expf(m - s);
        l *= a;
#pragma unroll
        for (int i = 0; i < DP; ++i) acc[i] *= a;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] += p * vs[t][part + TPR * i];
    }
  }
  if (live_row) {
    T* op = out + (((size_t)b * Sq + row) * H + h) * D;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DP; ++i)
      op[part + TPR * i] = from_f32<T>(acc[i] * inv);
    if (LSE && part == 0)
      lse[((size_t)b * H + h) * Sq + row] =
          l > 0.f ? m + logf(l) : REPRO_MASKED;
  }
}


// ---- the bf16 / f16 body: tensor cores ----------------------------------
constexpr int kTcBQ = 64;       // q rows per tile: four warps of 16
constexpr int kTcBK = 64;       // K/V rows per tile
constexpr int kTcThreads = 128;

template <typename T, int D>
constexpr size_t tc_smem_bytes() {  // Q + two stages of K and V
  return (size_t)(kTcBQ + 4 * kTcBK) * (D + 8) * sizeof(T);
}

template <typename T, int D, bool SEG, bool LSE>
__global__ void __launch_bounds__(kTcThreads) flash_attention_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    float* __restrict__ lse, int Sq, int Skv, int H, int KV, float scale,
    float softcap, int window, int causal, int q_offset) {
  constexpr int BQ = kTcBQ, BK = kTcBK;
  constexpr int NNT = BK / 8;   // 8-wide key tiles of S
  constexpr int LD = D + 8;     // padded shared row (elements)
  constexpr int NKS = D / 16;   // k-steps of Q K^T
  constexpr int NDT = D / 8;    // 8-wide column tiles of the output
  constexpr float kLog2e = 1.4426950408889634f;
  // the Q fragments stay in registers up to D = 128; at D = 256 the
  // 16x256 f32 output tile alone takes 128 registers a thread, so they
  // are read from shared memory (Q stays there for the tile) each k-step
  constexpr bool kQInRegs = D <= 128;
  static_assert(NDT % 2 == 0, "pairs of 8-wide output tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* ks = qs + BQ * LD;                    // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;                // [2][BK][LD]

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;  // fragment row, column pair
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Skv * KV + kvh) * D;
  const T* vb = v + ((size_t)b * Skv * KV + kvh) * D;
  const int* sk = SEG ? seg_k + (size_t)b * Skv : nullptr;

  // q tiles p and nqt-1-p: under causal masking every block then walks
  // nqt + 1 KV tiles, so the blocks finish together
  const int nqt = (Sq + BQ - 1) / BQ;
  const int heavy = nqt - 1 - blockIdx.x, light = blockIdx.x;
#pragma unroll 1
  for (int rep = 0; rep < 2; ++rep) {
    if (rep == 1) {
      if (light >= heavy) break;
      __syncthreads();  // the first tile's Q is no longer read
    }
    const int r0 = (rep == 0 ? heavy : light) * BQ;

    // KV tiles this q tile can see
    const int r_last = min(r0 + BQ, Sq) - 1;
    const int hi_pos = causal ? min(Skv - 1, q_offset + r_last) : Skv - 1;
    const int lo_pos = window > 0 ? max(0, q_offset + r0 - window + 1) : 0;
    const int kt_lo = lo_pos / BK;
    const int kt_hi = hi_pos < 0 ? -1 : hi_pos / BK;
    // segment ids of this thread's two rows (g8 and g8 + 8)
    int seg_row[2] = {0, 0};
    if constexpr (SEG) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + warp * 16 + g8 + 8 * i;
        seg_row[i] = row < Sq ? seg_q[(size_t)b * Sq + row] : 0;
      }
    }

    float o[NDT][4];
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    float mrow[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, lrow[2] = {0.f, 0.f};
    uint32_t qf[kQInRegs ? NKS : 1][4];

    if (kt_lo <= kt_hi) {
      cp_async_rows<BQ, D, kTcThreads>(qs, qb, r0, Sq, (size_t)H * D, tid);
      cp_async_rows<BK, D, kTcThreads>(ks, kb, kt_lo * BK, Skv,
                                       (size_t)KV * D, tid);
      cp_async_rows<BK, D, kTcThreads>(vs, vb, kt_lo * BK, Skv,
                                       (size_t)KV * D, tid);
      cp_async_commit();
    }
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
      const int st = (kt - kt_lo) & 1;
      if (kt < kt_hi) {
        cp_async_rows<BK, D, kTcThreads>(ks + (st ^ 1) * BK * LD, kb,
                                         (kt + 1) * BK, Skv, (size_t)KV * D,
                                         tid);
        cp_async_rows<BK, D, kTcThreads>(vs + (st ^ 1) * BK * LD, vb,
                                         (kt + 1) * BK, Skv, (size_t)KV * D,
                                         tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (kQInRegs && kt == kt_lo) {
#pragma unroll
        for (int s = 0; s < NKS; ++s)
          ldsm_x4(qf[kQInRegs ? s : 0],
                  qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                      s * 16 + (lane >> 4) * 8);
      }
      const T* kts = ks + st * BK * LD;
      const T* vts = vs + st * BK * LD;

      // S = Q K^T: this warp's 16 rows x BK keys, tiles of 16x8
      float sc[NNT][4];
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt)
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int s = 0; s < NKS; ++s) {
        if constexpr (!kQInRegs)
          ldsm_x4(qf[0], qs + (warp * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * LD +
                             s * 16 + (lane >> 4) * 8);
        const uint32_t* qa = qf[kQInRegs ? s : 0];
#pragma unroll
        for (int np = 0; np < NNT / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, kts + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                          s * 16 + ((lane >> 3) & 1) * 8);
          Mma<T>::run(sc[2 * np], qa, bb[0], bb[1]);
          Mma<T>::run(sc[2 * np + 1], qa, bb[2], bb[3]);
        }
      }

      // online softmax in registers (log2 units); this thread holds
      // rows g8 (e = 0, 1) and g8 + 8 (e = 2, 3) of the warp's 16
      const int k0 = kt * BK;
      const int qp0 = q_offset + r0 + warp * 16 + g8;
      const bool need_mask = SEG || k0 + BK > Skv ||
                             (causal && k0 + BK - 1 > q_offset + r0) ||
                             (window > 0 && k0 < q_offset + r0 + BQ - window);
      float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[nt][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          x *= kLog2e;
          if (need_mask) {
            const int kp = k0 + nt * 8 + 2 * t4 + (e & 1);
            const int qp = qp0 + (e >> 1) * 8;
            const bool ok = kp < Skv && (!causal || kp <= qp) &&
                            (window <= 0 || kp > qp - window) &&
                            (!SEG || __ldg(sk + kp) == seg_row[e >> 1]);
            if (!ok) x = REPRO_MASKED;
          }
          sc[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float alpha = exp2f(mrow[i] - mx[i]);
        mrow[i] = mx[i];
        lrow[i] *= alpha;
#pragma unroll
        for (int dt = 0; dt < NDT; ++dt) {
          o[dt][2 * i] *= alpha;
          o[dt][2 * i + 1] *= alpha;
        }
      }
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[nt][e] - mrow[e >> 1]);
          sc[nt][e] = p;
          lrow[e >> 1] += p;
        }
      }

      // O += P V: P's accumulator layout is the A operand's, 16 keys a
      // step
#pragma unroll
      for (int j = 0; j < NNT / 2; ++j) {
        const uint32_t a[4] = {
            Mma<T>::pack(sc[2 * j][0], sc[2 * j][1]),
            Mma<T>::pack(sc[2 * j][2], sc[2 * j][3]),
            Mma<T>::pack(sc[2 * j + 1][0], sc[2 * j + 1][1]),
            Mma<T>::pack(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
        for (int dp = 0; dp < NDT / 2; ++dp) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, vts + (j * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * LD +
                                dp * 16 + (lane >> 4) * 8);
          Mma<T>::run(o[2 * dp], a, bb[0], bb[1]);
          Mma<T>::run(o[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
      __syncthreads();  // this stage is refilled two tiles on
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = lrow[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float inv = 1.f / fmaxf(li, 1e-30f);
      const int row = r0 + warp * 16 + g8 + 8 * i;
      if (row >= Sq) continue;
      if (LSE && t4 == 0)   // m is in log2 units
        lse[((size_t)b * H + h) * Sq + row] =
            li > 0.f ? (mrow[i] + log2f(li)) * 0.6931471805599453f
                     : REPRO_MASKED;
      uint32_t* op = reinterpret_cast<uint32_t*>(
          out + (((size_t)b * Sq + row) * H + h) * D + 2 * t4);
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt)
        op[dt * 4] = Mma<T>::pack(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
    }
  }
}

// the launchers' common arguments past the element type and head_dim
struct Args {
  const void *q, *k, *v;
  void* out;
  const int *seg_q, *seg_k;
  float* lse;
  int B, Sq, Skv, H, KV;
  float scale, softcap;
  int window, causal;
  cudaStream_t stream;
};

template <typename T, int D, bool SEG, bool LSE>
static int launch_f32_v(const Args& a) {
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  constexpr int threads = kBQ * f32_tpr<D>();
  flash_attention_f32_kernel<T, D, SEG, LSE><<<grid, threads, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out, a.seg_q,
      a.seg_k, a.lse, a.Sq, a.Skv, a.H, a.KV, a.scale, a.softcap, a.window,
      a.causal, a.Skv - a.Sq);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool SEG, bool LSE>
static int launch_tc_v(const Args& a) {
  constexpr size_t smem = tc_smem_bytes<T, D>();
  if (smem > 48 * 1024) {  // above the default cap: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc_kernel<T, D, SEG, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nqt = (a.Sq + kTcBQ - 1) / kTcBQ;
  dim3 grid((nqt + 1) / 2, a.H, a.B);  // two q tiles per block
  flash_attention_tc_kernel<T, D, SEG, LSE>
      <<<grid, kTcThreads, smem, a.stream>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out, a.seg_q,
          a.seg_k, a.lse, a.Sq, a.Skv, a.H, a.KV, a.scale, a.softcap,
          a.window, a.causal, a.Skv - a.Sq);
  return (int)cudaGetLastError();
}

template <typename T, bool TC, int D, bool SEG, bool LSE>
static int launch_v(const Args& a) {
  if constexpr (TC)
    return launch_tc_v<T, D, SEG, LSE>(a);
  else
    return launch_f32_v<T, D, SEG, LSE>(a);
}

// the instantiation from the null-ness of the ids and lse pointers
template <typename T, bool TC, int D>
static int launch_body(const Args& a) {
  const bool seg = a.seg_k != nullptr, lse = a.lse != nullptr;
  if (seg)
    return lse ? launch_v<T, TC, D, true, true>(a)
               : launch_v<T, TC, D, true, false>(a);
  return lse ? launch_v<T, TC, D, false, true>(a)
             : launch_v<T, TC, D, false, false>(a);
}

template <typename T, bool TC>
static int launch(const Args& a, int D) {
  switch (D) {
    case 16: return launch_body<T, TC, 16>(a);
    case 32: return launch_body<T, TC, 32>(a);
    case 64: return launch_body<T, TC, 64>(a);
    case 128: return launch_body<T, TC, 128>(a);
    case 256: return launch_body<T, TC, 256>(a);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* seg_q, const void* seg_k, void* lse, int B, int Sq, int Skv,
    int H, int KV, int D, float scale, float softcap, int window,
    int causal, int dtype, void* stream) {
  if ((seg_q == nullptr) != (seg_k == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, (const int*)seg_q, (const int*)seg_k,
               (float*)lse, B, Sq, Skv, H, KV, scale, softcap, window,
               causal, (cudaStream_t)stream};
  switch (dtype) {
    case kF32: return launch<float, false>(a, D);
    case kBF16: return launch<__nv_bfloat16, true>(a, D);
    case kF16: return launch<__half, true>(a, D);
  }
  return (int)cudaErrorInvalidValue;
}
