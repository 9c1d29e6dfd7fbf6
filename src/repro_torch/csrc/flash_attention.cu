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
// of the same mask, and the tensor-core bodies skip every key tile whose
// ids cannot meet the q tile's (below).
//
// What bounds it: arithmetic. Causal prefill does ~2*Sq*Skv*D
// multiply-adds per head (about half of them masked away by the tile
// skip): at Sq = Skv = 1000, H = 32, D = 64 that is ~4 GFLOP against
// ~10 MB moved, hundreds of flops per byte, so the work belongs on the
// tensor cores (989 TFLOP/s bf16/f16 dense).
//
// Three hand-written bodies, chosen by dtype and head_dim:
// - bf16 / f16 at head_dim 16-128 (the serving path):
//   `flash_attention_tc_kernel`. Four warps per block, each owning 16
//   rows of a 64-row q tile of one q head. Q K^T and P V run on the
//   tensor cores as mma.sync.m16n8k16 with f32 accumulators, operands
//   from shared memory through ldmatrix (.trans for V). K/V tiles of 64
//   rows are double-buffered with 16-byte cp.async, so tile j+1 loads
//   while tile j is multiplied; shared rows are padded by 16 bytes so
//   the eight row addresses of each ldmatrix fall in distinct bank
//   groups. The online softmax stays in registers in the FA2 layout:
//   each thread holds two rows' scores, row max and sum reduce over the
//   quad by shuffles, and the accumulator is rescaled once per KV tile.
//   P is rounded to the input type for the P V product (as FA2 does).
//   Each block takes q tiles p and nqt-1-p in turn, so under causal
//   masking every block walks nqt + 1 KV tiles and no block is left
//   running alone at the end.
// - bf16 / f16 at head_dim 256 (gemma2): `flash_attention_wide_tc_kernel`,
//   eight warps over a 64-row q tile (see "head_dim 256" below): four
//   warps of 16 rows would each hold a 16 x 256 f32 output tile (128
//   registers a thread) and fit one 128-thread block an SM.
// - f32: `flash_attention_f32_kernel`, on the CUDA cores: TF32 tensor
//   cores would not meet the f32 tolerance (1e-4). One thread per query
//   row (four at D = 256, where a row's q and accumulator, 512 floats,
//   would spill from registers), K/V staged as f32, the softmax rescaled
//   when a row's max grows.
// All: KV tiles wholly past the causal frontier or below the window
// are never loaded (the Pallas kernel's skipped grid steps), positions
// >= Skv are masked (prompts need no padding), and a row with no valid
// key (Sq > Skv, or no key of its segment) returns 0.
// Segment-id tile skip (the tensor-core bodies): a q tile reduces its
// rows' ids to [min, max] once, and a key tile whose [min, max] does
// not meet it is neither loaded nor multiplied (`KeyTileWalk`). The
// key tiles' spans are reduced inside the launch, 32 candidate tiles at
// a time, so a call stays one launch with no scratch (seamless's
// cross-attention runs it inside CUDA graphs). A skipped tile holds no
// pair of equal ids, so every entry of it is masked: run, it would add
// p = 0 with alpha = 1, so skipping it leaves out and lse bit-identical
// whatever the tiles' spans (ids relabelled keep the output). For
// packed nondecreasing ids (make_batch's documents) it drops about
// three quarters of the causal tiles at 1024 tokens.
// Optional lse [B,H,Sq] float32 (null on every serving call): the row's
// log-sum-exp m + log(l) of the scaled, softcapped logits, -inf for a
// row with no valid key, which the training path saves for the
// backward kernel (flash_attention_bwd.cu). The bodies hold m and l in
// registers at the end of the row, so it costs one store a row.
// Segment ids and lse are template parameters of the bodies (SEG, LSE),
// the instantiation chosen from the null-ness of their pointers: the
// one without them (every serving prefill) carries no id register, no
// id term in the mask, no tile skip and no lse store. As runtime
// operands they cost the no-ids calls 1.6-2.0x on the card (H100,
// tensor-core body).
//
// head_dim 256, bf16 / f16: eight warps a block in a 4 x 2 grid, warp w
// taking the 16-row group rw = w % 4 and the half hf = w / 4, over
// 32-row K/V tiles. S = Q K^T: each warp its 16 rows x the 16 columns
// hf*16.. of the tile, along the full D (Q re-read from shared memory
// by ldmatrix at each k-step), so no product runs twice. Softmax: the
// two halves of a row exchange their maxima through shared memory (the
// max is exact, so both compute the same m and alpha) and keep partial
// sums, added through shared memory at the end of the q tile. P: each
// warp stages its 16 x 16 block, rounded to the input type (as the
// head_dim 16-128 body rounds it), and after a barrier reads its 16
// rows x 32 back as A fragments. O += P V: each warp its 128 columns of
// D, 16 tiles x 4 = 64 f32 registers. The next tile's cp.async is
// issued after the barrier that follows this tile's wait, so that
// barrier also frees the other stage, P and the maxima: three
// barriers a tile. The tile skip is the one above, over 32-row spans;
// the q tile's ids wait in shared memory for the mask.
// Resources a block:
//   shared: Q 64 x 264 x 2 = 33,792 B; K, V two stages 4 x 32 x 264 x 2
//   = 67,584; P 64 x 40 x 2 = 5,120; key ids two stages 256; maxima and
//   sums 2 x 2 x 64 x 4 = 1,024: 107,776 B dynamic, and 352 B static
//   (the q tile's ids, the span words), so two blocks (16 warps) an SM
//   fit in its 228 KB.
//   registers: O 64, S 8, m and l 4, a Q and a K fragment 8, ids and
//   addresses; `__launch_bounds__(256, 2)` caps them at 128 a thread
//   (two blocks x 256 threads x 128 = the SM's 65,536); ptxas uses all
//   128 and spills nothing (chip_smoke.check_wide_spills holds that).
//   blocks (two q tiles each): B=1 S=1000 H=16: 8 x 16 = 128, one an
//   SM on 132 SMs; B=8 S=1024 H=16: 8 x 16 x 8 = 1,024, ~3.9 waves of
//   two an SM.
// Where a tile's cycles go (tools/flash_fwd_probe.py --variants trace,
// one block at S 1000, H100): ~3,800 cycles, of which Q K^T's 256
// ldmatrix of the block ~1,200, P V's 144 ~700, the next tile's 64
// cp.async issues ~700, the logits ~700: the shared-memory pipe
// (ldmatrix and cp.async share it) bounds the body, not the tensor
// cores. Tried there and not faster: 64-row K/V tiles (one block an
// SM), Q's fragments in registers, 128-row q tiles in 16 warps, one q
// tile a block, the prefetch moved, two accumulators a column tile.
//
// What is left: wgmma with TMA loads and a producer warp. mma.sync
// issues one 16x8x16 product per instruction per warp and bounds these
// bodies well below the card's peak; tried on the card and slower at
// head_dim 64 at S = 1000: two 16-row m-tiles per warp (247 registers,
// fewer resident warps), two q heads per block sharing K/V tiles,
// 128-row K/V tiles. At head_dim 256 TMA would take the cp.async
// issues off the shared-memory pipe.
//
// The launches go through BWD_LAUNCH and the shared memory through
// BWD_SMEM, so the file also builds with g++ against
// host_emulation.cuh (tools/flash_fwd_host_check.py).
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


// ---- the tensor-core bodies' logits ----------------------------------
// s * scale, softcapped (cap * tanh(s * scale / cap)), in log2 units, with
// no branch: c (1 - 2 / (2^(s k) + 1)) for c = cap log2(e) and k = 2 scale
// log2(e) / cap (2^(s k) = inf gives c, 0 gives -c). tanhf and the IEEE
// division by the cap branch on the value: they took a quarter of the
// head_dim 256 body's cycles a tile (tools/flash_fwd_probe.py --variants
// trace). This form's error, a few ulp of c, is far inside the lse's
// 1e-4.
struct LogitLog2 {
  float mul, cap, two_cap, k;
  __device__ LogitLog2(float scale, float softcap) {
    constexpr float kLog2e = 1.4426950408889634f;
    mul = scale * kLog2e;
    cap = softcap > 0.f ? softcap * kLog2e : 0.f;
    two_cap = 2.f * cap;
    k = softcap > 0.f ? 2.f * mul / softcap : 0.f;
  }
  // every raw product of S in place; one branch on the softcap, outside
  // the loop (a select per element would pay the softcap's exp2 and
  // reciprocal on every logit of a call without one)
  template <int N>
  __device__ __forceinline__ void apply(float (*sc)[4]) const {
    if (cap > 0.f) {
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = cap - __fdividef(two_cap, exp2f(sc[n][e] * k) + 1.f);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] *= mul;
    }
  }
};

// ---- the segment-id tile skip of the tensor-core bodies ---------------
// The q tile's span: each warp's [min, max] of its threads' live rows'
// ids into red[warp] (every thread passes its two rows; the halves of
// the head_dim 256 body pass the same rows twice), then a barrier; the
// walk's scan takes their union (span_union) when it needs it, so no
// register holds the span across the tile loop
__device__ __forceinline__ void q_tile_spans(const int* id, const bool* live,
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
}

template <int NW>
__device__ __forceinline__ int2 span_union(const int2* red) {
  int2 m = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) {
    m.x = min(m.x, red[w].x);
    m.y = max(m.y, red[w].y);
  }
  return m;
}

// The key tiles [lo, hi] of one q tile, in order, skipping with ids
// (SEG) every tile whose span does not meet the q tile's (the union of
// `red`, q_tile_spans). The
// spans are reduced here, 32 candidate tiles at a time: warp w reads
// the ids of tiles base + w*TPW .. + TPW-1 (one coalesced 128-byte row
// of ids a load), reduces each tile's min and max over the warp, and
// the block shares the answers as one word of bits through `words`
// [NT / 32] in shared memory. Every thread of the block calls next()
// with the same t and arguments; a scan holds two barriers. The walk
// keeps only its window of 32 tiles (the rest is the caller's, so no
// register holds a copy across the loop). SEG false: every tile,
// nothing read.
template <bool SEG, int NT, int BK>
struct KeyTileWalk {
  static constexpr int NW = NT / 32;         // warps
  static constexpr int TPW = 32 / NW;        // tiles a warp reduces
  static constexpr int IPL = TPW * BK / 32;  // ids a lane reads
  static_assert(BK % 32 == 0 && 32 % NW == 0, "a tile is whole loads");
  int base;          // the window's first tile
  unsigned bits;     // bit i: tile base + i meets

  __device__ explicit KeyTileWalk(int lo) : base(lo - 64), bits(0u) {}

  // the first tile >= t of [lo, hi] whose ids (of ids[0, skv)) meet
  // the q tile's; hi + 1 if none
  __device__ int next(int t, int lo, int hi, const int* ids, int skv,
                      const int2* red, unsigned* words) {
    if constexpr (!SEG) return t;
    while (t <= hi) {
      if (t < base || t >= base + 32) {
        base = lo + ((t - lo) & ~31);
        bits = scan(hi, ids, skv, red, words);
      }
      const unsigned m = bits >> (t - base);
      if (m) return t + __ffs(m) - 1;
      t = base + 32;
    }
    return hi + 1;
  }

  __device__ unsigned scan(int hi, const int* ids, int skv,
                           const int2* red, unsigned* words) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int2 mine = span_union<NW>(red);
    const int t0 = base + warp * TPW;   // this warp's first tile
    int mn[TPW], mx[TPW];
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      mn[j] = 0x7fffffff;
      mx[j] = (int)0x80000000;
    }
#pragma unroll
    for (int i = 0; i < IPL; ++i) {
      const int j = i * 32 / BK;             // the tile of this load
      const int kp = t0 * BK + i * 32 + lane;
      if (t0 + j <= hi && kp < skv) {
        const int id = __ldg(ids + kp);
        mn[j] = min(mn[j], id);
        mx[j] = max(mx[j], id);
      }
    }
    unsigned piece = 0u;
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int a = __reduce_min_sync(0xffffffffu, mn[j]);
      const int z = __reduce_max_sync(0xffffffffu, mx[j]);
      if (max(a, mine.x) <= min(z, mine.y)) piece |= 1u << j;
    }
    __syncthreads();   // the previous scan's words are read
    if (lane == 0) words[warp] = piece;
    __syncthreads();
    unsigned all = 0u;
#pragma unroll
    for (int w = 0; w < NW; ++w) all |= words[w] << (w * TPW);
    return all;
  }
};

// the causal / window cut: the key tiles [kt_lo, kt_hi] of `bk` rows a
// q tile [r0, r0 + bq) can see
struct TileRange {
  int lo, hi;
  __device__ TileRange(int r0, int bq, int bk, int Sq, int Skv, int window,
                       int causal, int q_offset) {
    const int r_last = min(r0 + bq, Sq) - 1;
    const int hi_pos = causal ? min(Skv - 1, q_offset + r_last) : Skv - 1;
    const int lo_pos = window > 0 ? max(0, q_offset + r0 - window + 1) : 0;
    lo = lo_pos / bk;
    hi = hi_pos < 0 ? -1 : hi_pos / bk;
  }
};

// the segment ids of rows r and r + 8 from `row0` (0 past Sq) and
// whether each is a row
template <bool SEG>
__device__ __forceinline__ void row_ids(const int* seg_q, int b, int Sq,
                                        int row0, int* id, bool* live) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    live[i] = row < Sq;
    id[i] = SEG && live[i] ? seg_q[(size_t)b * Sq + row] : 0;
  }
}


// ---- the bf16 / f16 body at head_dim 16-128: tensor cores --------------
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
  const LogitLog2 logit(scale, softcap);
  static_assert(D <= 128, "head_dim 256 runs the wide body");
  static_assert(NDT % 2 == 0, "pairs of 8-wide output tiles");
  BWD_SMEM(smem_raw);
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* ks = qs + BQ * LD;                    // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;                // [2][BK][LD]
  __shared__ int2 red[kTcThreads / 32];
  __shared__ unsigned words[kTcThreads / 32];

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
    const TileRange range(r0, BQ, BK, Sq, Skv, window, causal, q_offset);
    // segment ids of this thread's two rows (g8 and g8 + 8), and with
    // them the q tile's span
    int seg_row[2];
    bool live[2];
    row_ids<SEG>(seg_q, b, Sq, r0 + warp * 16 + g8, seg_row, live);
    if constexpr (SEG) q_tile_spans(seg_row, live, red);
    KeyTileWalk<SEG, kTcThreads, BK> walk(range.lo);

    float o[NDT][4];
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    float mrow[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, lrow[2] = {0.f, 0.f};
    uint32_t qf[NKS][4];

    auto load_kv = [&](int kt, int st) {
      cp_async_rows<BK, D, kTcThreads>(ks + st * BK * LD, kb, kt * BK, Skv,
                                       (size_t)KV * D, tid);
      cp_async_rows<BK, D, kTcThreads>(vs + st * BK * LD, vb, kt * BK, Skv,
                                       (size_t)KV * D, tid);
    };
    int kt = walk.next(range.lo, range.lo, range.hi, sk, Skv, red, words);
    if (kt <= range.hi) {
      cp_async_rows<BQ, D, kTcThreads>(qs, qb, r0, Sq, (size_t)H * D, tid);
      load_kv(kt, 0);
      cp_async_commit();
    }
    for (int st = 0, first = 1; kt <= range.hi; st ^= 1, first = 0) {
      const int nxt =
          walk.next(kt + 1, range.lo, range.hi, sk, Skv, red, words);
      if (nxt <= range.hi) {
        load_kv(nxt, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (first) {   // the Q fragments stay in registers for the tile
#pragma unroll
        for (int s = 0; s < NKS; ++s)
          ldsm_x4(qf[s], qs + (warp * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * LD +
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
#pragma unroll
        for (int np = 0; np < NNT / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, kts + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                          s * 16 + ((lane >> 3) & 1) * 8);
          Mma<T>::run(sc[2 * np], qf[s], bb[0], bb[1]);
          Mma<T>::run(sc[2 * np + 1], qf[s], bb[2], bb[3]);
        }
      }

      // online softmax in registers (log2 units); this thread holds
      // rows g8 (e = 0, 1) and g8 + 8 (e = 2, 3) of the warp's 16
      const int k0 = kt * BK;
      const int qp0 = q_offset + r0 + warp * 16 + g8;
      const bool need_mask = SEG || k0 + BK > Skv ||
                             (causal && k0 + BK - 1 > q_offset + r0) ||
                             (window > 0 && k0 < q_offset + r0 + BQ - window);
      logit.apply<NNT>(sc);
      float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[nt][e];
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
      kt = nxt;
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


// ---- the bf16 / f16 body at head_dim 256: eight warps a block ----------
// (the plan in the note at the top)
constexpr int kWideBQ = 64;         // q rows a tile
constexpr int kWideThreads = 2 * kWideBQ / 16 * 32;  // row groups x 2 halves
constexpr int kWideBK = 32;         // K/V rows a tile
constexpr int kWideBlocks = 2;      // blocks an SM (caps the registers)

// Q, two stages of K and V, P, two stages of key ids, the row maxima
// and sums of both halves
template <typename T, int D>
constexpr size_t wide_smem_bytes() {
  return (size_t)(kWideBQ + 4 * kWideBK) * (D + 8) * sizeof(T) +
         (size_t)kWideBQ * (kWideBK + 8) * sizeof(T) +
         2 * kWideBK * sizeof(int) + 4 * kWideBQ * sizeof(float);
}

template <typename T, int D, bool SEG, bool LSE>
__global__ void __launch_bounds__(kWideThreads, kWideBlocks)
    flash_attention_wide_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    float* __restrict__ lse, int Sq, int Skv, int H, int KV, float scale,
    float softcap, int window, int causal, int q_offset) {
  constexpr int BQ = kWideBQ, BK = kWideBK, NT = kWideThreads;
  constexpr int LD = D + 8, LDP = BK + 8;   // padded shared rows
  constexpr int NKS = D / 16;    // k-steps of Q K^T
  constexpr int CW = BK / 2;     // S columns a warp
  constexpr int NS = CW / 8;     // their 8-wide tiles
  constexpr int HALF = D / 2;    // output columns a warp
  constexpr int NDT = HALF / 8;  // their 8-wide tiles
  const LogitLog2 logit(scale, softcap);
  static_assert(NDT % 2 == 0 && NS % 2 == 0, "pairs of 8-wide tiles");
  BWD_SMEM(smem_raw);
  T* qs = reinterpret_cast<T*>(smem_raw);              // [BQ][LD]
  T* ks = qs + BQ * LD;                                // [2][BK][LD]
  T* vs = ks + 2 * BK * LD;                            // [2][BK][LD]
  T* ps = vs + 2 * BK * LD;                            // [BQ][LDP]
  int* sks = reinterpret_cast<int*>(ps + BQ * LDP);    // [2][BK]
  float* mx_s = reinterpret_cast<float*>(sks + 2 * BK);  // [2][BQ]
  float* l_s = mx_s + 2 * BQ;                            // [2][BQ]
  __shared__ int2 red[NT / 32];
  __shared__ unsigned words[NT / 32];
  __shared__ int sqs[SEG ? BQ : 1];   // the q tile's ids

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rw = warp % (BQ / 16), hf = warp / (BQ / 16);
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t kstride = (size_t)KV * D;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Skv * KV + kvh) * D;
  const T* vb = v + ((size_t)b * Skv * KV + kvh) * D;
  const int* sk = SEG ? seg_k + (size_t)b * Skv : nullptr;

  const int nqt = (Sq + BQ - 1) / BQ;
  const int heavy = nqt - 1 - blockIdx.x, light = blockIdx.x;
#pragma unroll 1
  for (int rep = 0; rep < 2; ++rep) {
    if (rep == 1) {
      if (light >= heavy) break;
      __syncthreads();  // the first tile's shared arrays are no longer read
    }
    const int r0 = (rep == 0 ? heavy : light) * BQ;
    const TileRange range(r0, BQ, BK, Sq, Skv, window, causal, q_offset);
    // this thread's rows g8 and g8 + 8 of its group's 16
    const int lr0 = rw * 16 + g8;            // its first row in the tile
    int seg_row[2];
    bool live[2];
    row_ids<SEG>(seg_q, b, Sq, r0 + lr0, seg_row, live);
    if constexpr (SEG) {   // the rows' ids stay in shared memory
      if (hf == 0 && t4 == 0) {
        sqs[lr0] = seg_row[0];
        sqs[lr0 + 8] = seg_row[1];
      }
      q_tile_spans(seg_row, live, red);
    }
    KeyTileWalk<SEG, NT, BK> walk(range.lo);

    float o[NDT][4];
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    float mrow[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, lrow[2] = {0.f, 0.f};

    auto load_kv = [&](int kt, int st) {
      cp_async_rows<BK, D, NT>(ks + st * BK * LD, kb, kt * BK, Skv, kstride,
                               tid);
      cp_async_rows<BK, D, NT>(vs + st * BK * LD, vb, kt * BK, Skv, kstride,
                               tid);
      if (SEG && tid < BK)
        cp_async4(sks + st * BK + tid, sk + min(kt * BK + tid, Skv - 1),
                  kt * BK + tid < Skv);
    };
    int kt = walk.next(range.lo, range.lo, range.hi, sk, Skv, red, words);
    if (kt <= range.hi) {
      cp_async_rows<BQ, D, NT>(qs, qb, r0, Sq, (size_t)H * D, tid);
      load_kv(kt, 0);
      cp_async_commit();
    }
    for (int st = 0; kt <= range.hi; st ^= 1) {
      cp_async_wait<0>();
      // tile kt is in; every warp is done with the last tile's stage,
      // P and maxima, so the next tile loads into the other stage now
      __syncthreads();
      const int nxt =
          walk.next(kt + 1, range.lo, range.hi, sk, Skv, red, words);
      if (nxt <= range.hi) {
        load_kv(nxt, st ^ 1);
        cp_async_commit();
      }
      const T* kts = ks + st * BK * LD;
      const T* vts = vs + st * BK * LD;
      const int* skt = sks + st * BK;

      // S = Q K^T: this warp's 16 rows x the tile's columns hf*CW..
      float sc[NS][4];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      // eight k-steps an unrolled body: fully unrolled, ptxas hoisted
      // enough fragments to spill 12 bytes at 128 registers with ids
#pragma unroll 8
      for (int s = 0; s < NKS; ++s) {
        uint32_t a[4];
        ldsm_x4(a, qs + (rw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       s * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, kts + (hf * CW + np * 16 + (lane & 7) +
                             (lane >> 4) * 8) * LD +
                          s * 16 + ((lane >> 3) & 1) * 8);
          Mma<T>::run(sc[2 * np], a, bb[0], bb[1]);
          Mma<T>::run(sc[2 * np + 1], a, bb[2], bb[3]);
        }
      }

      // the logits (log2 units) and this half's row maxima
      const int k0 = kt * BK;
      const int qp0 = q_offset + r0 + lr0;
      const bool need_mask = SEG || k0 + BK > Skv ||
                             (causal && k0 + BK - 1 > q_offset + r0) ||
                             (window > 0 && k0 < q_offset + r0 + BQ - window);
      logit.apply<NS>(sc);
      float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[nt][e];
          if (need_mask) {
            const int kk = hf * CW + nt * 8 + 2 * t4 + (e & 1);
            const int kp = k0 + kk;
            const int qp = qp0 + (e >> 1) * 8;
            const bool ok = kp < Skv && (!causal || kp <= qp) &&
                            (window <= 0 || kp > qp - window) &&
                            (!SEG || skt[kk] == sqs[lr0 + (e >> 1) * 8]);
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
        if (t4 == 0) mx_s[hf * BQ + lr0 + 8 * i] = mx[i];
      }
      __syncthreads();   // both halves' maxima
      // the row's max over both halves (exact, so both halves agree),
      // the rescale, and P
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m = fmaxf(mx[i], mx_s[(hf ^ 1) * BQ + lr0 + 8 * i]);
        const float alpha = exp2f(mrow[i] - m);
        mrow[i] = m;
        lrow[i] *= alpha;
#pragma unroll
        for (int dt = 0; dt < NDT; ++dt) {
          o[dt][2 * i] *= alpha;
          o[dt][2 * i + 1] *= alpha;
        }
      }
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p0 = exp2f(sc[nt][2 * i] - mrow[i]);
          const float p1 = exp2f(sc[nt][2 * i + 1] - mrow[i]);
          lrow[i] += p0 + p1;
          *reinterpret_cast<uint32_t*>(
              ps + (lr0 + 8 * i) * LDP + hf * CW + nt * 8 + 2 * t4) =
              Mma<T>::pack(p0, p1);
        }
      }
      __syncthreads();   // the tile's P staged

      // O (this warp's half of D) += P V, 16 keys a step
#pragma unroll
      for (int s = 0; s < BK / 16; ++s) {
        uint32_t a[4];
        ldsm_x4(a, ps + (rw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP +
                       s * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int dp = 0; dp < NDT / 2; ++dp) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, vts + (s * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * LD +
                                hf * HALF + dp * 16 + (lane >> 4) * 8);
          Mma<T>::run(o[2 * dp], a, bb[0], bb[1]);
          Mma<T>::run(o[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
      kt = nxt;
    }

    // the row sums: the quad's, then both halves' (a + b == b + a, so
    // both halves divide by the same l)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
      lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
      if (t4 == 0) l_s[hf * BQ + lr0 + 8 * i] = lrow[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float li = lrow[i] + l_s[(hf ^ 1) * BQ + lr0 + 8 * i];
      const float inv = 1.f / fmaxf(li, 1e-30f);
      const int row = r0 + lr0 + 8 * i;
      if (row >= Sq) continue;
      if (LSE && hf == 0 && t4 == 0)   // m is in log2 units
        lse[((size_t)b * H + h) * Sq + row] =
            li > 0.f ? (mrow[i] + log2f(li)) * 0.6931471805599453f
                     : REPRO_MASKED;
      uint32_t* op = reinterpret_cast<uint32_t*>(
          out + (((size_t)b * Sq + row) * H + h) * D + hf * HALF + 2 * t4);
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
  auto* kern = flash_attention_f32_kernel<T, D, SEG, LSE>;
  BWD_LAUNCH(kern, grid, dim3(threads), 0, a.stream,
             (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out, a.seg_q,
             a.seg_k, a.lse, a.Sq, a.Skv, a.H, a.KV, a.scale, a.softcap,
             a.window, a.causal, a.Skv - a.Sq);
  return (int)cudaGetLastError();
}

// a tensor-core body: grid (ceil(nqt / 2), H, B), two q tiles a block;
// `most_shared`: ask for the largest shared-memory carveout (the wide
// body's two blocks an SM)
template <typename T, typename Kern>
static int launch_tc_body(const Args& a, Kern kern, int bq, int threads,
                          size_t smem, bool most_shared) {
  if (smem > 48 * 1024) {  // above the default cap: opt in
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && most_shared)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return (int)err;
  }
  const int nqt = (a.Sq + bq - 1) / bq;
  dim3 grid((nqt + 1) / 2, a.H, a.B);
  BWD_LAUNCH(kern, grid, dim3(threads), smem, a.stream,
             (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out, a.seg_q,
             a.seg_k, a.lse, a.Sq, a.Skv, a.H, a.KV, a.scale, a.softcap,
             a.window, a.causal, a.Skv - a.Sq);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool SEG, bool LSE>
static int launch_tc_v(const Args& a) {
  if constexpr (D >= 256)
    return launch_tc_body<T>(a, flash_attention_wide_tc_kernel<T, D, SEG, LSE>,
                             kWideBQ, kWideThreads, wide_smem_bytes<T, D>(),
                             true);
  else
    return launch_tc_body<T>(a, flash_attention_tc_kernel<T, D, SEG, LSE>,
                             kTcBQ, kTcThreads, tc_smem_bytes<T, D>(),
                             false);
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
