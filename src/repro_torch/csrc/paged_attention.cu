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
// (G = H/KV query heads per KV head), 2*G flops per byte, far below the
// ~295 at which the tensor cores would bind. At 8 slots x 1024 tokens,
// KV=8, D=128, bf16 that is 33.6 MB per call, ~10 us at 3.35 TB/s.
// Reaching it takes many bytes in flight on every SM and a short fixed
// chain around them, so the design is about parallelism, load depth and
// the instructions a key costs, not flops.
//
// The bf16 / f16 route (paged_attention_tc_kernel):
// - One block a (KV head, sequence, split) serves all G query heads of
//   its KV head (up to 64; past that, chunks of at most 64 heads), so
//   each live K/V row is read from device memory once a call at any G.
//   The heads are the M rows of mma.sync.m16n8k16 (f32 accumulators):
//   MT = ceil(G/16) tiles of 16 rows (1, 2 or 4), rows past G zero.
// - Warps: each warp owns one 16-row head tile (mt), one column part of
//   D (cg: two halves of 128 at D = 256, else all of D) and one 16-key
//   slice (ks) of every stage: KS = warps / (MT * parts) key slices, 4
//   warps a block (8 at D = 256 with MT = 4). At the served shapes
//   (G <= 16) D <= 128 runs 4 key slices, a 64-key stage, and D = 256
//   two warp pairs over a 32-key stage.
// - A warp's products: S = Q K^T over its 16 keys (two 8-key n-tiles,
//   Q's A fragments loaded once from device memory into registers for
//   the whole split, K's B fragments by ldmatrix from padded shared
//   rows); at D = 256 each warp of a pair sums its half of D and the
//   pair adds the two partial S through shared memory (one more barrier
//   a stage; the pair then holds the same S, m and l); the logit in
//   log2 units with the softcap a template flag, branch-free (Logit2);
//   the online softmax in registers (row max over the four lanes of a
//   row by two shuffles); P re-packed from the S accumulators as the A
//   operand of O += P V, V's B fragments by ldmatrix.trans. O is 16 x
//   D/parts f32 in registers: 64 at D = 128 and (a half) at D = 256.
// - Loads: a ring of stages of K and V in shared memory (4 at D <= 64,
//   3 above), 16-byte cp.async by every thread, per-row addresses
//   through the split's block-table entries (read once into shared
//   memory). All stages but one are in flight while one is consumed;
//   one barrier a stage frees the stage consumed before it. Rows past
//   ctx are zero-filled and masked.
//   TMA was not taken: a box is one page of one KV head (16 rows at the
//   served page size), the window and ctx cut pages mid-box, and the
//   tensor map would be made on the host for each pool; cp.async keeps
//   one path for every page size.
// - After the last stage the key slices merge in fixed order through
//   shared memory (the ring reused): each warp rescales its O and l to
//   the block's row max, and the sums over the slices give the split's
//   partial.
// - Shared memory: stages x 2 x (KS x 16) x (D + 8) x 2 B: 73,728 B at
//   D = 64 (three blocks an SM), 104,448 at D = 128 and 101,376 at
//   D = 256 (two), plus the table entries.
//
// The plan (kernels/paged_attention.py `plan`) comes from shapes only,
// never from ctx_lens, so no host sync: B * KV cells, and the most
// splits of whole pages that keep one wave of at most a block an SM at
// a 1024-token context, none shorter than two 64-key stages (128
// tokens): at 8 slots and KV = 8, two splits of 512 tokens, 128
// blocks. Under the smoke's timer (the L2 left dirty) more, shorter
// splits took longer at every served shape (tools/paged_attention_probe.py
// on the card: a second wave, and a longer combine). The split
// length does not depend on the table's width up to 256 splits: a wider
// table appends splits, and its empty ones add exactly nothing (past
// 256 splits the split length doubles, in steps). A split wholly past
// ctx or below the window loads no row and writes the empty partial
// (m = -1e30, l = 0); rows below the window and past ctx are never
// read.
//
// Combine in the same launch, of each split's partial (o normalised by
// its own l, m, l in float32), in split-index order as one online pass
// (M = max m_k, w_k = exp(m_k - M) l_k, out = sum w_k o_k / max(sum
// w_k, 1e-30): the reference's combine_partial_attention, the max kept
// running; the exp pair and the running (m, den) once a head and split,
// then one FMA an element and split), so the result does not depend on
// block arrival order and repeated calls are bit-identical. Two ways,
// the same operations, so the same bits:
// - a thread-block cluster: where the splits are 2-8 and the grid is at
//   most a block an SM (every served plan at a 1024-token context), a
//   cell's splits are one cluster along z; each keeps its partial in its
//   shared memory, and after a cluster barrier each combines its share
//   of the rows reading the others' through distributed shared memory.
//   No partial in device memory, no fence, no ticket (glm4's 32/2:
//   16.8 us against 18.9 through the ticket, H100);
// - the ticket, otherwise: each split writes its partial to scratch;
//   after a barrier one thread fences (cumulative over the block's
//   writes) and takes a ticket from a per-(sequence, KV head, head
//   chunk) counter; the block with the last ticket copies every
//   split's rows of a group of heads and every (m, l) into shared
//   memory at once (past ~100 splits it folds straight from device
//   memory), combines, writes the global (m, l) and resets its counter
//   to 0 for the next call.
// One split needs no combine, and folds its partial as the combine
// would. A lane with ctx 0 returns 0 with m = -1e30, l = 0, as the
// Pallas kernel does.
//
// The float32 route (paged_attention_kernel, the first CUDA-core design,
// run only by the parity engines): CUDA cores, D/8 threads a row with 8
// elements each, the dot products reduced by xor shuffles, up to 8
// query heads a block (head chunks of 1, 4 or 8), 64-row tiles (32 at
// D >= 128) double-buffered; the same split plan and combine. TF32
// products would miss its 1e-4 gate.
//
// Where the time goes (tools/paged_attention_probe.py, H100, the
// smoke's timer: the L2 flushed by a write, so every read evicts a dirty
// line): at 8 slots x 1024 tokens the bytes and their write-backs take
// most of it (ctx 0: ~8-12 us of a 17-43 us call, with the timer's own
// ~5 us), and the chain after the last stage ~3-5 us (merge, cluster
// barrier, combine, exit). What is left: TMA boxes of a page; that
// chain; the f32 route's CUDA-core body; seamless's 16/16 at D 64 (128
// B rows) takes 1.08x SDPA over the pre-gathered pages: its loads alone
// take that time, and not in the row-address arithmetic (a shift and a
// mask in place of the division by P changed nothing).
//
// The launches go through BWD_LAUNCH / CLUSTER_Z_LAUNCH and the shared
// memory through BWD_SMEM, so the file also builds with g++ against
// host_emulation.cuh (tools/paged_attention_host_check.py).
//
// nvcc builds the file as three translation units at once, linked into
// one library (kernels/_build.py PARTS): -DREPRO_PART=0 the entry point
// and the f32 body, 1 the bf16 and 2 the f16 tensor-core bodies (30
// instantiations each: one unit took ~110 s of the smoke's build).
// Without REPRO_PART it is one unit with all of them.
#include "common.cuh"

#ifdef REPRO_PART
#define REPRO_PART_HAS(i) (REPRO_PART == (i))
#else
#define REPRO_PART_HAS(i) 1
#endif

namespace repro_paged {
// a launch's arguments: paged_attention_launch's, less D and the dtype
struct Args {
  const void *q, *k_pool, *v_pool, *table, *ctx_lens;
  void *out, *m_out, *l_out, *part, *counters;
  int B, H, KV, P, maxp, gh, n_split, pps;
  float scale, softcap;
  int window;
  cudaStream_t stream;
};
int launch_bf16(int D, const Args& a);  // parts 1 and 2
int launch_f16(int D, const Args& a);
}  // namespace repro_paged

namespace {
using repro_paged::Args;

constexpr int kMaxSplits = 256;  // the host plan's MAX_SPLITS
constexpr float kLn2 = 0.6931471805599453f;

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

// ---- the float32 body: CUDA cores ---------------------------------------
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kEpt = 8;  // row elements per thread in the compute

// K/V rows per tile: 64, or 32 where one stage would pass 32 KB
template <typename T, int D>
__host__ __device__ constexpr int tile_rows() {
  return 2 * D * (int)sizeof(T) * 64 <= 32768 ? 64 : 32;
}

// resident blocks per SM asked of the register allocator: 4 (128
// registers each) where the state fits without spilling, fewer for the
// wider states. At D = 256 shared memory holds the count down anyway
// (two 32-row stages of K and V: 64 KB in bf16 / f16, 128 KB in f32,
// plus the GC x D merge area), so the registers get 2 blocks (1 in f32)
template <typename T, int D, int GC>
__host__ __device__ constexpr int min_blocks() {
  return D >= 256 ? (sizeof(T) == 4 ? 1 : 2)
         : GC >= 8 ? 2
         : (D >= 128 || sizeof(T) == 4) ? 3 : 4;
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

  BWD_SMEM(smem_raw);
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


// ---- the bf16 / f16 body: tensor cores (the plan in the note at the top)
// K/V stages in shared memory: 4 at D <= 64 (74 KB a block), else 3
template <int D>
__host__ __device__ constexpr int ring_stages() { return D <= 64 ? 4 : 3; }
constexpr int kSliceKeys = 16; // keys a warp takes of a stage
constexpr int kMaxBlockHeads = 64;  // the host plan's MAX_BLOCK_HEADS
constexpr int kMaxCluster = 8;      // splits combined in one cluster, at most

// column parts of D a warp pair splits (O and S's k-steps): 2 at D = 256
template <int D>
__host__ __device__ constexpr int col_parts() { return D > 128 ? 2 : 1; }
template <int D, int MT>
__host__ __device__ constexpr int tc_warps() {
  return MT * col_parts<D>() > 4 ? MT * col_parts<D>() : 4;
}
// keys a stage: one 16-key slice a key-slice group of warps
template <int D, int MT>
__host__ __device__ constexpr int stage_keys() {
  return tc_warps<D, MT>() / (MT * col_parts<D>()) * kSliceKeys;
}
// the ring, or after the last stage the merge area (each warp's 16 x
// D/parts O, then its row maxima and sums), whichever is larger
template <typename T, int D, int MT>
__host__ __device__ constexpr size_t tc_union_bytes() {
  return (size_t)ring_stages<D>() * 2 * stage_keys<D, MT>() * (D + 8) *
                     sizeof(T) >
                 (size_t)tc_warps<D, MT>() * 16 * (D / col_parts<D>() + 2) * 4
             ? (size_t)ring_stages<D>() * 2 * stage_keys<D, MT>() * (D + 8) *
                   sizeof(T)
             : (size_t)tc_warps<D, MT>() * 16 * (D / col_parts<D>() + 2) * 4;
}
// plus the pair's partial S (D = 256: 8 floats a thread)
template <typename T, int D, int MT>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return tc_union_bytes<T, D, MT>() +
         (col_parts<D>() > 1 ? (size_t)tc_warps<D, MT>() * 32 * 8 * 4 : 0);
}
// resident blocks an SM asked of the register allocator (shared memory
// holds the count there anyway): 4 at D <= 64, 2 above, 1 for 8 warps
template <int D, int MT>
__host__ __device__ constexpr int tc_min_blocks() {
  return D <= 64 ? 4 : tc_warps<D, MT>() > 4 ? 1 : 2;
}

// logits in log2 units: s scale log2(e), or with the softcap c (CAP)
// c log2(e) tanh(s scale / c) = cap - 2 cap / (2^(s k) + 1) with k =
// 2 scale log2(e) / c (2^(s k) = inf gives cap, 0 gives -cap): no tanhf,
// no IEEE division, no branch on the value
template <bool CAP>
struct Logit2 {
  float mul, cap, two_cap, k;
  __device__ Logit2(float scale, float softcap) {
    constexpr float kLog2e = 1.4426950408889634f;
    mul = scale * kLog2e;
    cap = CAP ? softcap * kLog2e : 0.f;
    two_cap = 2.f * cap;
    k = CAP ? 2.f * mul / softcap : 0.f;
  }
  __device__ __forceinline__ float operator()(float s) const {
    if constexpr (CAP) {
      return cap - __fdividef(two_cap, exp2f(s * k) + 1.f);
    } else {
      return s * mul;
    }
  }
};

// The combine of a cell's splits in split-index order, as fold_split
// runs it element by element, with what depends only on the head taken
// out of the element loop. head_weights (one thread a head) folds every
// split's (m_k, l_k) into the running (m, den), leaving each split's
// rescale a_k of the running sums and its weight w_k (a_k = -1: an
// empty split, skipped; `stat` may read the slot it writes) and the
// head's final (m, den); each element
// then folds num = fmaf(num, a_k, w_k o_k) over the live splits. These
// are fold_split's operations in its order, so its bits; they take one
// exp pair a head and split where fold_split took one an element
// (glm4's combining block: 11.5 us of its 20 on the card, PERF.md)
template <typename Stat>
__device__ __forceinline__ void head_weights(int g, int n_split, int stride,
                                             Stat stat, float2* aw,
                                             float2* m_den) {
  float m = REPRO_NEG_INF, den = 0.f;
  for (int k = 0; k < n_split; ++k) {
    const float2 s = stat(k);  // (m_k, l_k)
    float2 r = make_float2(-1.f, 0.f);
    if (s.y > 0.f) {
      const float mn = fmaxf(m, s.x);
      r.x = __expf(m - mn);
      r.y = __expf(s.x - mn) * s.y;
      den = fmaf(den, r.x, r.y);
      m = mn;
    }
    aw[k * stride + g] = r;
  }
  m_den[g] = make_float2(m, den);
}

__device__ __forceinline__ void fold_row(float* num, float2 r, float4 o) {
  if (r.x < 0.f) return;
  num[0] = fmaf(num[0], r.x, r.y * o.x);
  num[1] = fmaf(num[1], r.x, r.y * o.y);
  num[2] = fmaf(num[2], r.x, r.y * o.z);
  num[3] = fmaf(num[3], r.x, r.y * o.w);
}

template <typename T, int D, int MT, bool CAP>
__global__ void __launch_bounds__(tc_warps<D, MT>() * 32,
                                  tc_min_blocks<D, MT>())
    paged_attention_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ ctx_lens, T* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ part, int* __restrict__ counters, int H, int KV,
    int P, int maxp, int n_split, int pps, int GH, float scale,
    float softcap, int window) {
  constexpr int CG = col_parts<D>(), DH = D / CG;  // column parts, width
  constexpr int NW = tc_warps<D, MT>(), NT = NW * 32;
  constexpr int NG = MT * CG;           // warps sharing a key slice
  constexpr int BK = stage_keys<D, MT>();
  constexpr int LD = D + 8;             // padded shared row (elements)
  constexpr int NKS = DH / 16;          // k-steps of S in a warp's part
  constexpr int NDT = DH / 8;           // 8-wide column tiles of O
  constexpr int EPC = 16 / (int)sizeof(T);   // elements a 16-byte chunk
  constexpr int CPR = D / EPC;          // chunks a row
  constexpr int NCH = BK * CPR;         // chunks of K (and of V) a stage
  constexpr int kRing = ring_stages<D>();
  static_assert(sizeof(T) == 2 && DH % 16 == 0, "bf16 / f16, D >= 16");
  const Logit2<CAP> logit(scale, softcap);

  const int G = H / KV;
  const int nhc = (G + GH - 1) / GH;
  const int kvh = blockIdx.x / nhc;
  const int hc = blockIdx.x - kvh * nhc;
  const int b = blockIdx.y, split = blockIdx.z;
  const int h0 = kvh * G + hc * GH;
  const int gn = min(GH, G - hc * GH);  // live heads of this block
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;  // fragment row, column pair
  const int ks = warp / NG, mt = (warp / CG) % MT, cg = warp % CG;

  BWD_SMEM(smem_raw);
  T* ring = reinterpret_cast<T*>(smem_raw);  // [stages][K, V][BK][LD]
  float* ob = reinterpret_cast<float*>(smem_raw);  // [NW][16][DH], after
  float* red_m = ob + NW * 16 * DH;                 // [NW][16]
  float* red_l = red_m + NW * 16;                   // [NW][16]
  float* xs = reinterpret_cast<float*>(smem_raw +
                                       tc_union_bytes<T, D, MT>());
  int* tbl = reinterpret_cast<int*>(smem_raw + tc_smem_bytes<T, D, MT>());
  __shared__ int s_last;

  // this split's live rows: [t_begin, t_end)
  const int ctx = ctx_lens[b];
  const int lo = window > 0 ? max(0, ctx - window) : 0;
  const int p0 = split * pps;
  const int s_begin = p0 * P;
  const int t_begin = max(s_begin, lo);
  const int t_end = min(min(s_begin + pps * P, ctx), maxp * P);
  const int nst = t_end > t_begin ? (t_end - t_begin + BK - 1) / BK : 0;
  const int npg = min(pps, maxp - p0);
  for (int i = tid; i < npg; i += NT)
    tbl[i] = table[(size_t)b * maxp + p0 + i];

  // Q's A fragments of this warp's head tile and column part, for the
  // whole split: (row, k) in register (row >= 8) + 2 (k >= 8)
  uint32_t qf[NKS][4];
#pragma unroll
  for (int s = 0; s < NKS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = mt * 16 + g8 + 8 * (i & 1);
      const int col = cg * DH + s * 16 + 2 * t4 + 8 * (i >> 1);
      qf[s][i] = row < gn ? *reinterpret_cast<const uint32_t*>(
                                q + ((size_t)b * H + h0 + row) * D + col)
                          : 0u;
    }
  __syncthreads();  // tbl

  // stage st <- K and V rows t_begin + t*BK .. + BK - 1 (zero past t_end)
  auto issue = [&](int t, int st) {
    const int t0 = t_begin + t * BK;
    T* kst = ring + st * 2 * BK * LD;
    T* vst = kst + BK * LD;
#pragma unroll
    for (int i = 0; i < (NCH + NT - 1) / NT; ++i) {
      const int c = tid + i * NT;
      if (NCH % NT == 0 || c < NCH) {
        const int r = c / CPR, cc = c - r * CPR;
        const int pos = t0 + r;
        const bool ok = pos < t_end;
        size_t off = 0;
        if (ok) {
          const int pg = pos / P;
          const size_t blk = (size_t)tbl[pg - p0];
          off = ((blk * P + (pos - pg * P)) * KV + kvh) * D + cc * EPC;
        }
        cp_async16(kst + r * LD + cc * EPC, k_pool + off, ok);
        cp_async16(vst + r * LD + cc * EPC, v_pool + off, ok);
      }
    }
  };

  float o[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float mrow[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, lrow[2] = {0.f, 0.f};

#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < nst) issue(i, i);
    cp_async_commit();
  }
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<kRing - 2>();  // stage t landed (this thread's copies)
    __syncthreads();             // ... everyone's; stage t - 1 is free
    if (t + kRing - 1 < nst) issue(t + kRing - 1, (t + kRing - 1) % kRing);
    cp_async_commit();
    const T* kst = ring + (t % kRing) * 2 * BK * LD + ks * kSliceKeys * LD;
    const T* vst = kst + BK * LD;
    const int k0 = t_begin + t * BK + ks * kSliceKeys;  // this slice's key
    const bool live = k0 < t_end;                       // (warp-uniform)

    // S = Q K^T: 16 heads x 16 keys, two 8-key n-tiles
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    if (live) {
#pragma unroll
      for (int s = 0; s < NKS; ++s) {
        uint32_t bb[4];
        ldsm_x4(bb, kst + ((lane & 7) + (lane >> 4) * 8) * LD + cg * DH +
                        s * 16 + ((lane >> 3) & 1) * 8);
        Mma<T>::run(sc[0], qf[s], bb[0], bb[1]);
        Mma<T>::run(sc[1], qf[s], bb[2], bb[3]);
      }
    }
    if constexpr (CG > 1) {  // the pair adds its two halves of D
      float4* mine = reinterpret_cast<float4*>(xs + (warp * 32 + lane) * 8);
      mine[0] = make_float4(sc[0][0], sc[0][1], sc[0][2], sc[0][3]);
      mine[1] = make_float4(sc[1][0], sc[1][1], sc[1][2], sc[1][3]);
      __syncthreads();
      const float4* other =
          reinterpret_cast<const float4*>(xs + ((warp ^ 1) * 32 + lane) * 8);
      const float4 a = other[0], c = other[1];
      sc[0][0] += a.x; sc[0][1] += a.y; sc[0][2] += a.z; sc[0][3] += a.w;
      sc[1][0] += c.x; sc[1][1] += c.y; sc[1][2] += c.z; sc[1][3] += c.w;
    }
    if (!live) continue;

    // online softmax in registers (log2 units); this thread holds heads
    // g8 (e = 0, 1) and g8 + 8 (e = 2, 3), keys 2 t4 + (e & 1) of each
    // n-tile
    const bool need_mask = k0 + kSliceKeys > t_end;
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = logit(sc[n][e]);
        if (need_mask && k0 + n * 8 + 2 * t4 + (e & 1) >= t_end)
          x = REPRO_MASKED;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[n][e] - mrow[e >> 1]);
        sc[n][e] = p;
        lrow[e >> 1] += p;
      }

    // O += P V: P's accumulator layout is the A operand's (16 keys)
    const uint32_t a[4] = {Mma<T>::pack(sc[0][0], sc[0][1]),
                           Mma<T>::pack(sc[0][2], sc[0][3]),
                           Mma<T>::pack(sc[1][0], sc[1][1]),
                           Mma<T>::pack(sc[1][2], sc[1][3])};
#pragma unroll
    for (int dp = 0; dp < NDT / 2; ++dp) {
      uint32_t bb[4];
      ldsm_x4_trans(bb, vst + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                            cg * DH + dp * 16 + (lane >> 4) * 8);
      Mma<T>::run(o[2 * dp], a, bb[0], bb[1]);
      Mma<T>::run(o[2 * dp + 1], a, bb[2], bb[3]);
    }
  }

  // merge the key slices in fixed order: each warp rescales its O and l
  // to the block's row max M over the slices, then the sums over the
  // slices are the split's (o, l) and M its m
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the merge area reuses it
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
    if (t4 == 0) red_m[warp * 16 + g8 + 8 * i] = mrow[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g8 + 8 * i;
    float mb = red_m[(mt * CG + cg) * 16 + r];
#pragma unroll
    for (int s = 1; s < NW / NG; ++s)
      mb = fmaxf(mb, red_m[(s * NG + mt * CG + cg) * 16 + r]);
    const float f = exp2f(mrow[i] - mb);
    if (t4 == 0) red_l[warp * 16 + r] = lrow[i] * f;
    float* orow = ob + (warp * 16 + r) * DH + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      *reinterpret_cast<float2*>(orow + dt * 8) =
          make_float2(o[dt][2 * i] * f, o[dt][2 * i + 1] * f);
  }
  __syncthreads();

  // the split's rows, four columns a thread at a time: (o / l, m, l)
  constexpr int D4 = D / 4;
  const int nq = gn * D4;
  const size_t kStride = (size_t)GH * D + ((2 * GH + 3) & ~3);
  const size_t cell = (size_t)b * gridDim.x + blockIdx.x;
  // in a cluster (the launch's choice: the cell's splits are its blocks)
  // the partial stays in this block's shared memory, past the merge area
  const bool clustered = n_split > 1 && cluster_size() > 1;
  float* mine = clustered ? red_l + NW * 16
                          : part + (cell * n_split + split) * kStride;
  for (int idx = tid; idx < nq; idx += NT) {
    const int g = idx / D4, d = (idx - g * D4) * 4;
    const int r = g & 15, c = d / DH, wb = (g >> 4) * CG + c;
    const int dd = d - c * DH;
    float mb = red_m[wb * 16 + r], lb = red_l[wb * 16 + r];
    float4 ab = *reinterpret_cast<const float4*>(ob + (wb * 16 + r) * DH + dd);
#pragma unroll
    for (int s = 1; s < NW / NG; ++s) {
      const int w = s * NG + wb;
      mb = fmaxf(mb, red_m[w * 16 + r]);
      lb += red_l[w * 16 + r];
      const float4 x = *reinterpret_cast<const float4*>(ob + (w * 16 + r) * DH + dd);
      ab.x += x.x; ab.y += x.y; ab.z += x.z; ab.w += x.w;
    }
    const float inv_l = 1.f / fmaxf(lb, 1e-30f);
    const float ov[4] = {ab.x * inv_l, ab.y * inv_l, ab.z * inv_l,
                         ab.w * inv_l};
    mb *= kLn2;  // natural units, as the combine and (m, l) take them
    if (n_split == 1) {
      // the combine of this one split, as a wider table's launch
      // combines it with empty splits: the same bits at any width
      float m = REPRO_NEG_INF, den = 0.f;
      T* op = out + ((size_t)b * H + h0 + g) * D + d;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m = REPRO_NEG_INF;
        den = 0.f;
        float num = 0.f;
        fold_split(m, den, num, mb, lb, ov[e]);
        op[e] = from_f32<T>(num / fmaxf(den, 1e-30f));
      }
      if (m_out != nullptr && d == 0) {
        m_out[(size_t)b * H + h0 + g] = m;
        l_out[(size_t)b * H + h0 + g] = den;
      }
    } else {
      *reinterpret_cast<float4*>(mine + (size_t)g * D + d) =
          make_float4(ov[0], ov[1], ov[2], ov[3]);
      if (d == 0) {
        mine[(size_t)GH * D + g] = mb;
        mine[(size_t)GH * D + GH + g] = lb;
      }
    }
  }
  if (n_split == 1) return;
  if (clustered) {
    // each block of the cluster combines its share of the rows, reading
    // every split's partial, in split-index order, from the blocks'
    // shared memory: no partial in device memory, no fence, no ticket
    cluster_sync();
    float2* aw = reinterpret_cast<float2*>(mine + kStride);  // [n][gn]
    float2* m_den = aw + n_split * gn;                         // [gn]
    // every split's (m, l) at once, then each head's weights in place
    for (int i = tid; i < n_split * gn; i += NT) {
      const int k = i / gn, g = i - k * gn;
      const float* pk = cluster_peer(mine, k) + (size_t)GH * D;
      aw[i] = make_float2(pk[g], pk[GH + g]);
    }
    __syncthreads();
    if (tid < gn)
      head_weights(tid, n_split, gn, [&](int k) { return aw[k * gn + tid]; },
                   aw, m_den);
    __syncthreads();
    const int per = (nq + n_split - 1) / n_split;
    const int i1 = min(nq, (split + 1) * per);
    for (int idx = split * per + tid; idx < i1; idx += NT) {
      const int g = idx / D4, d = (idx - g * D4) * 4;
      float num[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int k = 0; k < n_split; ++k)
        fold_row(num, aw[k * gn + g], *reinterpret_cast<const float4*>(
                                          cluster_peer(mine, k) + (size_t)g * D + d));
      const float2 md = m_den[g];
      T* op = out + ((size_t)b * H + h0 + g) * D + d;
#pragma unroll
      for (int e = 0; e < 4; ++e) op[e] = from_f32<T>(num[e] / fmaxf(md.y, 1e-30f));
      if (m_out != nullptr && d == 0) {
        m_out[(size_t)b * H + h0 + g] = md.x;
        l_out[(size_t)b * H + h0 + g] = md.y;
      }
    }
    cluster_sync();  // no block leaves while another reads its partial
    return;
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
  // order, as one online pass (running max, rescaled sums). The partials
  // come through shared memory (the ring, free again): every split's
  // rows of a group of heads and every split's (m, l) are copied at
  // once, so their loads are in flight together, one round trip a group
  // (a loop of loads took one a split and row group: 10 us of glm4's 24
  // on the card). Past what shared memory holds for one head (over ~100
  // splits) the loads go straight to the fold, as before.
  const float* base = part + cell * n_split * kStride;
  const int s4 = (2 * GH + 3) & ~3;        // (m, l) floats a split
  constexpr int kStage = (int)(tc_union_bytes<T, D, MT>() / 4);
  // heads a group: its rows, every (m, l), its weights and (m, den)
  const int hg_max = (kStage - n_split * s4) / (n_split * (D + 2) + 2);
  float* st_o = reinterpret_cast<float*>(smem_raw);  // [n_split][hg][D]
  for (int g0 = 0; g0 < gn; g0 += max(hg_max, 1)) {
    const int hg = hg_max >= 1 ? min(hg_max, gn - g0) : 0;
    float* st_s = st_o + (size_t)n_split * hg * D;     // [n_split][s4]
    float2* aw = reinterpret_cast<float2*>(st_s + n_split * s4);  // [n][hg]
    float2* m_den = aw + n_split * hg;                           // [hg]
    if (hg > 0) {
      for (int k = 0; k < n_split; ++k) {
        const float* pk = base + k * kStride;
        for (int c = tid; c < hg * D4; c += NT)  // the group's rows
          cp_async16(st_o + (size_t)k * hg * D + c * 4,
                     pk + (size_t)g0 * D + c * 4, true);
        for (int c = tid; c < s4 / 4; c += NT)   // every (m, l)
          cp_async16(st_s + k * s4 + c * 4, pk + (size_t)GH * D + c * 4,
                     true);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (tid < hg)
        head_weights(tid, n_split, hg, [&](int k) {
          return make_float2(st_s[k * s4 + g0 + tid],
                             st_s[k * s4 + GH + g0 + tid]);
        }, aw, m_den);
      __syncthreads();
      for (int idx = tid; idx < hg * D4; idx += NT) {
        const int gl = idx / D4, d = (idx - gl * D4) * 4, g = g0 + gl;
        float num[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int k = 0; k < n_split; ++k)
          fold_row(num, aw[k * hg + gl], *reinterpret_cast<const float4*>(
                                            st_o + ((size_t)k * hg + gl) * D + d));
        const float2 md = m_den[gl];
        T* op = out + ((size_t)b * H + h0 + g) * D + d;
#pragma unroll
        for (int e = 0; e < 4; ++e) op[e] = from_f32<T>(num[e] / fmaxf(md.y, 1e-30f));
        if (m_out != nullptr && d == 0) {
          m_out[(size_t)b * H + h0 + g] = md.x;
          l_out[(size_t)b * H + h0 + g] = md.y;
        }
      }
      __syncthreads();  // the stage is refilled for the next group
      continue;
    }
    // past what shared memory holds: every element folds its loads
    for (int idx = tid; idx < gn * D4; idx += NT) {
      const int g = idx / D4, d = (idx - g * D4) * 4;
      float mb[4], den[4], num[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mb[e] = REPRO_NEG_INF;
        den[e] = num[e] = 0.f;
      }
#pragma unroll 4
      for (int k = 0; k < n_split; ++k) {
        const float* pk = base + k * kStride;
        const float mk = __ldcg(pk + (size_t)GH * D + g);
        const float lk = __ldcg(pk + (size_t)GH * D + GH + g);
        const float4 ok =
            __ldcg(reinterpret_cast<const float4*>(pk + (size_t)g * D + d));
        fold_split(mb[0], den[0], num[0], mk, lk, ok.x);
        fold_split(mb[1], den[1], num[1], mk, lk, ok.y);
        fold_split(mb[2], den[2], num[2], mk, lk, ok.z);
        fold_split(mb[3], den[3], num[3], mk, lk, ok.w);
      }
      T* op = out + ((size_t)b * H + h0 + g) * D + d;
#pragma unroll
      for (int e = 0; e < 4; ++e) op[e] = from_f32<T>(num[e] / fmaxf(den[e], 1e-30f));
      if (m_out != nullptr && d == 0) {
        m_out[(size_t)b * H + h0 + g] = mb[0];
        l_out[(size_t)b * H + h0 + g] = den[0];
      }
    }
    break;
  }
  if (tid == 0) counters[cell] = 0;
}

// ---- launches ----------------------------------------------------------
template <typename T, int D, int MT, bool CAP>
int launch_tc(const Args& a) {
  auto* kern = paged_attention_tc_kernel<T, D, MT, CAP>;
  const size_t smem = tc_smem_bytes<T, D, MT>() +
                      sizeof(int) * (size_t)(a.pps > 0 ? a.pps : 1);
  if (smem > 48 * 1024) {  // above the default cap: opt in, and ask for
    // the largest carveout (two or four blocks an SM)
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return (int)err;
  }
  const int nhc = (a.H / a.KV + a.gh - 1) / a.gh;
  const dim3 grid(a.KV * nhc, a.B, a.n_split), block(tc_warps<D, MT>() * 32);
  // the splits of a cell as one cluster where they are at most 8, the
  // partial fits beside the merge area and the grid is at most one
  // block an SM (the plan's one wave): with more, the clusters' blocks
  // took 1.2-1.5x the ticket's time on the card (PERF.md §6)
  int dev = 0, n_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  const size_t merge = (size_t)tc_warps<D, MT>() * 16 *
                       (D / col_parts<D>() + 2) * 4;
  const size_t partial = ((size_t)a.gh * D + ((2 * a.gh + 3) & ~3)) * 4 +
                         ((size_t)a.n_split + 1) * a.gh * 8;  // + weights
  if (a.n_split > 1 && a.n_split <= kMaxCluster &&
      merge + partial <= tc_union_bytes<T, D, MT>() &&
      (long long)grid.x * grid.y * grid.z <= n_sm) {
    const cudaError_t err = CLUSTER_Z_LAUNCH(
        kern, grid, block, smem, a.stream, (unsigned)a.n_split,
        (const T*)a.q, (const T*)a.k_pool, (const T*)a.v_pool,
        (const int*)a.table, (const int*)a.ctx_lens, (T*)a.out,
        (float*)a.m_out, (float*)a.l_out, (float*)a.part, (int*)a.counters,
        a.H, a.KV, a.P, a.maxp, a.n_split, a.pps, a.gh, a.scale, a.softcap,
        a.window);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  BWD_LAUNCH(kern, grid, block, smem, a.stream, (const T*)a.q,
             (const T*)a.k_pool, (const T*)a.v_pool, (const int*)a.table,
             (const int*)a.ctx_lens, (T*)a.out, (float*)a.m_out,
             (float*)a.l_out, (float*)a.part, (int*)a.counters, a.H, a.KV,
             a.P, a.maxp, a.n_split, a.pps, a.gh, a.scale, a.softcap,
             a.window);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_tc_d(const Args& a) {
  const bool cap = a.softcap > 0.f;
  if (a.gh <= 16)
    return cap ? launch_tc<T, D, 1, true>(a) : launch_tc<T, D, 1, false>(a);
  if (a.gh <= 32)
    return cap ? launch_tc<T, D, 2, true>(a) : launch_tc<T, D, 2, false>(a);
  if (a.gh <= kMaxBlockHeads)
    return cap ? launch_tc<T, D, 4, true>(a) : launch_tc<T, D, 4, false>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_tc_t(int D, const Args& a) {
  switch (D) {
    case 16: return launch_tc_d<T, 16>(a);
    case 32: return launch_tc_d<T, 32>(a);
    case 64: return launch_tc_d<T, 64>(a);
    case 128: return launch_tc_d<T, 128>(a);
    case 256: return launch_tc_d<T, 256>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <int D, int GC>
int launch_f32(const Args& a) {
  auto* kern = paged_attention_kernel<float, D, GC>;
  constexpr int TILE = tile_rows<float, D>();
  const size_t smem = 4 * (size_t)TILE * D * sizeof(float) +
                      sizeof(float) * kWarps * GC * (D + 2) +
                      sizeof(int) * (size_t)(a.pps > 0 ? a.pps : 1);
  if (smem > 48 * 1024) {  // above the default cap: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nhc = (a.H / a.KV + GC - 1) / GC;
  BWD_LAUNCH(kern, dim3(a.KV * nhc, a.B, a.n_split), dim3(kThreads), smem,
             a.stream, (const float*)a.q, (const float*)a.k_pool,
             (const float*)a.v_pool, (const int*)a.table,
             (const int*)a.ctx_lens, (float*)a.out, (float*)a.m_out,
             (float*)a.l_out, (float*)a.part, (int*)a.counters, a.H, a.KV,
             a.P, a.maxp, a.n_split, a.pps, a.scale, a.softcap, a.window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32_d(const Args& a) {
  switch (a.gh) {
    case 1: return launch_f32<D, 1>(a);
    case 4: return launch_f32<D, 4>(a);
    case 8: return launch_f32<D, 8>(a);
  }
  return (int)cudaErrorInvalidValue;
}

#if REPRO_PART_HAS(0)
int launch_f32_t(int D, const Args& a) {
  switch (D) {
    case 16: return launch_f32_d<16>(a);
    case 32: return launch_f32_d<32>(a);
    case 64: return launch_f32_d<64>(a);
    case 128: return launch_f32_d<128>(a);
    case 256: return launch_f32_d<256>(a);
  }
  return (int)cudaErrorInvalidValue;
}
#endif

}  // namespace

#if REPRO_PART_HAS(1)
int repro_paged::launch_bf16(int D, const Args& a) {
  return launch_tc_t<__nv_bfloat16>(D, a);
}
#endif
#if REPRO_PART_HAS(2)
int repro_paged::launch_f16(int D, const Args& a) {
  return launch_tc_t<__half>(D, a);
}
#endif

#if REPRO_PART_HAS(0)
// gh: query heads a block serves (bf16 / f16: ceil(G / chunks), at most
// 64; f32: 1, 4 or 8), G = H/KV heads in ceil(G/gh) chunks; n_split
// splits of pps pages each; part: n_split partials per (sequence, KV
// head, head chunk) when n_split > 1, each gh*D + 2*gh floats (bf16 /
// f16: the 2*gh rounded up to a multiple of 4); counters: one int per
// (sequence, KV head, head chunk), zero before the call and after.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* table, const void* ctx_lens, void* out, void* m_out,
    void* l_out, void* part, void* counters, int B, int H, int KV, int D,
    int P, int maxp, int gh, int n_split, int pps, float scale,
    float softcap, int window, int dtype, void* stream) {
  if (n_split < 1 || n_split > kMaxSplits || gh < 1 ||
      (n_split > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, table, ctx_lens, out, m_out, l_out,
               part, counters, B, H, KV, P, maxp, gh, n_split, pps, scale,
               softcap, window, (cudaStream_t)stream};
  switch (dtype) {
    case kF32: return launch_f32_t(D, a);
    case kBF16: return repro_paged::launch_bf16(D, a);
    case kF16: return repro_paged::launch_f16(D, a);
  }
  return (int)cudaErrorInvalidValue;
}
#endif
