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
// What bounds it: the function moves x in and y out once (~17 MB at the
// serving shape S=1024, H=64, P=64, N=128, bf16: ~5.9 us at 3.35 TB/s)
// and does ~5 S H P N flops (2.7 GFLOP), under the tensor cores' ridge,
// so its bound is bytes. Run as the recurrence it is one chain of S
// dependent token steps: the f32 body below, which also took bf16 until
// the tensor-core body came, runs ~600 cycles a step there.
//
// Two hand-written bodies, chosen by dtype:
// - bf16 (the serving path): `mamba_scan_tc_kernel`, the chunked SSD
//   form of the TPU kernel on the tensor cores. One block per (batch,
//   head, PS rows of P) walks S in chunks of Q tokens (Q = 128, eight
//   warps, at d_state 128; 64 and four at 16), one warp per 16 tokens:
//   one dependent step per chunk instead of per token, and the work
//   inside a chunk as mma.sync.m16n8k16 products (bf16 in, f32
//   accumulators, operands through ldmatrix from padded shared rows).
//   Per chunk: the next chunk's x slice, B, C and dt load with 16-byte
//   cp.async into the other of two shared stages, B and C in four parts
//   spread over the chunk (issued at once, they held each warp on its
//   load queue); each warp takes the prefix sums a_i of
//   dt A log2(e) and the end weights dt_j 2^(a_end - a_j) (shuffles);
//   y = 2^a_i C S^T + (G dt L) x + D x for its 16 tokens, where G =
//   C B^T on the tile pairs at or under the diagonal is scaled in
//   registers by dt_j 2^(a_i - a_j) for j <= i (exponent clamped to <=
//   0, 0 above) and reused as the A operand, as flash attention reuses
//   P; y goes out through shared memory in 16-byte stores; then the
//   state S = 2^a_end S + (x dt 2^(a_end - a_j))^T B. S [PS, N] stays in
//   f32 accumulator registers over the whole sequence, split by tiles
//   over the warps, and a copy in shared memory feeds the next chunk's
//   C S^T. x, B and C are bf16 already and enter the products exactly;
//   the three operands made in f32 (G dt L, x dt 2^(a_end - a_j) and the
//   copy of S) go in as a bf16 hi + lo pair, two products each: one
//   bf16 rounding of them puts the y error above the 8e-2 tolerance at
//   the GPU tests' dt range, the pair well inside it
//   (tools/mamba_scan_rounding.py emulates each choice). The warp
//   whose 16 tokens lie furthest into the chunk has the most tiles
//   under the diagonal; the warps sharing a scheduler (w, w + 4) take
//   token tiles r and 7 - r, so the causal work is even over the four
//   schedulers.
//   Ragged edges need no padding: rows past S load as x = B = C = 0 and
//   dt = 0 (decay 1, nothing added to S) and their y is not stored;
//   rows past P load as x = 0 and are not stored. The chunk size of the
//   reference does not enter the result beyond rounding.
//   What holds it now: ~9400 cycles a chunk of 128 tokens
//   (tools/mamba_scan_probe.py --trace), against ~500 mma a scheduler
//   and ~480 KB of ldmatrix reads an SM by count, so neither the tensor
//   pipe nor shared memory is full: the phases between the two
//   barriers are chains of dependent loads, products and exponentials
//   with two warps a scheduler to hide them. G = C B^T is the same for
//   every head and is recomputed by each block.
// - f32: `mamba_scan_kernel`, the recurrence itself on the CUDA cores
//   (TF32 operands would miss the f32 tolerance 5e-3). The state is
//   split by rows across blocks: one block per (batch, head, 32-row
//   slice of P), 4 threads per row, each thread holding N/4 columns of
//   its row in registers for the whole sequence. Tokens are staged 64 at
//   a time in shared memory (B, C and x as f32, the per-token decay
//   exp(dt A)), B and C as 16-byte vector loads read back as float4
//   broadcasts; y of a row is a sum over N combined with two shuffles
//   and stored through shared memory.
// Both take any S >= 1 and any P; built for d_state 16 (the smoke
// configuration) and 128 (mamba2-1.3b).
#include "common.cuh"

// ---- the f32 body: the recurrence on the CUDA cores --------------------
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


// ---- the bf16 body: chunked SSD on the tensor cores ---------------------
using bf16 = __nv_bfloat16;

// 4-byte asynchronous global -> shared copy; zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

// (a, b) -> hi + lo as two bf16 pairs: hi = bf16(v), lo = bf16(v - hi),
// ~16 bits of mantissa between them (two products instead of one)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One block: Q tokens a chunk, one warp per 16 of them; PS rows of P;
// state width N. Shared memory, in bf16 elements unless noted: two
// stages of x [Q][PS+8], B [Q][N+8] and C [Q][N+8]; the state's hi and
// lo parts [2][PS][N+8]; x dt 2^(a_end - a_j), hi and lo [2][Q][PS+8];
// the y tile [Q][PS+8]; two stages of dt [Q] f32; each warp's prefix
// sums and end weights [W][2][Q] f32
template <int N, int PS, int Q>
struct TcPlan {
  static constexpr int W = Q / 16, kThreads = 32 * W;
  static constexpr int LDN = N + 8, LDP = PS + 8;   // padded rows
  static constexpr int kStage = Q * LDP + 2 * Q * LDN;
  static constexpr size_t bytes =
      sizeof(bf16) * (2 * kStage + 2 * PS * LDN + 3 * Q * LDP) +
      sizeof(float) * (2 * Q + 2 * W * Q);
};

template <int N, int PS, int Q>
__global__ void __launch_bounds__(2 * Q)   // TcPlan::kThreads
    mamba_scan_tc_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const bf16* __restrict__ Bm,
                         const bf16* __restrict__ Cm,
                         const float* __restrict__ D,
                         const float* __restrict__ s0, bf16* __restrict__ y,
                         float* __restrict__ fin, int S, int H, int P,
                         int vec) {
  using M = Mma<bf16>;
  using L = TcPlan<N, PS, Q>;
  constexpr int W = L::W, NT = L::kThreads;
  constexpr int LDN = L::LDN, LDP = L::LDP;
  constexpr int NKS = N / 16;              // k-steps over the state width
  constexpr int NJQ = Q / 32;              // pairs of 16-token tiles
  constexpr int NPT = PS / 8;              // 8-wide p tiles of y
  constexpr int MT = PS / 16;              // 16-row p tiles of the state
  constexpr int NTW = (N / 8) * MT / W;    // 8-wide state n tiles a warp
  constexpr int TPL = Q / 32;              // tokens a lane in the scan
  static_assert(PS % 16 == 0 && W % MT == 0, "whole p tiles");
  static_assert(NTW >= 2 && NTW % 2 == 0, "pairs of state tiles a warp");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stg = reinterpret_cast<bf16*>(smem_raw);   // [2][kStage]
  bf16* ss = stg + 2 * L::kStage;                  // [2][PS][LDN]
  bf16* xws = ss + 2 * PS * LDN;                   // [2][Q][LDP]
  bf16* ys = xws + 2 * Q * LDP;                    // [Q][LDP]
  float* dts = reinterpret_cast<float*>(ys + Q * LDP);   // [2][Q]
  float* acs = dts + 2 * Q;                              // [W][2][Q]

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;   // fragment row, column pair
  // this warp's 16 tokens: tiles rt and W-1-rt share a scheduler (warps
  // w and w + 4), so the causal work is even across the four
  const int rt = warp < W / 2 ? warp : 3 * W / 2 - 1 - warp;
  constexpr float kLog2e = 1.4426950408889634f;
  const float a_h = A[h] * kLog2e, d_h = D[h];   // decays in log2 units
  const size_t xstride = (size_t)H * P;      // between tokens of x and y
  const bf16* xb = x + (size_t)b * S * xstride + (size_t)h * P + p0;
  bf16* yb = y + (size_t)b * S * xstride + (size_t)h * P + p0;
  const float* dtb = dt + (size_t)b * S * H + h;
  const bf16* Bb = Bm + (size_t)b * S * N;
  const bf16* Cb = Cm + (size_t)b * S * N;

  // chunk c -> stage st, with 16-byte cp.async; rows past S and P are
  // zero-filled. B and C go in kSlices parts spread over the chunk's
  // compute (issued all at once, they held every warp on its load
  // queue before its first product); the rest, x and dt, with part 0.
  constexpr int CPR = N / 8;                   // 16-byte pieces a row
  constexpr int kSlices = Q * CPR / NT < 4 ? Q * CPR / NT : 4;
  constexpr int kPer = Q * CPR / NT / kSlices;  // pieces a thread a part
  static_assert(Q * CPR % (NT * kSlices) == 0, "whole rounds");
  auto load_bc = [&](int c, int st, int part) {
    if (part >= kSlices) return;
    const int t0 = c * Q;
    bf16* bs = stg + st * L::kStage + Q * LDP;
    bf16* cs = bs + Q * LDN;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = tid + (part * kPer + i) * NT;
      const int r = k / CPR, cc = k % CPR;
      const bool ok = t0 + r < S;
      const size_t off = ok ? (size_t)(t0 + r) * N + cc * 8 : 0;
      cp_async16(bs + r * LDN + cc * 8, Bb + off, ok);
      cp_async16(cs + r * LDN + cc * 8, Cb + off, ok);
    }
  };
  auto load_chunk = [&](int c, int st) {
    const int t0 = c * Q;
    bf16* xs = stg + st * L::kStage;
    load_bc(c, st, 0);
    if (vec) {                                 // P % 8 == 0, aligned
      constexpr int XPR = PS / 8;
#pragma unroll
      for (int i = 0; i < (Q * XPR + NT - 1) / NT; ++i) {
        const int k = tid + i * NT;
        const int r = k / XPR, cc = k % XPR;
        const bool ok = k < Q * XPR && t0 + r < S && p0 + cc * 8 < P;
        cp_async16(xs + r * LDP + cc * 8,
                   xb + (ok ? (size_t)(t0 + r) * xstride + cc * 8 : 0), ok);
      }
    } else {
      for (int k = tid; k < Q * PS; k += NT) {
        const int r = k / PS, cc = k % PS;
        xs[r * LDP + cc] = (t0 + r < S && p0 + cc < P)
                               ? xb[(size_t)(t0 + r) * xstride + cc]
                               : __float2bfloat16(0.f);
      }
    }
    if (tid < Q) {
      const bool ok = t0 + tid < S;
      cp_async4(dts + st * Q + tid,
                dtb + (ok ? (size_t)(t0 + tid) * H : 0), ok);
    }
  };

  // the state: this warp's 16-row p tile mt and NTW n tiles from nt0,
  // f32 accumulators for the whole sequence
  const int mt = warp % MT, nt0 = (warp / MT) * NTW;
  const size_t sb = ((size_t)b * H + h) * P;
  float sacc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int p = p0 + mt * 16 + g8 + 8 * hi;
      const int n = (nt0 + j) * 8 + 2 * t4;
      float2 v = make_float2(0.f, 0.f);
      if (s0 != nullptr && p < P)
        v = *reinterpret_cast<const float2*>(s0 + (sb + p) * N + n);
      sacc[j][2 * hi] = v.x;
      sacc[j][2 * hi + 1] = v.y;
    }
  }
  auto store_state = [&]() {        // hi and lo bf16 copies for C S^T
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int off = (mt * 16 + g8 + 8 * hi) * LDN + (nt0 + j) * 8 + 2 * t4;
        split_bf16(sacc[j][2 * hi], sacc[j][2 * hi + 1],
                   *reinterpret_cast<uint32_t*>(ss + off),
                   *reinterpret_cast<uint32_t*>(ss + PS * LDN + off));
      }
    }
  };

  const int nch = (S + Q - 1) / Q;
  store_state();
  load_chunk(0, 0);
#pragma unroll
  for (int part = 1; part < kSlices; ++part) load_bc(0, 0, part);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    const int st = c & 1, t0 = c * Q;
    const bool next = c + 1 < nch;
    cp_async_wait<0>();
    __syncthreads();     // chunk c and S landed; chunk c-1 fully read
    if (next) load_chunk(c + 1, st ^ 1);
    const bf16* xs = stg + st * L::kStage;
    const bf16* bs = xs + Q * LDP;
    const bf16* cs = bs + Q * LDN;
    const float* dtc = dts + st * Q;

    // a_i: inclusive prefix sum of dt A log2(e) over the chunk, TPL
    // consecutive tokens a lane, and wq_j = dt_j 2^(a_end - a_j), the
    // weight of token j in the chunk's state update; every warp keeps
    // its own copy (no block barrier)
    float* ac = acs + warp * 2 * Q;
    float* wq = ac + Q;
    {
      float loc[TPL];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < TPL; ++k) {
        run += dtc[TPL * lane + k] * a_h;
        loc[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const float excl = incl - run;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int k = 0; k < TPL; ++k) {
        const float a = excl + loc[k];
        ac[TPL * lane + k] = a;
        wq[TPL * lane + k] =
            dtc[TPL * lane + k] * exp2f(fminf(last - a, 0.f));
      }
    }
    __syncwarp();

    // this warp's C rows as A operands (tokens i = 16 rt + [0, 16))
    uint32_t cf[NKS][4];
#pragma unroll
    for (int s = 0; s < NKS; ++s)
      ldsm_x4(cf[s], cs + (rt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                              * LDN + s * 16 + (lane >> 4) * 8);
    const int i0 = rt * 16 + g8;
    const float ai[2] = {ac[i0], ac[i0 + 8]};

    // y = 2^a_i C S^T + (G dt L) x + D x for this warp's tokens; hi and
    // lo products and the two terms go to separate accumulators (short
    // mma chains)
    float yo[2][NPT][4], yd[2][NPT][4];
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int nt = 0; nt < NPT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yo[part][nt][e] = yd[part][nt][e] = 0.f;
#pragma unroll
    for (int s = 0; s < NKS; ++s) {
#pragma unroll
      for (int pp = 0; pp < NPT / 2; ++pp) {
#pragma unroll
        for (int part = 0; part < 2; ++part) {    // S = hi + lo
          uint32_t bb[4];
          ldsm_x4(bb, ss + part * PS * LDN +
                          (pp * 16 + (lane & 7) + (lane >> 4) * 8) * LDN +
                          s * 16 + ((lane >> 3) & 1) * 8);
          M::run(yo[part][2 * pp], cf[s], bb[0], bb[1]);
          M::run(yo[part][2 * pp + 1], cf[s], bb[2], bb[3]);
        }
      }
    }

    if (next) load_bc(c + 1, st ^ 1, 1);

    // the intra-chunk term, 32 tokens j at a time: G = C B^T, scaled by
    // dt_j 2^(a_i - a_j) for j <= i and 0 above (branch-free: the
    // exponent is clamped to <= 0 and masked), packed as hi and lo A
    // operands of G x. Pairs wholly above the diagonal are skipped.
#pragma unroll
    for (int jq = 0; jq < NJQ; ++jq) {
      if (2 * jq > rt) continue;              // warp-uniform
      float g[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        g[nt][0] = g[nt][1] = g[nt][2] = g[nt][3] = 0.f;
#pragma unroll
      for (int s = 0; s < NKS; ++s) {
#pragma unroll
        for (int jh = 0; jh < 2; ++jh) {
          uint32_t bb[4];
          ldsm_x4(bb, bs + ((2 * jq + jh) * 16 + (lane & 7) +
                            (lane >> 4) * 8) * LDN +
                          s * 16 + ((lane >> 3) & 1) * 8);
          M::run(g[2 * jh], cf[s], bb[0], bb[1]);
          M::run(g[2 * jh + 1], cf[s], bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        const int jp = 2 * jq + jh;
        float v[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j0 = (2 * jp + q) * 8 + 2 * t4;  // this thread's j, j+1
          const float2 aj = *reinterpret_cast<const float2*>(ac + j0);
          const float2 dj = *reinterpret_cast<const float2*>(dtc + j0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + (e >> 1) * 8, j = j0 + (e & 1);
            const float w =
                exp2f(fminf(ai[e >> 1] - ((e & 1) ? aj.y : aj.x), 0.f)) *
                ((e & 1) ? dj.y : dj.x);
            v[q][e] = g[2 * jh + q][e] * (j <= i ? w : 0.f);
          }
        }
        uint32_t gp[4], gl[4];
        split_bf16(v[0][0], v[0][1], gp[0], gl[0]);
        split_bf16(v[0][2], v[0][3], gp[1], gl[1]);
        split_bf16(v[1][0], v[1][1], gp[2], gl[2]);
        split_bf16(v[1][2], v[1][3], gp[3], gl[3]);
#pragma unroll
        for (int pp = 0; pp < NPT / 2; ++pp) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, xs + (jp * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * LDP +
                                pp * 16 + (lane >> 4) * 8);
          M::run(yd[0][2 * pp], gp, bb[0], bb[1]);
          M::run(yd[0][2 * pp + 1], gp, bb[2], bb[3]);
          M::run(yd[1][2 * pp], gl, bb[0], bb[1]);
          M::run(yd[1][2 * pp + 1], gl, bb[2], bb[3]);
        }
      }
    }
    if (next) load_bc(c + 1, st ^ 1, 2);
    const float ei[2] = {exp2f(ai[0]), exp2f(ai[1])};
    // all shared loads before the stores (the compiler keeps shared
    // loads and stores in order: interleaved, each pair waits)
    float2 xv[NPT][2];
#pragma unroll
    for (int nt = 0; nt < NPT; ++nt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        xv[nt][hi] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                xs + (i0 + 8 * hi) * LDP + nt * 8 + 2 * t4));
#pragma unroll
    for (int nt = 0; nt < NPT; ++nt) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int off = (i0 + 8 * hi) * LDP + nt * 8 + 2 * t4;
        const float2 xf = xv[nt][hi];
        float o[2];
#pragma unroll
        for (int k = 0; k < 2; ++k)
          o[k] = (yo[0][nt][2 * hi + k] + yo[1][nt][2 * hi + k]) * ei[hi] +
                 yd[0][nt][2 * hi + k] + yd[1][nt][2 * hi + k];
        *reinterpret_cast<uint32_t*>(ys + off) =
            M::pack(o[0] + d_h * xf.x, o[1] + d_h * xf.y);
      }
    }

    // x wq: the chunk's inputs decayed to its end (loads first)
    const float a_end = ac[Q - 1];
    constexpr int kXw = Q * PS / 2 / NT;       // pairs a thread
    static_assert(Q * PS / 2 % NT == 0, "whole rounds");
    float2 xw[kXw];
    float ww[kXw];
#pragma unroll
    for (int it = 0; it < kXw; ++it) {
      const int k = tid + it * NT;
      const int r = k / (PS / 2), off = r * LDP + 2 * (k % (PS / 2));
      ww[it] = wq[r];
      xw[it] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + off));
    }
#pragma unroll
    for (int it = 0; it < kXw; ++it) {
      const int k = tid + it * NT;
      const int off = (k / (PS / 2)) * LDP + 2 * (k % (PS / 2));
      split_bf16(xw[it].x * ww[it], xw[it].y * ww[it],
                 *reinterpret_cast<uint32_t*>(xws + off),
                 *reinterpret_cast<uint32_t*>(xws + Q * LDP + off));
    }
    if (next) load_bc(c + 1, st ^ 1, 3);
    cp_async_commit();
    __syncthreads();     // xw and the y tile written; S's copy read

    // S = 2^a_end S + (x dt 2^(a_end - a_j))^T B, the lo products into
    // a second accumulator
    const float decay = exp2f(a_end);
    float sl[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[j][e] *= decay;
        sl[j][e] = 0.f;
      }
#pragma unroll
    for (int jp = 0; jp < Q / 16; ++jp) {
      uint32_t af[2][4];                           // hi and lo
#pragma unroll
      for (int part = 0; part < 2; ++part)
        ldsm_x4_trans(af[part], xws + part * Q * LDP +
                                    (jp * 16 + (lane & 7) + (lane >> 4) * 8) *
                                        LDP +
                                    mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < NTW / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, bs + (jp * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * LDN +
                              (nt0 + 2 * np) * 8 + (lane >> 4) * 8);
        M::run(sacc[2 * np], af[0], bb[0], bb[1]);
        M::run(sacc[2 * np + 1], af[0], bb[2], bb[3]);
        M::run(sl[2 * np], af[1], bb[0], bb[1]);
        M::run(sl[2 * np + 1], af[1], bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] += sl[j][e];
    if (next) store_state();

    // this chunk's y rows out
    const int nrow = min(Q, S - t0);
    if (vec) {
#pragma unroll
      for (int it = 0; it < (Q * PS / 8 + NT - 1) / NT; ++it) {
        const int k = tid + it * NT;
        const int r = k / (PS / 8), cc = 8 * (k % (PS / 8));
        if (k < Q * PS / 8 && r < nrow && p0 + cc < P)
          *reinterpret_cast<uint4*>(yb + (size_t)(t0 + r) * xstride + cc) =
              *reinterpret_cast<const uint4*>(ys + r * LDP + cc);
      }
    } else {
      for (int k = tid; k < Q * PS; k += NT) {
        const int r = k / PS, cc = k % PS;
        if (r < nrow && p0 + cc < P)
          yb[(size_t)(t0 + r) * xstride + cc] = ys[r * LDP + cc];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NTW; ++j) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int p = p0 + mt * 16 + g8 + 8 * hi;
      if (p < P)
        *reinterpret_cast<float2*>(fin + (sb + p) * N + (nt0 + j) * 8 +
                                   2 * t4) =
            make_float2(sacc[j][2 * hi], sacc[j][2 * hi + 1]);
    }
  }
}

static size_t smem_bytes(int N) {
  return sizeof(float) *
         ((size_t)2 * kTile * N + (size_t)2 * kTile * kRows + 2 * kTile);
}

template <int N>
static int launch_f32(const void* x, const void* dt, const void* A,
                      const void* B, const void* C, const void* D,
                      const void* s0, void* y, void* fin, int Bt, int S,
                      int H, int P, cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel<float, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + kRows - 1) / kRows, H, Bt);
  mamba_scan_kernel<float, N><<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)B,
      (const float*)C, (const float*)D, (const float*)s0, (float*)y,
      (float*)fin, S, H, P);
  return (int)cudaGetLastError();
}

template <int N, int PS, int Q>
static int launch_tc(const void* x, const void* dt, const void* A,
                     const void* B, const void* C, const void* D,
                     const void* s0, void* y, void* fin, int Bt, int S,
                     int H, int P, cudaStream_t stream) {
  using L = TcPlan<N, PS, Q>;
  constexpr size_t smem = L::bytes;
  if (smem > 48 * 1024) {  // above the default cap: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        mamba_scan_tc_kernel<N, PS, Q>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte x / y pieces need whole 8-element groups of P, aligned
  const int vec = P % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)y % 16 == 0;
  dim3 grid((P + PS - 1) / PS, H, Bt);
  mamba_scan_tc_kernel<N, PS, Q><<<grid, L::kThreads, smem, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
      (const bf16*)C, (const float*)D, (const float*)s0, (bf16*)y,
      (float*)fin, S, H, P, vec);
  return (int)cudaGetLastError();
}

extern "C" int mamba_scan_launch(const void* x, const void* dt,
                                 const void* A, const void* B, const void* C,
                                 const void* D, const void* s0, void* y,
                                 void* fin, int Bt, int S, int H, int P,
                                 int N, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_SCAN_ARGS x, dt, A, B, C, D, s0, y, fin, Bt, S, H, P, s
  if (dtype == kF32) {
    if (N == 16) return launch_f32<16>(REPRO_SCAN_ARGS);
    if (N == 128) return launch_f32<128>(REPRO_SCAN_ARGS);
  } else if (dtype == kBF16) {
    // the plan from d_state alone: at 128, 32 rows of P a block (128
    // blocks at mamba2's 64 heads of 64; 16 rows ran slower,
    // tools/mamba_scan_probe.py) and chunks of 128 tokens, eight warps;
    // at 16, 64 rows and chunks of 64, four warps (so that the state
    // tiles of each warp still pair up)
    if (N == 16) return launch_tc<16, 64, 64>(REPRO_SCAN_ARGS);
    if (N == 128) return launch_tc<128, 32, 128>(REPRO_SCAN_ARGS);
  }
#undef REPRO_SCAN_ARGS
  return (int)cudaErrorInvalidValue;
}
