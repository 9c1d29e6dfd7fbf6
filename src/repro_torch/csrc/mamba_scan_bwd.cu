// The gradient of the Mamba2 SSD scan for Hopper (sm_90a): training.
//
// The reference takes it with jax.grad through its blocked lowering of
// repro/kernels/mamba_scan.py (`mamba_chunk_scan`; the Pallas kernel has
// no backward). Inputs as the forward (csrc/mamba_scan.cu): x [Bt,S,H,P],
// dt [Bt,S,H] f32, A/D [H] f32, B/C [Bt,S,N] (one group, shared by every
// head), optional initial state [Bt,H,P,N] f32; and the cotangents dy
// [Bt,S,H,P] (x's dtype) and dfinal [Bt,H,P,N] f32 (or none: zero).
// Outputs: dx in x's dtype, dB and dC in x's dtype (summed in f32), ddt,
// dA, dD and dinitial_state in f32. The arithmetic is that of
// `mamba_chunk_scan_bwd_blocked` (kernels/ref.py). In a chunk of Q
// tokens with c_i the inclusive cumulative sum of dt A and S0 the state
// entering it:
//   y_i   = e^{c_i} C_i S0^T + sum_{j<=i} e^{c_i-c_j} dt_j (C_i.B_j) x_j
//           + D x_i,
//   S_end = e^{c_L} S0 + T,  T = sum_j e^{c_L-c_j} dt_j x_j B_j^T.
//
// What bounds it: it moves x, dy, dx, B, C, dB, dC, dt and ddt once
// (~214 MB at mamba2-1.3b's training shape, Bt=8 S=1024 H=64 P=64
// N=128 bf16: ~0.064 ms at 3.35 TB/s) and does ~10 Bt S H P N flops
// (~43 GFLOP), so bytes bound it on the tensor cores.
//
// Two hand-written bodies, chosen by dtype and shape:
// - bf16 with P <= 64 (the training path): chunk-parallel on the tensor
//   cores, three launches. Across chunks the only dependence is the
//   P x N state S0_{c+1} = e^{c_L} S0_c + T_c and its adjoint G_{c-1} =
//   e^{c_L} G_c + U_c (G_c = dL/dS_end of chunk c, U_c = sum_i e^{c_i}
//   dy_i^T C_i): the chunked SSD form of arXiv:2405.21060 section 6,
//   applied to the backward.
//   1. `mamba_scan_bwd_walk`: one 256-thread block a (head, batch,
//      direction) walks chunks of kTQ = 64 tokens, the state (or the
//      adjoint, in reverse from dfinal) in f32 mma accumulators [64 x N],
//      and writes its value at each chunk's entry (or end) to a scratch
//      of the call ([Bt,H,nc,64,N] f32 each); the update is one product
//      (v w)^T W a chunk, v = x, w_j = e^{c_L-c_j} dt_j, W = B (or v =
//      dy, w_i = e^{c_i}, W = C), with v w a bf16 hi + lo pair. The
//      adjoint's last value is dinitial_state. Two stages of cp.async
//      loads, two barriers a chunk.
//   2. `mamba_scan_bwd_grads`: one 512-thread block a (group of kHG = 8
//      heads, chunk, batch) takes S0_c and G_c of each head in turn and
//      forms every gradient chunk-locally, all products as
//      mma.sync.m16n8k16 (bf16 in, f32 accumulators, operands through
//      ldmatrix from padded shared rows): C B^T once for the group, then
//      per head dy x^T [Q x Q over P], dy S0 and x G [Q x N over P], B
//      G^T [Q x P over N] and dx = A1^T dy [Q x P over Q, tiles at or
//      under the diagonal], A1 = w C B^T; the pair weights w =
//      e^{c_i-c_j} for j <= i and 0 above (no exponential of a positive
//      number). dB and dC are summed over the group inside the block:
//      the off-diagonal terms e^{c_i} dy_i S0 and e^{c_L-c_j} dt_j x_j G
//      in f32 in shared memory, head after head, and the weighted pairs
//      A2 = w dt_j dy_i.x_j summed in registers over the group before
//      one product each with B and C at the end. ddt (the direct term
//      and A dl, dl the reverse cumulative sum of each c_i's gradient,
//      whose chunk-end terms e^{c_L} <G, S0> and sum_j dt_j F_j are
//      chunk-local; one warp, shuffles) is written whole; dA and dD as
//      per-(batch, chunk, head) partials, dB and dC as per-group
//      partials ([Bt,S,H/8,N]). Three barriers a head; the next head's
//      x and dy (cp.async) and states load behind the last.
//   3. `mamba_scan_bwd_tc_reduce`: the partials summed in a fixed order
//      (groups; batches and chunks): bit-identical on repeat, no float
//      atomics.
//   x, dy, B and C are bf16 and enter the products exactly; the operands
//   made in f32 (S0, G, A1, the group's A2 and the walk's v w) go in as
//   bf16 hi + lo pairs, two products each: rounded once, each of them
//   alone breaks a gate by 3-28x (tools/mamba_scan_bwd_rounding.py).
//   Rows past S load as x = dy = B = C = 0 with dt = 0 and are not
//   stored; rows past P load as zero. Built for d_state 16 and 128.
//   Resources at N = 128 (ptxas, H100): the walk 128 registers (its
//   bound of two blocks an SM) and 74,240 bytes of shared memory, two
//   blocks of 8 warps an SM; the gradient block 128 registers (16 warps
//   fill the register file) and 218,304 bytes, one block of 16 warps an
//   SM; at mamba2-1.3b's training shape (Bt=8 S=1024 H=64 P=64) 1,024
//   walk blocks (3.9 waves) and 1,024 gradient blocks (7.8 waves), and
//   604,045,312 bytes of scratch (S0 and G 268 MB each, written once and
//   read once; the dB / dC partials 34 MB each). Chunks of 64 keep the
//   gradient block in one SM; chunks of 128 would halve the scratch but
//   need 4x the pair matrices' shared memory.
// - f32 (and bf16 with P > 64): the first version, the products in f32
//   on the CUDA cores (TF32 operands would miss the f32 gate). One block
//   of kNT threads per (batch, head, kPB rows of P) walks the sequence
//   twice.
//   - Forward, chunk by chunk: the state [kPB, N] in f32 registers (kPB
//     N / kNT values a thread), its value entering each chunk written to
//     a scratch of the block's own ([Bt, H*np, n_chunks, kPB, N] f32),
//     then S = e^{c_L} S + sum_j e^{c_L-c_j} dt_j x_j B_j^T.
//   - Backward, chunk by chunk in reverse, carrying G = dL/dS_end in f32
//     registers and a copy in shared memory (dfinal at the end). A chunk
//     stages x, dy, B, C (as f32), dt and its entry state in shared
//     memory, then forms its Q x Q pair weights (e^{c_i-c_j} for j <= i;
//     above the diagonal the weight is 0 and no exponential is taken),
//     G B_j, x_j^T G and dy_i^T S0, and from them dx, dB, dC, the direct
//     dt term and the gradient of each c_i; the reverse cumulative sum
//     of that gradient is the log-decays' dl: ddt += A dl, dA += dt dl.
//     Then G = e^{c_L} G + sum_i e^{c_i} dy_i^T C_i; after the first
//     chunk G is dinitial_state.
//   B and C are one group shared by all H heads, and dA, dD sum over the
//   batch and the sequence, so a block writes per-(head, P-slice)
//   partials of dB, dC ([Bt, S, H*np, N] f32), ddt, dA and dD, and a
//   second launch sums them in a fixed order. Every phase ends at a
//   block barrier and uses no warp primitive, so this body also runs on
//   the CPU with one thread per CUDA thread (-DREPRO_HOST_EMULATION:
//   the stand-in of host_emulation.cuh; tools/mamba_scan_bwd_host_check.py,
//   which routes bf16 here too; with -DREPRO_HOST_WARPS the tensor-core
//   body is built as well and runs on the stand-in's warp primitives).
#include "common.cuh"

namespace {

constexpr int kQ = 32;    // tokens a chunk
constexpr int kPB = 64;   // rows of P a block
constexpr int kNT = 256;  // threads a block
constexpr int kLDP = kPB + 1, kLDQ = kQ + 1;   // padded rows (f32 words)

// shared memory of one block, in floats: the chunk's x and dy [kQ][kLDP],
// B and C [kQ][LDN], G and S0 [kPB][LDN], G B_j [kQ][kLDP], x_j^T G and
// dy_i^T S0 [kQ][LDN], the pair matrices A1 = w CB, A2 = w dt_j dyx and
// R = A1 dyx [kQ][kLDQ] (row i, column j), per-token vectors and a
// block-reduction buffer
template <int N>
struct BwdPlan {
  static constexpr int LDN = N + 1;
  static constexpr int xs = 0, dys = xs + kQ * kLDP, bs = dys + kQ * kLDP;
  static constexpr int cs = bs + kQ * LDN, gs = cs + kQ * LDN;
  static constexpr int s0s = gs + kPB * LDN, gbs = s0s + kPB * LDN;
  static constexpr int xgs = gbs + kQ * kLDP, dyss = xgs + kQ * LDN;
  static constexpr int a1s = dyss + kQ * LDN, a2s = a1s + kQ * kLDQ;
  static constexpr int rs = a2s + kQ * kLDQ, dts = rs + kQ * kLDQ;
  static constexpr int cum = dts + kQ;     // c_i
  static constexpr int ein = cum + kQ;     // e^{c_i}
  static constexpr int eend = ein + kQ;    // e^{c_L - c_j}
  static constexpr int wv = eend + kQ;     // forward: e^{c_L-c_j} dt_j;
                                           // backward: dt_i F_i
  static constexpr int dc = wv + kQ;       // dL/dc_i, partial
  static constexpr int red = dc + kQ;      // [kNT]
  static constexpr int scal = red + kNT;   // [4]
  static constexpr int floats = scal + 4;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <typename T, int N>
__global__ void __launch_bounds__(kNT) mamba_scan_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ s0, const T* __restrict__ dy,
    const float* __restrict__ dfin, T* __restrict__ dx,
    float* __restrict__ ds0, float* __restrict__ st,
    float* __restrict__ pdB, float* __restrict__ pdC,
    float* __restrict__ pddt, float* __restrict__ pdA,
    float* __restrict__ pdD, int S, int H, int P) {
  using L = BwdPlan<N>;
  constexpr int LDN = L::LDN;
  constexpr int EPT = kPB * N / kNT;   // state elements a thread
  constexpr int RS = kNT / N;          // row step of the [.][N] layouts
  constexpr int QN = kQ * N / kNT;     // (token, n) outputs a thread
  constexpr int QP = kQ * kPB / kNT;   // (token, p) outputs a thread
  constexpr int QQ = kQ * kQ / kNT;    // (i, j) pairs a thread
  constexpr int PS = kNT / kPB;        // token step of the (token, p) layout
  static_assert(kNT % N == 0 && EPT >= 1 && QN >= 1, "layouts");
  BWD_SMEM(smem_raw);
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* xs = sm + L::xs;
  float* dys = sm + L::dys;
  float* bs = sm + L::bs;
  float* cs = sm + L::cs;
  float* gs = sm + L::gs;
  float* s0s = sm + L::s0s;
  float* gbs = sm + L::gbs;
  float* xgs = sm + L::xgs;
  float* dyss = sm + L::dyss;
  float* a1s = sm + L::a1s;
  float* a2s = sm + L::a2s;
  float* rs = sm + L::rs;
  float* dts = sm + L::dts;
  float* cum = sm + L::cum;
  float* ein = sm + L::ein;
  float* eend = sm + L::eend;
  float* wv = sm + L::wv;
  float* dc = sm + L::dc;
  float* red = sm + L::red;
  float* scal = sm + L::scal;

  const int np = gridDim.x, ps = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int p0 = ps * kPB, U = H * np, u = h * np + ps;
  const int tid = threadIdx.x;
  const int nc = (S + kQ - 1) / kQ;
  const float a_h = A[h], d_h = D[h];
  // this thread's state elements: (p_own + RS e, n_own), e < EPT
  const int n_own = tid % N, p_own = tid / N;
  const size_t sbase = ((size_t)b * H + h) * P + p0;   // row p0 of [Bt,H,P,N]
  float* stb = st + ((size_t)b * U + u) * nc * (kPB * N);
  const size_t xstride = (size_t)H * P;                // between tokens

  // chunk at t0 -> shared memory (x, dt, B; with dy and C for the
  // backward); rows past S or P are zero. Every load of a thread
  // starts before its first store (compile-time trip counts): with one
  // block an SM, a load's latency is not hidden by other warps
  constexpr int KX = kQ * kPB / kNT, KB = kQ * N / kNT;
  auto load_chunk = [&](int t0, bool bwd) {
    float vx[KX], vdy[KX], vb[KB], vc[KB];
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const int i = tid + k * kNT, r = i / kPB, p = i % kPB, t = t0 + r;
      const bool ok = t < S && p0 + p < P;
      const size_t off = ((size_t)b * S + t) * xstride + (size_t)h * P + p0 + p;
      vx[k] = ok ? to_f32(x[off]) : 0.f;
      vdy[k] = ok && bwd ? to_f32(dy[off]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int i = tid + k * kNT, r = i / N, n = i % N, t = t0 + r;
      const bool ok = t < S;
      const size_t off = ((size_t)b * S + t) * N + n;
      vb[k] = ok ? to_f32(Bm[off]) : 0.f;
      vc[k] = ok && bwd ? to_f32(Cm[off]) : 0.f;
    }
    const float vdt = tid < kQ && t0 + tid < S
                          ? dt[((size_t)b * S + t0 + tid) * H + h] : 0.f;
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const int i = tid + k * kNT, r = i / kPB, p = i % kPB;
      xs[r * kLDP + p] = vx[k];
      if (bwd) dys[r * kLDP + p] = vdy[k];
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int i = tid + k * kNT, r = i / N, n = i % N;
      bs[r * LDN + n] = vb[k];
      if (bwd) cs[r * LDN + n] = vc[k];
    }
    if (tid < kQ) dts[tid] = vdt;
  };
  // c_i, e^{c_i} and e^{c_L - c_i} of the staged chunk (one thread a
  // token, each summing in the same order, so c_L is the same everywhere)
  auto chunk_decays = [&]() {
    if (tid < kQ) {
      float run = 0.f, mine = 0.f;
      for (int k = 0; k < kQ; ++k) {
        run += dts[k] * a_h;
        if (k == tid) mine = run;
      }
      cum[tid] = mine;
      ein[tid] = expf(mine);
      eend[tid] = expf(fminf(run - mine, 0.f));
    }
  };

  // ---- forward: the state entering each chunk -> scratch -------------
  float sv[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int p = p_own + RS * e;
    sv[e] = (s0 != nullptr && p0 + p < P) ? s0[(sbase + p) * N + n_own] : 0.f;
  }
  for (int c = 0; c < nc; ++c) {
    __syncthreads();                 // the previous chunk is read
    load_chunk(c * kQ, false);
    __syncthreads();
    chunk_decays();
    __syncthreads();
    if (tid < kQ) wv[tid] = eend[tid] * dts[tid];
    __syncthreads();
    float* dst = stb + (size_t)c * kPB * N;
    const float el = ein[kQ - 1];    // e^{c_L}
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int p = p_own + RS * e;
      dst[p * N + n_own] = sv[e];
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < kQ; ++j)
        acc += wv[j] * xs[j * kLDP + p] * bs[j * LDN + n_own];
      sv[e] = el * sv[e] + acc;
    }
  }

  // ---- backward: chunks in reverse, G = dL/dS_end ---------------------
  float gv[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int p = p_own + RS * e;
    gv[e] = (dfin != nullptr && p0 + p < P) ? dfin[(sbase + p) * N + n_own]
                                            : 0.f;
    gs[p * LDN + n_own] = gv[e];
  }
  float dA_acc = 0.f, dD_acc = 0.f, direct = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kQ;
    __syncthreads();                 // the previous chunk is read
    load_chunk(t0, true);
    {                                // the entry state, all loads first
      const float* src = stb + (size_t)c * kPB * N;
      float v[EPT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) v[e] = src[tid + e * kNT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int k = tid + e * kNT;
        s0s[(k / N) * LDN + k % N] = v[e];
      }
    }
    __syncthreads();
    chunk_decays();
    __syncthreads();

    // pairs (i, j), j <= i: w = e^{c_i - c_j}, CB = C_i.B_j, dyx =
    // dy_i.x_j; A1 = w CB, A2 = w dt_j dyx, R = A1 dyx (0 above)
#pragma unroll
    for (int k = 0; k < QQ; ++k) {
      const int j = tid % kQ, i = tid / kQ + (kNT / kQ) * k;
      float a1 = 0.f, a2 = 0.f, r = 0.f;
      if (j <= i) {
        float cb = 0.f, dyx = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) cb += cs[i * LDN + n] * bs[j * LDN + n];
#pragma unroll 8
        for (int p = 0; p < kPB; ++p)
          dyx += dys[i * kLDP + p] * xs[j * kLDP + p];
        const float w = expf(fminf(cum[i] - cum[j], 0.f));
        a1 = w * cb;
        a2 = w * dts[j] * dyx;
        r = a1 * dyx;
      }
      a1s[i * kLDQ + j] = a1;
      a2s[i * kLDQ + j] = a2;
      rs[i * kLDQ + j] = r;
    }
    // G B_j [token j][p]
    {
      const int p = tid % kPB;
      float acc[QP];
#pragma unroll
      for (int k = 0; k < QP; ++k) acc[k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float g = gs[p * LDN + n];
#pragma unroll
        for (int k = 0; k < QP; ++k)
          acc[k] += g * bs[(tid / kPB + PS * k) * LDN + n];
      }
#pragma unroll
      for (int k = 0; k < QP; ++k) gbs[(tid / kPB + PS * k) * kLDP + p] = acc[k];
    }
    // x_j^T G and dy_i^T S0 [token][n]
    {
      float ax[QN], ad[QN];
#pragma unroll
      for (int k = 0; k < QN; ++k) ax[k] = ad[k] = 0.f;
#pragma unroll 4
      for (int p = 0; p < kPB; ++p) {
        const float g = gs[p * LDN + n_own], s = s0s[p * LDN + n_own];
#pragma unroll
        for (int k = 0; k < QN; ++k) {
          const int r = p_own + RS * k;
          ax[k] += xs[r * kLDP + p] * g;
          ad[k] += dys[r * kLDP + p] * s;
        }
      }
#pragma unroll
      for (int k = 0; k < QN; ++k) {
        const int r = p_own + RS * k;
        xgs[r * LDN + n_own] = ax[k];
        dyss[r * LDN + n_own] = ad[k];
      }
    }
    // <G, S0> (block sum below) and dD's share
    {
      float gs0 = 0.f;
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        gs0 += gv[e] * s0s[(p_own + RS * e) * LDN + n_own];
      red[tid] = gs0;
      for (int k = tid; k < kQ * kPB; k += kNT)
        dD_acc += dys[(k / kPB) * kLDP + k % kPB] * xs[(k / kPB) * kLDP + k % kPB];
    }
    __syncthreads();

    // dx_j[p] = dt_j (sum_{i>=j} A1_ij dy_i[p] + e^{c_L-c_j} (G B_j)[p])
    //           + D dy_j[p]
    {
      const int p = tid % kPB;
#pragma unroll
      for (int k = 0; k < QP; ++k) {
        const int j = tid / kPB + PS * k, t = t0 + j;
        float acc = 0.f;
        for (int i = j; i < kQ; ++i) acc += a1s[i * kLDQ + j] * dys[i * kLDP + p];
        const float v = dts[j] * (acc + eend[j] * gbs[j * kLDP + p]) +
                        d_h * dys[j * kLDP + p];
        if (t < S && p0 + p < P)
          dx[((size_t)b * S + t) * xstride + (size_t)h * P + p0 + p] =
              from_f32<T>(v);
      }
    }
    // this unit's dC_i[n] = e^{c_i} (dy_i^T S0)[n] + sum_{j<=i} A2_ij B_j[n]
    // and dB_j[n] = sum_{i>=j} A2_ij C_i[n] + e^{c_L-c_j} dt_j (x_j^T G)[n]
#pragma unroll
    for (int k = 0; k < QN; ++k) {
      const int r = p_own + RS * k, t = t0 + r;
      float acc_c = ein[r] * dyss[r * LDN + n_own];
      for (int j = 0; j <= r; ++j) acc_c += a2s[r * kLDQ + j] * bs[j * LDN + n_own];
      float acc_b = eend[r] * dts[r] * xgs[r * LDN + n_own];
      for (int i = r; i < kQ; ++i) acc_b += a2s[i * kLDQ + r] * cs[i * LDN + n_own];
      if (t < S) {
        const size_t o = (((size_t)b * S + t) * U + u) * N + n_own;
        pdC[o] = acc_c;
        pdB[o] = acc_b;
      }
    }
    // token i: F_i = e^{c_L-c_i} x_i.(G B_i); the direct dt term
    // sum_{k>=i} R_ki + F_i; dc_i without the chunk-end terms
    if (tid < kQ) {
      const int i = tid;
      float xgb = 0.f, off = 0.f, col = 0.f, colm = 0.f, row = 0.f;
#pragma unroll 8
      for (int p = 0; p < kPB; ++p) xgb += xs[i * kLDP + p] * gbs[i * kLDP + p];
#pragma unroll 8
      for (int n = 0; n < N; ++n) off += dyss[i * LDN + n] * cs[i * LDN + n];
      for (int k = i + 1; k < kQ; ++k) colm += rs[k * kLDQ + i];
      for (int j = 0; j < i; ++j) row += dts[j] * rs[i * kLDQ + j];
      col = rs[i * kLDQ + i] + colm;
      const float f = eend[i] * xgb;
      direct = col + f;
      wv[i] = dts[i] * f;
      dc[i] = ein[i] * off + row - dts[i] * colm - dts[i] * f;
    } else if (tid == kQ) {
      float s = 0.f;
      for (int k = 0; k < kNT; ++k) s += red[k];
      scal[0] = s;
    }
    // G = e^{c_L} G + sum_i e^{c_i} dy_i^T C_i (the shared copy is not
    // read again in this chunk)
    {
      const float el = ein[kQ - 1];
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int p = p_own + RS * e;
        float acc = 0.f;
#pragma unroll 8
        for (int i = 0; i < kQ; ++i)
          acc += ein[i] * dys[i * kLDP + p] * cs[i * LDN + n_own];
        gv[e] = el * gv[e] + acc;
        gs[p * LDN + n_own] = gv[e];
      }
    }
    __syncthreads();

    // dl_i = sum_{k>=i} dc_k + the chunk end's e^{c_L} <G, S0> + sum_j
    // dt_j F_j (c_L's gradient, in every dl of the chunk)
    if (tid < kQ) {
      const int i = tid;
      float e_sum = 0.f;
      for (int j = 0; j < kQ; ++j) e_sum += wv[j];
      float dl = ein[kQ - 1] * scal[0] + e_sum;
      for (int k = kQ - 1; k >= i; --k) dl += dc[k];
      const int t = t0 + i;
      if (t < S) pddt[((size_t)b * S + t) * U + u] = direct + a_h * dl;
      dA_acc += dts[i] * dl;
    }
  }

  if (ds0 != nullptr) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int p = p_own + RS * e;
      if (p0 + p < P) ds0[(sbase + p) * N + n_own] = gv[e];
    }
  }
  __syncthreads();
  red[tid] = dD_acc;
  if (tid < kQ) dc[tid] = dA_acc;
  __syncthreads();
  if (tid == 0) {
    float sa = 0.f, sd = 0.f;
    for (int k = 0; k < kQ; ++k) sa += dc[k];
    for (int k = 0; k < kNT; ++k) sd += red[k];
    pdA[(size_t)b * U + u] = sa;
    pdD[(size_t)b * U + u] = sd;
  }
}

// the second launch: the per-unit partials summed in unit order (heads,
// then P-slices; dA and dD also over the batch): dB, dC in T, ddt, dA,
// dD in f32
template <typename T>
__global__ void mamba_scan_bwd_reduce(
    const float* __restrict__ pdB, const float* __restrict__ pdC,
    const float* __restrict__ pddt, const float* __restrict__ pdA,
    const float* __restrict__ pdD, T* __restrict__ dB, T* __restrict__ dC,
    float* __restrict__ ddt, float* __restrict__ dA, float* __restrict__ dD,
    int Bt, int S, int H, int np, int N) {
  const int U = H * np;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nbc = (long long)Bt * S * N, ndt = (long long)Bt * S * H;
  if (i < nbc) {
    const long long row = i / N, n = i % N;
    const float* pb = pdB + row * U * N + n;
    const float* pc = pdC + row * U * N + n;
    float sb = 0.f, sc = 0.f;
    for (int v = 0; v < U; ++v) {
      sb += pb[(size_t)v * N];
      sc += pc[(size_t)v * N];
    }
    dB[i] = from_f32<T>(sb);
    dC[i] = from_f32<T>(sc);
  } else if (i < nbc + ndt) {
    const long long k = i - nbc, row = k / H, hh = k % H;
    float s = 0.f;
    for (int q = 0; q < np; ++q) s += pddt[row * U + hh * np + q];
    ddt[k] = s;
  } else if (i < nbc + ndt + H) {
    const int hh = (int)(i - nbc - ndt);
    float sa = 0.f, sd = 0.f;
    for (int bb = 0; bb < Bt; ++bb)
      for (int q = 0; q < np; ++q) {
        sa += pdA[(size_t)bb * U + hh * np + q];
        sd += pdD[(size_t)bb * U + hh * np + q];
      }
    dA[hh] = sa;
    dD[hh] = sd;
  }
}

// scratch of one call, in floats: the entry states, then the partials
// of dB, dC, ddt, dA and dD
struct Workspace {
  size_t st, pdB, pdC, pddt, pdA, pdD, total;
  Workspace(int Bt, int S, int H, int P, int N) {
    const size_t np = (P + kPB - 1) / kPB, U = (size_t)H * np;
    const size_t nc = (S + kQ - 1) / kQ;
    st = 0;
    pdB = st + (size_t)Bt * U * nc * kPB * N;
    pdC = pdB + (size_t)Bt * S * U * N;
    pddt = pdC + (size_t)Bt * S * U * N;
    pdA = pddt + (size_t)Bt * S * U;
    pdD = pdA + (size_t)Bt * U;
    total = pdD + (size_t)Bt * U;
  }
};

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, const void* s0, const void* dy,
           const void* dfin, void* dx, void* ds0, void* dB, void* dC,
           void* ddt, void* dA, void* dD, void* ws, int Bt, int S, int H,
           int P, cudaStream_t stream) {
  using L = BwdPlan<N>;
  const Workspace w(Bt, S, H, P, N);
  float* f = static_cast<float*>(ws);
  auto* kern = mamba_scan_bwd_kernel<T, N>;
  if (L::bytes > 48 * 1024) {          // above the default cap: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int np = (P + kPB - 1) / kPB;
  BWD_LAUNCH(kern, dim3(np, H, Bt), dim3(kNT), L::bytes, stream,
             (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
             (const T*)C, (const float*)D, (const float*)s0, (const T*)dy,
             (const float*)dfin, (T*)dx, (float*)ds0, f + w.st, f + w.pdB,
             f + w.pdC, f + w.pddt, f + w.pdA, f + w.pdD, S, H, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_out = (long long)Bt * S * (N + H) + H;
  auto* red = mamba_scan_bwd_reduce<T>;
  BWD_LAUNCH(red, dim3((unsigned)((n_out + 255) / 256)), dim3(256), 0,
             stream, f + w.pdB, f + w.pdC, f + w.pddt, f + w.pdA, f + w.pdD,
             (T*)dB, (T*)dC, (float*)ddt, (float*)dA, (float*)dD, Bt, S, H,
             np, N);
  return (int)cudaGetLastError();
}

#if REPRO_WARPS   // (0 on the CPU without -DREPRO_HOST_WARPS)
#define REPRO_BWD_TC 1
// ---- the bf16 body: chunk-parallel on the tensor cores -----------------
using bf16 = __nv_bfloat16;

constexpr int kTQ = 64;     // tokens a chunk
constexpr int kTP = 64;     // rows of P (padded)
constexpr int kHG = 8;      // heads a gradient block
constexpr int kRT = kTQ / 16;          // 16-row tiles of a chunk (and of P)
// warps a block: a warp takes a row tile and a group of columns
constexpr int kWW = 8, kWT = 32 * kWW, kWCG = kWW / kRT;     // the walk
constexpr int kGW = 16, kGT = 32 * kGW, kGCG = kGW / kRT;    // gradients
constexpr int kTLDQ = kTQ + 8, kTLDP = kTP + 8;   // padded bf16 rows
static_assert(kTQ == 64 && kTP == kTQ, "two tokens a lane; square tiles");

// A 16 x 16 fragment at (m0, k0) of A stored row-major (A[m ld + k]) or,
// with T, transposed (A[k ld + m])
template <bool T>
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* A, int ld,
                                       int m0, int k0, int lane) {
  if (T)
    ldsm_x4_trans(a, A + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 +
                         ((lane >> 3) & 1) * 8);
  else
    ldsm_x4(a, A + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
// B fragments of two 8-wide n tiles from n0 over 16 k from k0, B stored
// k-major (B[k ld + n]) or, with NK, n-major (B[n ld + k])
template <bool NK>
__device__ __forceinline__ void frag_b(uint32_t* b, const bf16* B, int ld,
                                       int k0, int n0, int lane) {
  if (NK)
    ldsm_x4(b, B + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                   ((lane >> 3) & 1) * 8);
  else
    ldsm_x4_trans(b, B + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                         n0 + (lane >> 4) * 8);
}

// acc (NT 8-wide tiles of the 16 rows from m0, from column n0) += A B
// over the 16-k steps ks0 .. ks1-1. An operand made in f32 is a bf16 hi +
// lo pair, its lo part `alo` (`blo`) elements after the hi one: AP (BP)
// = 2 makes two products of it
template <int NT, bool AT, bool BNK, int AP, int BP>
__device__ __forceinline__ void mma_tiles(float (*acc)[4], const bf16* A,
                                          int lda, int alo, int m0,
                                          const bf16* B, int ldb, int blo,
                                          int n0, int ks0, int ks1,
                                          int lane) {
  static_assert(NT % 2 == 0 && AP * BP <= 2, "pairs of tiles; one pair");
  for (int s = ks0; s < ks1; ++s) {
    uint32_t a[AP][4];
#pragma unroll
    for (int u = 0; u < AP; ++u)
      frag_a<AT>(a[u], A + u * alo, lda, m0, 16 * s, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
      for (int v = 0; v < BP; ++v) {
        uint32_t b[4];
        frag_b<BNK>(b, B + v * blo, ldb, 16 * s, n0 + 16 * np, lane);
#pragma unroll
        for (int u = 0; u < AP; ++u) {
          Mma<bf16>::run(acc[2 * np], a[u], b[0], b[1]);
          Mma<bf16>::run(acc[2 * np + 1], a[u], b[2], b[3]);
        }
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_tiles(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ROWS rows of COLS elements from global row row0 on (row stride
// `stride`) into dst (row stride LD); rows at or past nrows and columns
// at or past ncols are zero, by NT threads. vec: 16-byte cp.async (ncols % 8 == 0, the
// rows 16-byte aligned); else element copies
template <int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int row0, int nrows,
                                           size_t stride, int ncols,
                                           bool vec, int tid) {
  if (vec) {
    constexpr int CPR = COLS / 8;
    for (int k = tid; k < ROWS * CPR; k += NT) {
      const int r = k / CPR, c = (k % CPR) * 8;
      const bool ok = row0 + r < nrows && c < ncols;
      cp_async16(dst + r * LD + c,
                 src + (ok ? (size_t)(row0 + r) * stride + c : 0), ok);
    }
  } else {
    for (int k = tid; k < ROWS * COLS; k += NT) {
      const int r = k / COLS, c = k % COLS;
      dst[r * LD + c] = (row0 + r < nrows && c < ncols)
                            ? src[(size_t)(row0 + r) * stride + c]
                            : __float2bfloat16(0.f);
    }
  }
}

// c_i, the inclusive prefix sum of dt a over a chunk, for tokens 2 lane
// and 2 lane + 1 (c0, c1), and c_L (one warp, shuffles)
__device__ __forceinline__ void chunk_cum(const float* dts, float a,
                                          int lane, float& c0, float& c1,
                                          float& cl) {
  const float v0 = dts[2 * lane] * a, v1 = dts[2 * lane + 1] * a;
  const float own = v0 + v1;
  float incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  c0 = (incl - own) + v0;
  c1 = incl;
  cl = __shfl_sync(0xffffffffu, incl, 31);
}

// shared memory of the walk: two stages of v [kTQ][kTLDP] and W
// [kTQ][LDN] (bf16), v w as hi + lo [2][kTQ][kTLDP], then f32: the
// stages' dt [2][kTQ] and each warp's weights [kWW][kTQ]
template <int N>
struct WalkPlan {
  static constexpr int LDN = N + 8;
  static constexpr int kStage = kTQ * kTLDP + kTQ * LDN;
  static constexpr size_t bytes =
      sizeof(bf16) * (2 * kStage + 2 * kTQ * kTLDP) +
      sizeof(float) * (2 * kTQ + kWW * kTQ);
};

// n tiles of the [.][N] products a warp: the two column groups split N
// (at N = 16 the second group has none)
template <int N, int CG>
struct TilesN {
  static constexpr int v = N / 8 / CG < 2 ? 2 : N / 8 / CG;
};

template <int N>
__global__ void __launch_bounds__(kWT, 2) mamba_scan_bwd_walk(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
    const float* __restrict__ s0, const float* __restrict__ dfin,
    float* __restrict__ ds0, float* __restrict__ st, float* __restrict__ gt,
    int S, int H, int P, int vec, int vecbc) {
  using L = WalkPlan<N>;
  constexpr int LDN = L::LDN, NTN = TilesN<N, kWCG>::v;
  BWD_SMEM(smem_raw);
  bf16* stg = reinterpret_cast<bf16*>(smem_raw);   // [2][kStage]
  bf16* vw = stg + 2 * L::kStage;                  // hi, lo [kTQ][kTLDP]
  float* dts = reinterpret_cast<float*>(vw + 2 * kTQ * kTLDP);   // [2][kTQ]
  float* wts = dts + 2 * kTQ;                                   // [kWW][kTQ]

  const int h = blockIdx.x, b = blockIdx.y, adj = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rt = warp % kRT, n0 = (warp / kRT) * NTN * 8;
  const bool act = n0 < N;
  const float a_h = A[h];
  const int nc = (S + kTQ - 1) / kTQ;
  const size_t xstride = (size_t)H * P;
  const bf16* vb = (adj ? dy : x) + (size_t)b * S * xstride + (size_t)h * P;
  const bf16* wb = (adj ? Cm : Bm) + (size_t)b * S * N;
  const float* dtb = dt + (size_t)b * S * H + h;
  float* out = (adj ? gt : st) + ((size_t)b * H + h) * nc * kTP * N;
  const float* init = adj ? dfin : s0;
  const size_t sb = ((size_t)b * H + h) * P;   // row 0 of [Bt,H,P,N]

  // the state (adjoint): rows rt 16 + g8 (+ 8), columns n0 + 8 j + 2 t4
  float m[NTN][4];
#pragma unroll
  for (int j = 0; j < NTN; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int p = rt * 16 + g8 + 8 * hi, n = n0 + 8 * j + 2 * t4;
      float2 v = make_float2(0.f, 0.f);
      if (init != nullptr && act && p < P)
        v = *reinterpret_cast<const float2*>(init + (sb + p) * N + n);
      m[j][2 * hi] = v.x;
      m[j][2 * hi + 1] = v.y;
    }
  auto load = [&](int c, int sidx) {
    bf16* vs = stg + sidx * L::kStage;
    stage_rows<kTQ, kTP, kTLDP, kWT>(vs, vb, c * kTQ, S, xstride, P, vec, tid);
    stage_rows<kTQ, N, LDN, kWT>(vs + kTQ * kTLDP, wb, c * kTQ, S, N, N, vecbc,
                            tid);
    if (tid < kTQ) {
      const bool ok = c * kTQ + tid < S;
      cp_async4(dts + sidx * kTQ + tid,
                dtb + (ok ? (size_t)(c * kTQ + tid) * H : 0), ok);
    }
  };

  load(adj ? nc - 1 : 0, 0);
  cp_async_commit();
  for (int k = 0; k < nc; ++k) {
    const int c = adj ? nc - 1 - k : k, sidx = k & 1;
    cp_async_wait<0>();
    __syncthreads();     // chunk c staged; the previous product read
    if (k + 1 < nc) load(adj ? c - 1 : c + 1, sidx ^ 1);
    cp_async_commit();
    const bf16* vs = stg + sidx * L::kStage;
    const bf16* ws = vs + kTQ * kTLDP;
    const float* dtc = dts + sidx * kTQ;
    // each warp's own weights w (no block barrier)
    float c0, c1, cl;
    chunk_cum(dtc, a_h, lane, c0, c1, cl);
    float* ww = wts + warp * kTQ;
    if (adj) {
      ww[2 * lane] = expf(c0);
      ww[2 * lane + 1] = expf(c1);
    } else {
      ww[2 * lane] = expf(fminf(cl - c0, 0.f)) * dtc[2 * lane];
      ww[2 * lane + 1] = expf(fminf(cl - c1, 0.f)) * dtc[2 * lane + 1];
    }
    __syncwarp();
    // the value at this chunk's entry (walk) or end (adjoint) out
    if (act) {
      float* o = out + (size_t)c * kTP * N;
#pragma unroll
      for (int j = 0; j < NTN; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
          *reinterpret_cast<float2*>(
              o + (rt * 16 + g8 + 8 * hi) * N + n0 + 8 * j + 2 * t4) =
              make_float2(m[j][2 * hi], m[j][2 * hi + 1]);
    }
    // v w as hi + lo, rows warp, warp + kWW, ...
    for (int r = warp; r < kTQ; r += kWW) {
      const float w = ww[r];
      const float2 v = ld_bf2(vs + r * kTLDP + 2 * lane);
      split_hi_lo<bf16>(v.x * w, v.y * w,
                        *reinterpret_cast<uint32_t*>(vw + r * kTLDP + 2 * lane),
                        *reinterpret_cast<uint32_t*>(vw + kTQ * kTLDP +
                                                     r * kTLDP + 2 * lane));
    }
    __syncthreads();     // v w written
    const float decay = expf(cl);
#pragma unroll
    for (int j = 0; j < NTN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[j][e] *= decay;
    // += (v w)^T W: A = (v w)^T [p][token] read transposed, W k-major
    if (act)
      mma_tiles<NTN, true, false, 2, 1>(m, vw, kTLDP, kTQ * kTLDP, rt * 16, ws,
                                        LDN, 0, n0, 0, kRT, lane);
  }
  if (adj && ds0 != nullptr && act) {
#pragma unroll
    for (int j = 0; j < NTN; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int p = rt * 16 + g8 + 8 * hi;
        if (p < P)
          *reinterpret_cast<float2*>(ds0 + (sb + p) * N + n0 + 8 * j +
                                     2 * t4) =
              make_float2(m[j][2 * hi], m[j][2 * hi + 1]);
      }
  }
}

// shared memory of a gradient block. bf16: B, C [kTQ][LDN]; x, dy
// [kTQ][kTLDP]; S0 and G as hi + lo [2][kTP][LDN] each; A1 (at the end
// the group's A2) as hi + lo [2][kTQ][kTLDQ]. f32: the off-diagonal sums
// of dB and dC [kTQ][LDN] each; dt of the group's heads [kHG][kTQ]; c,
// e^c, e^{c_L-c} and the diagonal R_ii [kTQ] each; partial sums of R's
// strict columns [kRT][kTQ], of dt_j R_ij's strict rows, of the off term
// and of x.(G B) [kGCG][kTQ] each; per-warp sums of <G, S0> (two heads'
// in turn) and of dD's share [3][kGW]
template <int N>
struct GradPlan {
  static constexpr int LDN = N + 8;
  static constexpr int bs = 0, cs = bs + kTQ * LDN, xs = cs + kTQ * LDN;
  static constexpr int dys = xs + kTQ * kTLDP, s0s = dys + kTQ * kTLDP;
  static constexpr int gs = s0s + 2 * kTP * LDN, a1s = gs + 2 * kTP * LDN;
  static constexpr int n_bf16 = a1s + 2 * kTQ * kTLDQ;
  static constexpr int dbo = 0, dco = dbo + kTQ * LDN, dtg = dco + kTQ * LDN;
  static constexpr int cum = dtg + kHG * kTQ, ein = cum + kTQ;
  static constexpr int eend = ein + kTQ, diag = eend + kTQ;
  static constexpr int colp = diag + kTQ, rowp = colp + kRT * kTQ;
  static constexpr int offp = rowp + kGCG * kTQ, fp = offp + kGCG * kTQ;
  static constexpr int red = fp + kGCG * kTQ;
  static constexpr int n_f32 = red + 3 * kGW;
  static_assert(n_bf16 % 8 == 0, "f32 part 16-byte aligned");
  static constexpr size_t bytes =
      sizeof(bf16) * n_bf16 + sizeof(float) * n_f32;
};

template <int N>
__global__ void __launch_bounds__(kGT, 1) mamba_scan_bwd_grads(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ D,
    const bf16* __restrict__ dy, const float* __restrict__ st,
    const float* __restrict__ gt, bf16* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ pdB,
    float* __restrict__ pdC, float* __restrict__ pdA,
    float* __restrict__ pdD, int S, int H, int P, int vec, int vecbc) {
  using L = GradPlan<N>;
  constexpr int LDN = L::LDN;
  constexpr int NTN = TilesN<N, kGCG>::v;      // [.][N] tiles a warp
  constexpr int NTP = kTP / 8 / kGCG;     // [.][P] tiles a warp
  constexpr int NTQ = kTQ / 8 / kGCG;     // pair tiles a warp
  constexpr int NKN = N / 16;            // 16-k steps over N
  BWD_SMEM(smem_raw);
  bf16* sb16 = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = sb16 + L::bs;
  bf16* cs = sb16 + L::cs;
  bf16* xs = sb16 + L::xs;
  bf16* dys = sb16 + L::dys;
  bf16* s0s = sb16 + L::s0s;
  bf16* gs = sb16 + L::gs;
  bf16* a1s = sb16 + L::a1s;
  float* sf = reinterpret_cast<float*>(sb16 + L::n_bf16);
  float* dbo = sf + L::dbo;
  float* dco = sf + L::dco;
  float* dtg = sf + L::dtg;
  float* cum = sf + L::cum;
  float* ein = sf + L::ein;
  float* eend = sf + L::eend;
  float* diag = sf + L::diag;
  float* colp = sf + L::colp;
  float* rowp = sf + L::rowp;
  float* offp = sf + L::offp;
  float* fp = sf + L::fp;
  float* red = sf + L::red;

  const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int NG = gridDim.x, nc = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rt = warp % kRT, cg = warp / kRT;
  const int n0 = cg * NTN * 8;            // this warp's [.][N] columns
  const bool nact = n0 < N;
  const int p0 = cg * NTP * 8;            // its [.][P] columns
  const int j0 = cg * NTQ * 8;            // its pair columns
  const int i0 = rt * 16 + g8;            // its rows i0 and i0 + 8
  const int t0 = c * kTQ, h0 = g * kHG, nh = H - h0 < kHG ? H - h0 : kHG;
  const size_t xstride = (size_t)H * P;

  stage_rows<kTQ, N, LDN, kGT>(bs, Bm + (size_t)b * S * N, t0, S, N, N, vecbc,
                          tid);
  stage_rows<kTQ, N, LDN, kGT>(cs, Cm + (size_t)b * S * N, t0, S, N, N, vecbc,
                          tid);
  cp_async_commit();
  for (int k = tid; k < kHG * kTQ; k += kGT) {
    const int hh = k / kTQ, i = k % kTQ;
    dtg[k] = hh < nh && t0 + i < S ? dt[((size_t)b * S + t0 + i) * H + h0 + hh]
                                   : 0.f;
  }
  for (int k = tid; k < kTQ * LDN; k += kGT) dbo[k] = dco[k] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // C B^T on this warp's pair tiles, once for the group (tiles wholly
  // above the diagonal are never read: their weight is 0)
  float cb[NTQ][4];
  zero_tiles<NTQ>(cb);
  if (j0 <= rt * 16 + 15)
    mma_tiles<NTQ, false, true, 1, 1>(cb, cs, LDN, 0, rt * 16, bs, LDN, 0,
                                      j0, 0, NKN, lane);
  float a2s[NTQ][4];                      // the group's sum of A2
  zero_tiles<NTQ>(a2s);

  // the operands of head h0 + k: x and dy by cp.async; S0_c and G_c
  // (f32) as bf16 hi + lo, and this thread's share of <G, S0> into red
  // (two heads' sums in turn: the previous head's is still read)
  auto stage_xdy = [&](int k) {
    const size_t o = (size_t)b * S * xstride + (size_t)(h0 + k) * P;
    stage_rows<kTQ, kTP, kTLDP, kGT>(xs, x + o, t0, S, xstride, P, vec, tid);
    stage_rows<kTQ, kTP, kTLDP, kGT>(dys, dy + o, t0, S, xstride, P, vec, tid);
  };
  auto stage_states = [&](int k) {
    const size_t off = (((size_t)b * H + h0 + k) * nc + c) * kTP * N;
    const float4* sp = reinterpret_cast<const float4*>(st + off);
    const float4* gp = reinterpret_cast<const float4*>(gt + off);
    constexpr int NF4 = kTP * N / 4, F4 = (NF4 + kGT - 1) / kGT;
    float4 vs[F4], vg[F4];
#pragma unroll
    for (int i = 0; i < F4; ++i) {       // every load before a store
      const int k4 = tid + i * kGT;
      vs[i] = k4 < NF4 ? sp[k4] : make_float4(0.f, 0.f, 0.f, 0.f);
      vg[i] = k4 < NF4 ? gp[k4] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float gs0 = 0.f;
#pragma unroll
    for (int i = 0; i < F4; ++i) {
      const int k4 = tid + i * kGT;
      if (k4 >= NF4) break;
      const int o = (k4 / (N / 4)) * LDN + (k4 % (N / 4)) * 4;
      gs0 += vs[i].x * vg[i].x + vs[i].y * vg[i].y + vs[i].z * vg[i].z +
             vs[i].w * vg[i].w;
      uint32_t* sh = reinterpret_cast<uint32_t*>(s0s + o);
      uint32_t* sl = reinterpret_cast<uint32_t*>(s0s + kTP * LDN + o);
      uint32_t* gh = reinterpret_cast<uint32_t*>(gs + o);
      uint32_t* gl = reinterpret_cast<uint32_t*>(gs + kTP * LDN + o);
      split_hi_lo<bf16>(vs[i].x, vs[i].y, sh[0], sl[0]);
      split_hi_lo<bf16>(vs[i].z, vs[i].w, sh[1], sl[1]);
      split_hi_lo<bf16>(vg[i].x, vg[i].y, gh[0], gl[0]);
      split_hi_lo<bf16>(vg[i].z, vg[i].w, gh[1], gl[1]);
    }
    gs0 = warp_sum(gs0);
    if (lane == 0) red[(k & 1) * kGW + warp] = gs0;
  };
  stage_xdy(0);
  cp_async_commit();
  stage_states(0);

  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k;
    const float a_h = A[h];
    const float* dth = dtg + k * kTQ;
    if (warp == 0) {   // c_i, e^{c_i}, e^{c_L - c_i}
      float c0, c1, cl;
      chunk_cum(dth, a_h, lane, c0, c1, cl);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      ein[2 * lane] = expf(c0);
      ein[2 * lane + 1] = expf(c1);
      eend[2 * lane] = expf(fminf(cl - c0, 0.f));
      eend[2 * lane + 1] = expf(fminf(cl - c1, 0.f));
    }
    cp_async_wait<0>();
    __syncthreads();     // B1: this head's operands staged

    // dy S0 [i][n] over P: e^{c_i} dy_i S0 into dC's sum; the off term
    // sum_n e^{c_i} (dy_i S0)_n C_in, this warp's columns
    {
      float acc[NTN][4], op[2] = {0.f, 0.f};
      zero_tiles<NTN>(acc);
      if (nact) {
        mma_tiles<NTN, false, false, 1, 2>(acc, dys, kTLDP, 0, rt * 16, s0s,
                                           LDN, kTP * LDN, n0, 0, kRT, lane);
#pragma unroll
        for (int j = 0; j < NTN; ++j)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int i = i0 + 8 * hi, n = n0 + 8 * j + 2 * t4;
            const float e = ein[i];
            const float v0 = acc[j][2 * hi] * e, v1 = acc[j][2 * hi + 1] * e;
            float2* o = reinterpret_cast<float2*>(dco + i * LDN + n);
            const float2 ov = *o;
            *o = make_float2(ov.x + v0, ov.y + v1);
            const float2 cf = ld_bf2(cs + i * LDN + n);
            op[hi] += v0 * cf.x + v1 * cf.y;
          }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        op[hi] += __shfl_xor_sync(0xffffffffu, op[hi], 1);
        op[hi] += __shfl_xor_sync(0xffffffffu, op[hi], 2);
      }
      if (t4 == 0) {
        offp[cg * kTQ + i0] = op[0];
        offp[cg * kTQ + i0 + 8] = op[1];
      }
    }
    // x G [j][n] over P: e^{c_L-c_j} dt_j x_j G into dB's sum
    if (nact) {
      float acc[NTN][4];
      zero_tiles<NTN>(acc);
      mma_tiles<NTN, false, false, 1, 2>(acc, xs, kTLDP, 0, rt * 16, gs, LDN,
                                         kTP * LDN, n0, 0, kRT, lane);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int j = i0 + 8 * hi;
        const float w = eend[j] * dth[j];
#pragma unroll
        for (int jt = 0; jt < NTN; ++jt) {
          float2* o = reinterpret_cast<float2*>(dbo + j * LDN + n0 + 8 * jt +
                                                2 * t4);
          const float2 ov = *o;
          *o = make_float2(ov.x + w * acc[jt][2 * hi],
                           ov.y + w * acc[jt][2 * hi + 1]);
        }
      }
    }
    // G B_j [j][p] over N (kept for dx); x_j.(G B_j), this warp's columns
    float gb[NTP][4];
    zero_tiles<NTP>(gb);
    mma_tiles<NTP, false, true, 1, 2>(gb, bs, LDN, 0, rt * 16, gs, LDN,
                                      kTP * LDN, p0, 0, NKN, lane);
    {
      float fv[2] = {0.f, 0.f};
#pragma unroll
      for (int jt = 0; jt < NTP; ++jt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const float2 xf =
              ld_bf2(xs + (i0 + 8 * hi) * kTLDP + p0 + 8 * jt + 2 * t4);
          fv[hi] += xf.x * gb[jt][2 * hi] + xf.y * gb[jt][2 * hi + 1];
        }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        fv[hi] += __shfl_xor_sync(0xffffffffu, fv[hi], 1);
        fv[hi] += __shfl_xor_sync(0xffffffffu, fv[hi], 2);
      }
      if (t4 == 0) {
        fp[cg * kTQ + i0] = fv[0];
        fp[cg * kTQ + i0 + 8] = fv[1];
      }
    }
    // the pairs: dy_i.x_j; w = e^{c_i-c_j} (j <= i), A1 = w CB -> shared
    // memory as hi + lo, A2 = w dt_j dyx into the group's sum, R = A1 dyx
    // as strict column sums, dt_j R_ij as strict row sums, R_ii
    {
      float ra[NTQ][4];
      zero_tiles<NTQ>(ra);
      if (j0 <= rt * 16 + 15)
        mma_tiles<NTQ, false, true, 1, 1>(ra, dys, kTLDP, 0, rt * 16, xs,
                                          kTLDP, 0, j0, 0, kRT, lane);
      const float ci[2] = {cum[i0], cum[i0 + 8]};
      float rowv[2] = {0.f, 0.f};
#pragma unroll
      for (int jt = 0; jt < NTQ; ++jt) {
        float colv[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = e >> 1, i = i0 + 8 * hi;
          const int j = j0 + 8 * jt + 2 * t4 + (e & 1);
          const float w = j <= i ? expf(fminf(ci[hi] - cum[j], 0.f)) : 0.f;
          const float a1 = w * cb[jt][e];
          const float r = a1 * ra[jt][e];
          a2s[jt][e] += w * dth[j] * ra[jt][e];
          ra[jt][e] = a1;
          if (j < i) {
            colv[e & 1] += r;
            rowv[hi] += r * dth[j];
          } else if (j == i) {
            diag[i] = r;
          }
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int o = (i0 + 8 * hi) * kTLDQ + j0 + 8 * jt + 2 * t4;
          split_hi_lo<bf16>(ra[jt][2 * hi], ra[jt][2 * hi + 1],
                            *reinterpret_cast<uint32_t*>(a1s + o),
                            *reinterpret_cast<uint32_t*>(a1s + kTQ * kTLDQ + o));
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float v = colv[q];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g8 == 0) colp[rt * kTQ + j0 + 8 * jt + 2 * t4 + q] = v;
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        rowv[hi] += __shfl_xor_sync(0xffffffffu, rowv[hi], 1);
        rowv[hi] += __shfl_xor_sync(0xffffffffu, rowv[hi], 2);
      }
      if (t4 == 0) {
        rowp[cg * kTQ + i0] = rowv[0];
        rowp[cg * kTQ + i0 + 8] = rowv[1];
      }
    }
    __syncthreads();     // B2: A1 and the partial sums written

    // dx_j = dt_j (sum_{i>=j} A1_ij dy_i + e^{c_L-c_j} G B_j) + D dy_j;
    // dD's share
    {
      float acc[NTP][4];
      zero_tiles<NTP>(acc);
      mma_tiles<NTP, true, false, 2, 1>(acc, a1s, kTLDQ, kTQ * kTLDQ, rt * 16,
                                        dys, kTLDP, 0, p0, rt, kRT, lane);
      const float d_h = D[h];
      float ddp = 0.f;
#pragma unroll
      for (int jt = 0; jt < NTP; ++jt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int j = i0 + 8 * hi, p = p0 + 8 * jt + 2 * t4, t = t0 + j;
          const float2 dv = ld_bf2(dys + j * kTLDP + p);
          const float2 xv = ld_bf2(xs + j * kTLDP + p);
          const float ee = eend[j], dj = dth[j];
          const float v0 = dj * (acc[jt][2 * hi] + ee * gb[jt][2 * hi]) +
                           d_h * dv.x;
          const float v1 = dj * (acc[jt][2 * hi + 1] +
                                 ee * gb[jt][2 * hi + 1]) + d_h * dv.y;
          ddp += dv.x * xv.x + dv.y * xv.y;
          if (t < S && p < P) {
            bf16* o = dx + ((size_t)b * S + t) * xstride + (size_t)h * P + p;
            if (vec) {
              *reinterpret_cast<uint32_t*>(o) = Mma<bf16>::pack(v0, v1);
            } else {
              o[0] = __float2bfloat16(v0);
              if (p + 1 < P) o[1] = __float2bfloat16(v1);
            }
          }
        }
      ddp = warp_sum(ddp);
      if (lane == 0) red[2 * kGW + warp] = ddp;
    }
    __syncthreads();     // B3: every warp's dx and dD share done
    if (k + 1 < nh) stage_xdy(k + 1);
    cp_async_commit();
    if (warp == 0) {
      // tokens i = 2 lane + u: F_i = e^{c_L-c_i} x_i.(G B_i), the direct
      // dt term, dc_i without the chunk-end terms
      float dcv[2], dirv[2], dtv[2], dtf[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 2 * lane + u;
        float fs = 0.f, rs = 0.f, os = 0.f, cs_ = 0.f;
#pragma unroll
        for (int q = 0; q < kGCG; ++q) {
          fs += fp[q * kTQ + i];
          rs += rowp[q * kTQ + i];
          os += offp[q * kTQ + i];
        }
#pragma unroll
        for (int q = 0; q < kRT; ++q) cs_ += colp[q * kTQ + i];
        const float f = eend[i] * fs;
        dtv[u] = dth[i];
        dirv[u] = cs_ + diag[i] + f;
        dtf[u] = dtv[u] * f;
        dcv[u] = os + rs - dtv[u] * cs_ - dtf[u];
      }
      // dl_i = sum_{k>=i} dc_k + the chunk end's e^{c_L} <G, S0> +
      // sum_j dt_j F_j (c_L's gradient, in every dl of the chunk): the
      // suffix sums of the lanes' pairs by shuffles
      float gsum = 0.f;
#pragma unroll
      for (int w = 0; w < kGW; ++w) gsum += red[(k & 1) * kGW + w];
      const float base =
          expf(cum[kTQ - 1]) * gsum + warp_sum(dtf[0] + dtf[1]);
      float incl = dcv[0] + dcv[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += v;
      }
      float above = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) above = 0.f;
      const float dl[2] = {base + above + dcv[1] + dcv[0],
                           base + above + dcv[1]};
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (t0 + 2 * lane + u < S)
          ddt[((size_t)b * S + t0 + 2 * lane + u) * H + h] =
              dirv[u] + a_h * dl[u];
      const float da = warp_sum(dtv[0] * dl[0] + dtv[1] * dl[1]);
      if (lane == 0) {
        float sd = 0.f;
#pragma unroll
        for (int w = 0; w < kGW; ++w) sd += red[2 * kGW + w];
        pdA[((size_t)b * nc + c) * H + h] = da;
        pdD[((size_t)b * nc + c) * H + h] = sd;
      }
    }
    if (k + 1 < nh) stage_states(k + 1);   // S0 and G were read by B2
  }

  // the group's A2 -> shared memory as hi + lo, then dC_i = (off sum) +
  // sum_{j<=i} A2_ij B_j and dB_j = (off sum) + sum_{i>=j} A2_ij C_i
#pragma unroll
  for (int jt = 0; jt < NTQ; ++jt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int o = (i0 + 8 * hi) * kTLDQ + j0 + 8 * jt + 2 * t4;
      split_hi_lo<bf16>(a2s[jt][2 * hi], a2s[jt][2 * hi + 1],
                        *reinterpret_cast<uint32_t*>(a1s + o),
                        *reinterpret_cast<uint32_t*>(a1s + kTQ * kTLDQ + o));
    }
  __syncthreads();
  if (nact) {
    for (int side = 0; side < 2; ++side) {   // 0: dC, 1: dB
      float acc[NTN][4];
      zero_tiles<NTN>(acc);
      if (side == 0)
        mma_tiles<NTN, false, false, 2, 1>(acc, a1s, kTLDQ, kTQ * kTLDQ,
                                           rt * 16, bs, LDN, 0, n0, 0,
                                           rt + 1, lane);
      else
        mma_tiles<NTN, true, false, 2, 1>(acc, a1s, kTLDQ, kTQ * kTLDQ,
                                          rt * 16, cs, LDN, 0, n0, rt, kRT,
                                          lane);
      const float* so = side == 0 ? dco : dbo;
      float* pd = side == 0 ? pdC : pdB;
#pragma unroll
      for (int j = 0; j < NTN; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int i = i0 + 8 * hi, n = n0 + 8 * j + 2 * t4, t = t0 + i;
          if (t < S) {
            const float2 ov = *reinterpret_cast<const float2*>(so + i * LDN + n);
            *reinterpret_cast<float2*>(
                pd + (((size_t)b * S + t) * NG + g) * N + n) =
                make_float2(ov.x + acc[j][2 * hi], ov.y + acc[j][2 * hi + 1]);
          }
        }
    }
  }
}

// the partials summed in a fixed order: dB, dC over the head groups (in
// bf16), dA, dD over batches and chunks
__global__ void mamba_scan_bwd_tc_reduce(
    const float* __restrict__ pdB, const float* __restrict__ pdC,
    const float* __restrict__ pdA, const float* __restrict__ pdD,
    bf16* __restrict__ dB, bf16* __restrict__ dC, float* __restrict__ dA,
    float* __restrict__ dD, int Bt, int S, int H, int NG, int N, int nc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nbc = (long long)Bt * S * N;
  if (i < nbc) {
    const long long row = i / N, n = i % N;
    float sb = 0.f, sc = 0.f;
    for (int q = 0; q < NG; ++q) {
      sb += pdB[(row * NG + q) * N + n];
      sc += pdC[(row * NG + q) * N + n];
    }
    dB[i] = __float2bfloat16(sb);
    dC[i] = __float2bfloat16(sc);
  } else if (i < nbc + H) {
    const int hh = (int)(i - nbc);
    float sa = 0.f, sd = 0.f;
    for (int k = 0; k < Bt * nc; ++k) {
      sa += pdA[(size_t)k * H + hh];
      sd += pdD[(size_t)k * H + hh];
    }
    dA[hh] = sa;
    dD[hh] = sd;
  }
}

// scratch of one call, in floats: the states entering each chunk, the
// adjoints at each chunk's end, the partials of dB, dC, dA and dD
struct TcWorkspace {
  size_t st, gt, pdB, pdC, pdA, pdD, total;
  TcWorkspace(int Bt, int S, int H, int N) {
    const size_t nc = (S + kTQ - 1) / kTQ, ng = (H + kHG - 1) / kHG;
    st = 0;
    gt = st + (size_t)Bt * H * nc * kTP * N;
    pdB = gt + (size_t)Bt * H * nc * kTP * N;
    pdC = pdB + (size_t)Bt * S * ng * N;
    pdA = pdC + (size_t)Bt * S * ng * N;
    pdD = pdA + (size_t)Bt * nc * H;
    total = pdD + (size_t)Bt * nc * H;
  }
};

template <int N>
int launch_tc(const void* x, const void* dt, const void* A, const void* B,
              const void* C, const void* D, const void* s0, const void* dy,
              const void* dfin, void* dx, void* ds0, void* dB, void* dC,
              void* ddt, void* dA, void* dD, void* ws, int Bt, int S, int H,
              int P, cudaStream_t stream) {
  const TcWorkspace w(Bt, S, H, N);
  float* f = static_cast<float*>(ws);
  const int nc = (S + kTQ - 1) / kTQ, ng = (H + kHG - 1) / kHG;
  // 16-byte rows: x and dy need whole 8-element groups of P, aligned
  const int vec = P % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)dy % 16 == 0 && (uintptr_t)dx % 16 == 0;
  const int vecbc = (uintptr_t)B % 16 == 0 && (uintptr_t)C % 16 == 0;
  auto* walk = mamba_scan_bwd_walk<N>;
  auto* grads = mamba_scan_bwd_grads<N>;
  cudaError_t err = cudaFuncSetAttribute(
      walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WalkPlan<N>::bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grads,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)GradPlan<N>::bytes);
  if (err != cudaSuccess) return (int)err;
  BWD_LAUNCH(walk, dim3(H, Bt, 2), dim3(kWT), WalkPlan<N>::bytes, stream,
             (const bf16*)x, (const bf16*)dy, (const float*)dt,
             (const float*)A, (const bf16*)B, (const bf16*)C,
             (const float*)s0, (const float*)dfin, (float*)ds0, f + w.st,
             f + w.gt, S, H, P, vec, vecbc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  BWD_LAUNCH(grads, dim3(ng, nc, Bt), dim3(kGT), GradPlan<N>::bytes, stream,
             (const bf16*)x, (const float*)dt, (const float*)A,
             (const bf16*)B, (const bf16*)C, (const float*)D,
             (const bf16*)dy, (const float*)(f + w.st),
             (const float*)(f + w.gt), (bf16*)dx, (float*)ddt, f + w.pdB,
             f + w.pdC, f + w.pdA, f + w.pdD, S, H, P, vec, vecbc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_out = (long long)Bt * S * N + H;
  BWD_LAUNCH(mamba_scan_bwd_tc_reduce, dim3((unsigned)((n_out + 255) / 256)),
             dim3(256), 0, stream, f + w.pdB, f + w.pdC, f + w.pdA,
             f + w.pdD, (bf16*)dB, (bf16*)dC, (float*)dA, (float*)dD, Bt, S,
             H, ng, N, nc);
  return (int)cudaGetLastError();
}
#endif  // the tensor-core body

// the tensor-core body takes bf16 with P <= 64 at d_state 16 and 128
bool use_tc(int P, int N, int dtype) {
#ifdef REPRO_BWD_TC
  return dtype == kBF16 && P <= kTP && (N == 16 || N == 128);
#else
  return false;
#endif
}

}  // namespace

// bytes of scratch one call needs (the caller allocates it)
extern "C" long long mamba_scan_bwd_workspace(int Bt, int S, int H, int P,
                                              int N, int dtype) {
#ifdef REPRO_BWD_TC
  if (use_tc(P, N, dtype))
    return (long long)(sizeof(float) * TcWorkspace(Bt, S, H, N).total);
#endif
  return (long long)(sizeof(float) * Workspace(Bt, S, H, P, N).total);
}

// bf16 with P <= 64: three launches (the walk, the chunk-local
// gradients, the fixed-order reduction); otherwise two (the first
// version's scan and its reduction). Bt, S, H, P >= 1.
extern "C" int mamba_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* s0, const void* dy,
    const void* dfin, void* dx, void* ds0, void* dB, void* dC, void* ddt,
    void* dA, void* dD, void* ws, int Bt, int S, int H, int P, int N,
    int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_BWD_ARGS \
  x, dt, A, B, C, D, s0, dy, dfin, dx, ds0, dB, dC, ddt, dA, dD, ws, Bt, S, \
      H, P, s
#ifdef REPRO_BWD_TC
  if (use_tc(P, N, dtype)) {
    if (N == 16) return launch_tc<16>(REPRO_BWD_ARGS);
    return launch_tc<128>(REPRO_BWD_ARGS);
  }
#endif
  if (dtype == kF32) {
    if (N == 16) return launch<float, 16>(REPRO_BWD_ARGS);
    if (N == 128) return launch<float, 128>(REPRO_BWD_ARGS);
  } else if (dtype == kBF16) {
    if (N == 16) return launch<__nv_bfloat16, 16>(REPRO_BWD_ARGS);
    if (N == 128) return launch<__nv_bfloat16, 128>(REPRO_BWD_ARGS);
  }
#undef REPRO_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
