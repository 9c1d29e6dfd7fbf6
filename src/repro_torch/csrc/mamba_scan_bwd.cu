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
// `mamba_chunk_scan_bwd_blocked` (kernels/ref.py). In a chunk of kQ
// tokens with c_i the inclusive cumulative sum of dt A and S0 the state
// entering it:
//   y_i   = e^{c_i} C_i S0^T + sum_{j<=i} e^{c_i-c_j} dt_j (C_i.B_j) x_j
//           + D x_i,
//   S_end = e^{c_L} S0 + sum_j e^{c_L-c_j} dt_j x_j B_j^T.
//
// What bounds it: it moves x, dy, dx, B, C, dB, dC, dt and ddt once
// (~214 MB at mamba2-1.3b's training shape, Bt=8 S=1024 H=64 P=64
// N=128 bf16: ~0.064 ms at 3.35 TB/s) and does ~10 Bt S H P N flops
// (~43 GFLOP), so bytes bound it on the tensor cores. This first version
// runs its products in f32 on the CUDA cores: the plan below, simple
// and right, not yet the chunked form on the tensor cores.
//
// The plan: one block of kNT threads per (batch, head, kPB rows of P)
// walks the sequence twice.
// - Forward, chunk by chunk: the state [kPB, N] in f32 registers (kPB N
//   / kNT values a thread), its value entering each chunk written to a
//   scratch of the block's own ([Bt, H*np, n_chunks, kPB, N] f32), then
//   S = e^{c_L} S + sum_j e^{c_L-c_j} dt_j x_j B_j^T.
// - Backward, chunk by chunk in reverse, carrying G = dL/dS_end in f32
//   registers and a copy in shared memory (dfinal at the end). A chunk
//   stages x, dy, B, C (as f32), dt and its entry state in shared
//   memory, then forms its Q x Q pair weights (e^{c_i-c_j} for j <= i;
//   above the diagonal the weight is 0 and no exponential is taken),
//   G B_j, x_j^T G and dy_i^T S0, and from them dx, dB, dC, the direct
//   dt term and the gradient of each c_i; the reverse cumulative sum of
//   that gradient is the log-decays' dl: ddt += A dl, dA += dt dl. Then
//   G = e^{c_L} G + sum_i e^{c_i} dy_i^T C_i; after the first chunk G is
//   dinitial_state.
// B and C are one group shared by all H heads, and dA, dD sum over the
// batch and the sequence, so a block writes per-(head, P-slice) partials
// of dB, dC ([Bt, S, H*np, N] f32), ddt, dA and dD, and a second launch
// sums them in a fixed order: the result is bit-identical on repeat (no
// float atomics). Rows past S load as x = dy = B = C = 0 and dt = 0
// (decay 1, no input) and are not stored; rows past P load as zero.
// Every phase ends at a block barrier and uses no warp primitive, so
// the body also runs on the CPU with one thread per CUDA thread
// (-DREPRO_HOST_EMULATION, tools/mamba_scan_bwd_host_check.py).
// Built for d_state 16 and 128 (the forward's) and f32 / bf16 inputs.
#include "common.cuh"

#ifdef REPRO_HOST_EMULATION
#define BWD_LAUNCH(kern, grid, block, smem, stream, ...) \
  repro_host_launch(grid, block, smem, [=] { kern(__VA_ARGS__); })
#else
#define BWD_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#define BWD_LAUNCH(kern, grid, block, smem, stream, ...) \
  kern<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

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

}  // namespace

// bytes of scratch one call needs (the caller allocates it)
extern "C" long long mamba_scan_bwd_workspace(int Bt, int S, int H, int P,
                                              int N) {
  return (long long)(sizeof(float) * Workspace(Bt, S, H, P, N).total);
}

// Two launches: the scan (one block per batch, head and 64 rows of P)
// and the fixed-order reduction of its partials. Bt, S, H, P >= 1.
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
