// The FMMU packet engine's run loop for Hopper (sm_90a): the paper's
// sequential FSM (§4) as one launch.
//
// Replaces the reference's compiled `run` (repro/core/fmmu/engine.py:671,
// a lax.while_loop over `step`; it is not a Pallas kernel): arbitration
// over five weighted-round-robin queues, the two-level CMT/CTP cache with
// in-cache MSHRs, second-chance replacement among non-dirty blocks, the
// DTL next-link batch flush, low-watermark flushing and write-back
// interleaved with request service, the GTD and CondUpdate, until the
// machine is quiescent or blocked. Also flush_all's two helpers
// (mode 1: flush the oldest DTL entry; mode 2: write back one FIFO
// entry). The plain version is core/fmmu/engine.py (`step`, `run`,
// `force_flush_one`, `force_wb`), held against it bit for bit.
//
// What bounds it: latency. A step is a chain of dependent reads and
// writes of a few words of state; only a CTP page fill (flash page ->
// CTP block) and a write-back (CTP block -> flash page) move a whole
// 16 KB translation page. So the design keeps every word a step reads
// on chip and takes the serial chain off memory round trips:
//
// - Resident state. The CMT's tags, flags, next links, MSHR counts,
//   clocks and data, the CTP's tags, flags, MSHR counts and clocks, the
//   DTL, the GTD, the flush FIFO, and the rings of the queues in
//   kRingMask (CTP_REQ and HRM: the two that stall steps re-push) live
//   in shared memory for the whole launch. kernels/fmmu_fsm.py lays the
//   regions out (`_layout`) and passes their offsets and the bytes. The
//   block loads them at entry with asynchronous copies (a ring: only its
//   live slots) and writes every resident word back at exit with bulk
//   copies (a ring: the slots the run could have written), so the global
//   tensors are the state between launches. Queue pointers, credits,
//   weights, the other scalars and the stats live in registers of the
//   control warp, the same value in every lane. In global memory stay
//   the CMT and CTP MSHR rows, the CTP pages, the flash pages, the other
//   rings and the output rings.
// - One control warp (warp 0) runs the machine. Its lanes execute the
//   plain version's serial decisions together, in its order, on uniform
//   values (a write of uniform state is the same store from every lane),
//   and do the scans lane-parallel: a set's way probe (one lane a way),
//   the DTL find / oldest / flush victim (argmin and argmax that break
//   ties on the first index), the FIFO dedupe and any-DTL test by ballot,
//   second chance by two ballots rotated into clock order. A scan gives
//   each lane 4 consecutive entries: 128 DTL entries are one ballot.
//   Every queue operation names its queue at compile time (no select
//   over five queues on the path). A packet is a pointer to its ring
//   slot: nothing of a handler pushes onto its own queue but the stall,
//   done by the step after the handler returns; a head-of-line stall
//   moves the head back onto the slot it popped, unchanged, and writes
//   nothing. A packet's or MSHR row's words are written by one lane
//   each, and __syncwarp makes them visible before another lane reads.
// - Warps 1-7 only move pages, and only when a step has a move: they
//   wait on named barrier 1, copy, and arrive on named barrier 2 (before
//   their first command they prefetch into L2 the flash pages and MSHR
//   rows of the fills the queued flash responses ask for). A fill
//   is copied into the CTP block and into a staging copy in shared
//   memory, and the control warp waits for it: the MSHR replay that
//   follows (in `ctp_fill`) reads LOAD slices from the staging copy and
//   writes FLUSH_BLK data into both. A write-back is started and not
//   waited for. Its hazards: it reads CTP block wb_block and writes one
//   flash page; the control warp waits for it before writing that
//   block's page (`ctp_apply`), before any other page move (a fill may
//   read that flash page), and before the launch ends. A step with no
//   move touches no barrier of the whole block.
// - No division at the paper geometry: with every cache divisor a power
//   of two (P2, chosen on the host) Python's floor `//` and `%` are an
//   arithmetic shift and a mask; otherwise floor_div / floor_mod. The
//   FIFO's slots (257 at the paper geometry) always take floor_mod.
//
// Kept from the plain version: Python's floor `//` and `%` (a queue head
// that moves back one slot wraps to cap - 1), jnp's index rules where an
// index comes from data (a gather normalizes a negative index once and
// clamps it, a scatter drops an out-of-range write: a page programmed at
// tppn >= tppn_cap is dropped, a read of it returns page tppn_cap - 1; a
// chunk slice's start is clamped as lax.dynamic_slice clamps it), and
// ties broken on the first index, as argmax/argmin do.
//
// FSM_SERIAL builds the body for a CPU: the lane-parallel primitives as
// serial loops and the page moves done in line by the one thread
// (tools/fmmu_fsm_host_check.py runs it beside the plain version).
// FSM_RING_MASK sets other resident rings (tools/fmmu_fsm_probe.py times
// the kernel with none); the wrapper's layout must name the same.
#include "common.cuh"

namespace {

constexpr int NIL = -1;
constexpr int F_VALID = 1, F_DIRTY = 2, F_TRANS = 4, F_REF = 8;
constexpr int Q_FC_RESP = 0, Q_CTP_RESP = 1, Q_CTP_REQ = 2, Q_HRM = 3,
              Q_GCM = 4;
constexpr int WORKED = 0, IDLE = 1, BLOCKED = 2;
constexpr int LOOKUP = 0, UPDATE = 1, COND_UPDATE = 2, LOAD = 3,
              FLUSH_BLK = 4, LOAD_RESP = 5, FC_READ_RESP = 7;
constexpr int ST_OK = 0, ST_STALE = 1;
constexpr int M_LOOKUP = 0, M_UPDATE = 1, M_COND = 2, M_LOAD = 3,
              M_FLUSH = 4;
enum { S_HIT, S_MISS, S_MERGE, S_STALL, S_FTV, S_FBLK, S_FC, S_PROG,
       S_STEPS, S_CHIT, S_CMISS, S_COUNT };
constexpr int kInt32Max = 0x7fffffff;
constexpr int kInt32Min = -kInt32Max - 1;
constexpr int kMaxEntries = 32;   // CMT entries a block: a lane each
constexpr int kMaxWays = 32;      // ways a set, CMT and CTP: a lane each
constexpr int kThreads = 256;     // the control warp and 7 copy warps
constexpr int kBarGo = 1, kBarDone = 2;   // named barriers (0: syncthreads)
constexpr int OP_EXIT = 0, OP_FILL = 1, OP_WB = 2;
constexpr int kMagic = 0x46534d32;        // the Geom layout below
// the queues whose rings are resident (bit q), kernels/fmmu_fsm.py's
// RING_QUEUES; a launch with another Geom::ring_mask is refused
#ifndef FSM_RING_MASK
#define FSM_RING_MASK ((1 << Q_CTP_REQ) | (1 << Q_HRM))
#endif
constexpr int kRingMask = FSM_RING_MASK;

// shared-memory regions, in the order of kernels/fmmu_fsm.py's _REGIONS
enum Region {
  R_CMT_DATA, R_CMT_TAG, R_CMT_FLAGS, R_CMT_NEXT, R_CMT_MSHR_N, R_CMT_CLOCK,
  R_CTP_TAG, R_CTP_FLAGS, R_CTP_MSHR_N, R_CTP_CLOCK,
  R_DTL_TVPN, R_DTL_HEAD, R_DTL_NDIRTY, R_DTL_UPDATED, R_DTL_SEQ,
  R_GTD, R_SCALARS, R_RING0, R_PAGE = R_RING0 + 5, R_ROWS, R_CTL, R_FIFO,
  R_COUNT
};
// the words of R_SCALARS (kernels/fmmu_fsm.py N_SCALARS)
enum Scalar {
  K_QHEAD = 0, K_QTAIL = 5, K_CREDITS = 10, K_WEIGHTS = 15, K_CMT_DIRTY = 20,
  K_CTP_DIRTY, K_DTL_CTR, K_FIFO_HEAD, K_FIFO_TAIL, K_TPPN_NEXT, K_STALLS,
  K_RESP_N, K_RESP_HEAD, K_FC_N, K_FC_HEAD, K_PROG_N, K_PROG_HEAD, K_STATS,
  K_COUNT = K_STATS + S_COUNT
};
// the words of R_CTL: a page move's command, and each ring's written span
enum Ctl { C_OP, C_A, C_B, C_LO = 4, C_HI = 9 };

// geometry and shared-memory layout, as kernels/fmmu_fsm.py's _geom()
struct Geom {
  int cmt_sets, cmt_ways, cmt_entries, ctp_sets, ctp_ways, ept, n_tvpns,
      dtl_entries, queue_cap, mshr_cap, ctp_mshr_cap, tppn_cap, fifo_cap,
      cmt_low, ctp_low, cmt_blocks, ctp_blocks, cpt, pw;
  // log2 of each cache divisor when it is a power of two, else -1
  int lg_cmt_sets, lg_cmt_ways, lg_cmt_entries, lg_ctp_sets, lg_ctp_ways,
      lg_ept, lg_cpt, lg_queue_cap;
  int ring_mask;            // bit q: queue q's ring is resident (kRingMask)
  int smem_bytes;           // dynamic shared memory of the launch
  int off[R_COUNT];         // each region's offset in ints (-1: none)
  int magic;
};

// the 43 tensors of FMMUState, in its field order
struct State {
  int *cmt_tag, *cmt_flags, *cmt_data, *cmt_next, *cmt_mshr, *cmt_mshr_n,
      *cmt_clock, *cmt_dirty;
  int *ctp_tag, *ctp_flags, *ctp_data, *ctp_mshr, *ctp_mshr_n, *ctp_clock,
      *ctp_dirty;
  int *dtl_tvpn, *dtl_head, *dtl_ndirty, *dtl_updated, *dtl_seq, *dtl_ctr;
  int *fifo, *fifo_head, *fifo_tail;
  int *gtd, *flash_tp, *tppn_next;
  int *qbuf, *qhead, *qtail, *credits, *weights, *stalls_in_row;
  int *resp_buf, *resp_n, *resp_head, *fc_buf, *fc_n, *fc_head, *prog_buf,
      *prog_n, *prog_head;
  int* stats;
};
static_assert(sizeof(State) == 43 * sizeof(int*), "43 state tensors");

// jnp's gather index: a negative one counts from the end once, clamped
__device__ __forceinline__ int rd_idx(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}
// jnp's scatter index: false (the write is dropped) when out of range
__device__ __forceinline__ bool wr_idx(int& i, int n) {
  if (i < 0) i += n;
  return i >= 0 && i < n;
}
// lax.dynamic_slice's start of a `size` window over n
__device__ __forceinline__ int slice_start(int start, int n, int size) {
  if (start < 0) start += n;
  return start < 0 ? 0 : (start > n - size ? n - size : start);
}
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
// word i of a row (i, a, b, c, d, e): a select chain, no local array
__device__ __forceinline__ int sel(int i, int a, int b, int c = NIL,
                                   int d = NIL, int e = NIL) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : i == 3 ? d : e;
}

// five per-queue words in registers, indexed by compile-time queue ids
struct Q5 {
  int v[5];
};

#ifndef FSM_SERIAL
constexpr unsigned kFull = 0xffffffffu;
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Hopper's bulk copies (TMA): n bytes (a multiple of 16, both ends
// 16-byte aligned) from shared to global memory, and an L2 prefetch
__device__ __forceinline__ void bulk_store(int* g, const int* s, int n) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(g), "r"(sa), "r"(n) : "memory");
}
__device__ __forceinline__ void bulk_prefetch(const int* g, int n) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(g),
               "r"(n) : "memory");
}
#endif

__device__ __forceinline__ void block_sync() {
#ifndef FSM_SERIAL
  __syncthreads();
#endif
}

// n ints from global src into shared dst by threads t of nt, every
// word an asynchronous copy (16 bytes when both are 16-byte aligned);
// the caller commits and waits once for all of them
__device__ __forceinline__ void load(int* dst, const int* src, int n, int t,
                                     int nt) {
#ifdef FSM_SERIAL
  for (int i = t; i < n; i += nt) dst[i] = src[i];
#else
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    for (int i = t; i < (n >> 2); i += nt)
      cp_async16(dst + 4 * i, src + 4 * i, true);
    done = n & ~3;
  }
  for (int i = done + t; i < n; i += nt) cp_async4(dst + i, src + i, true);
#endif
}

// n ints from shared src back to global dst by threads t of nt: the
// 16-byte-aligned body as one bulk copy issued by thread `who` (waited
// for by the caller), the rest word by word
__device__ __forceinline__ void store(int* dst, const int* src, int n, int t,
                                      int nt, int who) {
  int done = 0;
#ifndef FSM_SERIAL
  if ((((reinterpret_cast<uintptr_t>(dst) |
         reinterpret_cast<uintptr_t>(src)) & 15) == 0) && n >= 4) {
    done = n & ~3;
    if (t == who % nt) bulk_store(dst, src, 4 * done);
  }
#endif
  for (int i = done + t; i < n; i += nt) dst[i] = src[i];
}

// n ints from src to dst by threads t of nt (16-byte moves when both
// are 16-byte aligned)
__device__ __forceinline__ void move(int* dst, const int* src, int n, int t,
                                     int nt) {
  int done = 0;
#ifndef FSM_SERIAL
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    int4* d = reinterpret_cast<int4*>(dst);
    const int4* s = reinterpret_cast<const int4*>(src);
    for (int i = t; i < (n >> 2); i += nt) d[i] = s[i];
    done = n & ~3;
  }
#endif
  for (int i = done + t; i < n; i += nt) dst[i] = src[i];
}

// the live or written slots [lo, hi) of one ring, between its global
// and its shared copy, as at most two runs of whole slots
__device__ __forceinline__ void ring_move(int* shared, int* global, int lo,
                                          int hi, int cap, int pw,
                                          bool in, int t, int nt) {
  const int n = hi - lo;
  if (n <= 0) return;
  if (n >= cap) {
    if (in) load(shared, global, cap * pw, t, nt);
    else store(global, shared, cap * pw, t, nt, 0);
    return;
  }
  const int s0 = floor_mod(lo, cap);
  const int n1 = imin(n, cap - s0);
  const size_t at = (size_t)s0 * pw;
  if (in) {
    load(shared + at, global + at, n1 * pw, t, nt);
    load(shared, global, (n - n1) * pw, t, nt);
  } else {
    move(global + at, shared + at, n1 * pw, t, nt);
    move(global, shared, (n - n1) * pw, t, nt);
  }
}

// a page move (OP_FILL: CTP block a <- flash page b, or the all-NIL
// never-written page when b < 0, and the staging copy; OP_WB: flash
// page b <- CTP block a) by threads t of nt
__device__ __forceinline__ void move_page(const State& S, const Geom& G,
                                          int* page, int op, int a, int b,
                                          int t, int nt) {
  int* block = S.ctp_data + (size_t)a * G.ept;
  if (op == OP_WB) {
    move(S.flash_tp + (size_t)b * G.ept, block, G.ept, t, nt);
    return;
  }
  const int* src = b < 0 ? nullptr : S.flash_tp + (size_t)b * G.ept;
  int done = 0;
#ifndef FSM_SERIAL
  if (((reinterpret_cast<uintptr_t>(block) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    int4* d = reinterpret_cast<int4*>(block);
    int4* p = reinterpret_cast<int4*>(page);
    const int4* s = reinterpret_cast<const int4*>(src);
    const int4 nil = make_int4(NIL, NIL, NIL, NIL);
    for (int i = t; i < (G.ept >> 2); i += nt) {
      const int4 v = src ? s[i] : nil;
      d[i] = v;
      p[i] = v;
    }
    done = G.ept & ~3;
  }
#endif
  for (int i = done + t; i < G.ept; i += nt) {
    const int v = src ? src[i] : NIL;
    block[i] = v;
    page[i] = v;
  }
}

template <bool P2>
struct Fsm {
  State S;
  Geom G;
  int lane, nt;
  int *sm, *cdata, *ctag, *cflags, *cnext, *cmn, *cclock, *ttag, *tflags,
      *tmn, *tclock, *dtvpn, *dhead, *dnd, *dupd, *dseq, *gtd, *page, *rows,
      *ctl, *fifo;
  // register-resident state (uniform across the warp)
  Q5 qh, qt, cr, wt, qlo;
  int cmt_dirty, ctp_dirty, dtl_ctr, fifo_head, fifo_tail, tppn_next,
      stalls, resp_n, resp_head, fc_n, fc_head, prog_n, prog_head;
  int st[S_COUNT];
  int wb_pending, wb_block;
  // kept in step with the words above, for the arbitration: bit q of
  // `ne` is qt[q] - qh[q] > 0, of `ok` cr[q] > 0, of `wok` wt[q] > 0;
  // `qlens` is the sum of the five lengths
  unsigned ne, ok, wok;
  int qlens;

  __device__ __forceinline__ Fsm(const State& s, const Geom& g, int* smem,
                                 int t, int nthreads)
      : S(s), G(g), lane(t & 31), nt(nthreads), sm(smem) {
    cdata = sm + G.off[R_CMT_DATA];
    ctag = sm + G.off[R_CMT_TAG];
    cflags = sm + G.off[R_CMT_FLAGS];
    cnext = sm + G.off[R_CMT_NEXT];
    cmn = sm + G.off[R_CMT_MSHR_N];
    cclock = sm + G.off[R_CMT_CLOCK];
    ttag = sm + G.off[R_CTP_TAG];
    tflags = sm + G.off[R_CTP_FLAGS];
    tmn = sm + G.off[R_CTP_MSHR_N];
    tclock = sm + G.off[R_CTP_CLOCK];
    dtvpn = sm + G.off[R_DTL_TVPN];
    dhead = sm + G.off[R_DTL_HEAD];
    dnd = sm + G.off[R_DTL_NDIRTY];
    dupd = sm + G.off[R_DTL_UPDATED];
    dseq = sm + G.off[R_DTL_SEQ];
    gtd = sm + G.off[R_GTD];
    page = sm + G.off[R_PAGE];
    rows = sm + G.off[R_ROWS];
    ctl = sm + G.off[R_CTL];
    fifo = sm + G.off[R_FIFO];
    const int* k = sm + G.off[R_SCALARS];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      qh.v[q] = k[K_QHEAD + q];
      qt.v[q] = k[K_QTAIL + q];
      cr.v[q] = k[K_CREDITS + q];
      wt.v[q] = k[K_WEIGHTS + q];
      qlo.v[q] = qh.v[q];
    }
    cmt_dirty = k[K_CMT_DIRTY];
    ctp_dirty = k[K_CTP_DIRTY];
    dtl_ctr = k[K_DTL_CTR];
    fifo_head = k[K_FIFO_HEAD];
    fifo_tail = k[K_FIFO_TAIL];
    tppn_next = k[K_TPPN_NEXT];
    stalls = k[K_STALLS];
    resp_n = k[K_RESP_N];
    resp_head = k[K_RESP_HEAD];
    fc_n = k[K_FC_N];
    fc_head = k[K_FC_HEAD];
    prog_n = k[K_PROG_N];
    prog_head = k[K_PROG_HEAD];
#pragma unroll
    for (int i = 0; i < S_COUNT; ++i) st[i] = k[K_STATS + i];
    wb_pending = 0;
    wb_block = -1;
    ne = ok = wok = 0;
    qlens = 0;
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      ne |= (unsigned)(qt.v[q] - qh.v[q] > 0) << q;
      ok |= (unsigned)(cr.v[q] > 0) << q;
      wok |= (unsigned)(wt.v[q] > 0) << q;
      qlens += qt.v[q] - qh.v[q];
    }
  }

  // the registers back into R_SCALARS, each ring's written slots
  // [lowest head, tail) into R_CTL (lane 0; the block syncs after)
  __device__ __forceinline__ void save() {
    if (lane != 0) return;
    int* k = sm + G.off[R_SCALARS];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      k[K_QHEAD + q] = qh.v[q];
      k[K_QTAIL + q] = qt.v[q];
      k[K_CREDITS + q] = cr.v[q];
      k[K_WEIGHTS + q] = wt.v[q];
      ctl[C_LO + q] = qlo.v[q];
      ctl[C_HI + q] = qt.v[q];
    }
    k[K_CMT_DIRTY] = cmt_dirty;
    k[K_CTP_DIRTY] = ctp_dirty;
    k[K_DTL_CTR] = dtl_ctr;
    k[K_FIFO_HEAD] = fifo_head;
    k[K_FIFO_TAIL] = fifo_tail;
    k[K_TPPN_NEXT] = tppn_next;
    k[K_STALLS] = stalls;
    k[K_RESP_N] = resp_n;
    k[K_RESP_HEAD] = resp_head;
    k[K_FC_N] = fc_n;
    k[K_FC_HEAD] = fc_head;
    k[K_PROG_N] = prog_n;
    k[K_PROG_HEAD] = prog_head;
#pragma unroll
    for (int i = 0; i < S_COUNT; ++i) k[K_STATS + i] = st[i];
  }

  __device__ __forceinline__ void bump(int i) { st[i] += 1; }

  // ---- index arithmetic: Python's floor // and % ----
  __device__ __forceinline__ int fdiv(int a, int d, int lg) const {
    if constexpr (P2) return a >> lg;
    else return floor_div(a, d);
  }
  __device__ __forceinline__ int fmod(int a, int d, int lg) const {
    if constexpr (P2) return a & (d - 1);
    else return floor_mod(a, d);
  }

  // ---- lane-parallel primitives. A scan gives each lane 4 consecutive
  // entries, so 128 entries are one ballot; per-lane work on at most 32
  // words is one predicated pass. With SYNC the warp's writes are
  // visible to all its lanes after. ----
  // body(i) for every i < n
  template <bool SYNC = true, class F>
  __device__ __forceinline__ void for_lanes(int n, F body) const {
#ifdef FSM_SERIAL
    for (int i = 0; i < n; ++i) body(i);
#else
    for (int i = lane; i < n; i += 32) body(i);
    if (SYNC) __syncwarp();
#endif
  }
  // body(i) for every i < n <= 32
  template <bool SYNC = true, class F>
  __device__ __forceinline__ void on_lanes(int n, F body) const {
#ifdef FSM_SERIAL
    for (int i = 0; i < n; ++i) body(i);
#else
    if (lane < n) body(lane);
    if (SYNC) __syncwarp();
#endif
  }
  // the first i < n <= 32 with pred(i), or -1
  template <class F>
  __device__ __forceinline__ int first_way(int n, F pred) const {
#ifdef FSM_SERIAL
    for (int i = 0; i < n; ++i)
      if (pred(i)) return i;
    return -1;
#else
    const unsigned m = __ballot_sync(kFull, lane < n && pred(lane));
    return m ? __ffs(m) - 1 : -1;
#endif
  }
  // the first i < n with pred(i), or -1
  template <class F>
  __device__ __forceinline__ int first(int n, F pred) const {
#ifdef FSM_SERIAL
    for (int i = 0; i < n; ++i)
      if (pred(i)) return i;
    return -1;
#else
    for (int base = 0; base < n; base += 128) {
      const int i0 = base + 4 * lane;
      int k = 4;              // this lane's first hit among its 4
#pragma unroll
      for (int j = 3; j >= 0; --j)
        if (i0 + j < n && pred(i0 + j)) k = j;
      const unsigned m = __ballot_sync(kFull, k < 4);
      if (m) {
        const int l = __ffs(m) - 1;
        return base + 4 * l + __shfl_sync(kFull, k, l);
      }
    }
    return -1;
#endif
  }
  // the first i < n with a(i), or -1; and in b_at the first i with b(i)
  // (-1 if none) when none has a(i)
  template <class FA, class FB>
  __device__ __forceinline__ int first2(int n, FA a, FB b, int& b_at) const {
    b_at = -1;
#ifdef FSM_SERIAL
    for (int i = 0; i < n; ++i) {
      if (a(i)) return i;
      if (b_at < 0 && b(i)) b_at = i;
    }
    return -1;
#else
    for (int base = 0; base < n; base += 128) {
      const int i0 = base + 4 * lane;
      int ka = 4, kb = 4;
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        if (i0 + j < n && a(i0 + j)) ka = j;
        if (i0 + j < n && b(i0 + j)) kb = j;
      }
      const unsigned ma = __ballot_sync(kFull, ka < 4);
      if (ma) {
        const int l = __ffs(ma) - 1;
        return base + 4 * l + __shfl_sync(kFull, ka, l);
      }
      const unsigned mb = __ballot_sync(kFull, kb < 4);
      if (b_at < 0 && mb) {
        const int l = __ffs(mb) - 1;
        b_at = base + 4 * l + __shfl_sync(kFull, kb, l);
      }
    }
    return -1;
#endif
  }
  // min / max of key(i) over i < n (kInt32Max / kInt32Min when n == 0)
  template <class F>
  __device__ __forceinline__ int wmin(int n, F key) const {
    int v = kInt32Max;
#ifdef FSM_SERIAL
    for (int i = 0; i < n; ++i) v = imin(v, key(i));
    return v;
#else
    for (int base = 4 * lane; base < n; base += 128)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (base + j < n) v = imin(v, key(base + j));
    return __reduce_min_sync(kFull, v);
#endif
  }
  template <class F>
  __device__ __forceinline__ int wmax(int n, F key) const {
    int v = kInt32Min;
#ifdef FSM_SERIAL
    for (int i = 0; i < n; ++i) v = imax(v, key(i));
    return v;
#else
    for (int base = 4 * lane; base < n; base += 128)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (base + j < n) v = imax(v, key(base + j));
    return __reduce_max_sync(kFull, v);
#endif
  }
  // the first index of the minimum of key(i) over i < n (0 when n == 0)
  template <class F>
  __device__ __forceinline__ int argmin(int n, F key) const {
#ifdef FSM_SERIAL
    int best = 0;
    for (int i = 1; i < n; ++i)
      if (key(i) < key(best)) best = i;
    return best;
#else
    int v = kInt32Max, at = kInt32Max;   // each lane's first minimum
    for (int base = 4 * lane; base < n; base += 128)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = base + j;
        if (i < n) {
          const int k = key(i);
          if (at == kInt32Max || k < v) { v = k; at = i; }
        }
      }
    const int m = __reduce_min_sync(kFull, v);
    const int idx = __reduce_min_sync(
        kFull, at != kInt32Max && v == m ? at : kInt32Max);
    return idx == kInt32Max ? 0 : idx;
#endif
  }
  static __device__ __forceinline__ int lowest_bit(unsigned m) {  // m != 0
#ifdef FSM_SERIAL
    return __builtin_ctz(m);
#else
    return __ffs(m) - 1;
#endif
  }

  // ---- page moves by the copy warps ----
  __device__ __forceinline__ void send(int op, int a, int b) {
    wait_wb();
#ifdef FSM_SERIAL
    if (op != OP_EXIT) move_page(S, G, page, op, a, b, 0, 1);
#else
    if (lane == 0) { ctl[C_OP] = op; ctl[C_A] = a; ctl[C_B] = b; }
    bar_sync(kBarGo, nt);
#endif
  }
  __device__ __forceinline__ void wait_wb() {
    if (!wb_pending) return;
#ifndef FSM_SERIAL
    bar_sync(kBarDone, nt);
#endif
    wb_pending = 0;
    wb_block = -1;
  }
  // CTP block b <- flash page src (-1: all NIL), and the staging copy
  __device__ __forceinline__ void fill_page(int b, int src) {
    send(OP_FILL, b, src);
#ifndef FSM_SERIAL
    bar_sync(kBarDone, nt);
#endif
  }
  __device__ __forceinline__ void start_wb(int b, int dst) {
    send(OP_WB, b, dst);
    wb_pending = 1;
    wb_block = b;
  }
  // the last page move lands, the copy warps leave, the registers saved
  __device__ __forceinline__ void finish() {
    send(OP_EXIT, 0, 0);
    save();
  }

  // ---- queues, each op on a queue known at compile time: a packet is
  // its slot's address ----
  template <int Q>
  __device__ __forceinline__ int* qslot(int pos) const {
    const int slot = fmod(pos, G.queue_cap, G.lg_queue_cap);
    if constexpr (((kRingMask >> Q) & 1) != 0)
      return sm + G.off[R_RING0 + Q] + slot * G.pw;
    else
      return S.qbuf + ((size_t)Q * G.queue_cap + slot) * G.pw;
  }
  // header words h0..h4, data word i from data(i)
  template <class D>
  __device__ __forceinline__ void put(int* d, int h0, int h1, int h2, int h3,
                                      int h4, D data) const {
#ifdef FSM_SERIAL
    for (int i = 0; i < 5; ++i) d[i] = sel(i, h0, h1, h2, h3, h4);
    for (int i = 0; i < G.cmt_entries; ++i) d[5 + i] = data(i);
#else
    if (lane < 5) d[lane] = sel(lane, h0, h1, h2, h3, h4);
    if (lane < G.cmt_entries) d[5 + lane] = data(lane);
    __syncwarp();
#endif
  }
  // queue Q's head or tail moved by `by` slots (the length by +-by)
  template <int Q>
  __device__ __forceinline__ void moved(int by) {
    qlens += by;
    ne = (ne & ~(1u << Q)) | ((unsigned)(qt.v[Q] - qh.v[Q] > 0) << Q);
  }
  template <int Q, class D>
  __device__ __forceinline__ void qpush(int h0, int h1, int h2, int h3,
                                        int h4, D data) {
    put(qslot<Q>(qt.v[Q]), h0, h1, h2, h3, h4, data);
    qt.v[Q] += 1;
    moved<Q>(1);
  }

  struct Pkt {
    const int* p;
    int kind, f1, f2, f3, f4;
  };
  template <int Q>
  __device__ __forceinline__ Pkt qpop() {
    const int* p = qslot<Q>(qh.v[Q]);
    qh.v[Q] += 1;
    moved<Q>(-1);
    return Pkt{p, p[0], p[1], p[2], p[3], p[4]};
  }
  // a stall: the popped packet back onto its queue's tail
  template <int Q>
  __device__ __forceinline__ void stall_back(const Pkt& P) {
    bump(S_STALL);
    stalls += 1;
    qpush<Q>(P.kind, P.f1, P.f2, P.f3, P.f4,
             [&](int i) { return P.p[5 + i]; });
  }
  // a head-of-line stall: the popped packet back at its queue's head,
  // the slot it was popped from (nothing of the handler wrote there)
  template <int Q>
  __device__ __forceinline__ void stall_front() {
    bump(S_STALL);
    stalls += 1;
    const int h = qh.v[Q] - 1;
    qh.v[Q] = h;
    qlo.v[Q] = imin(qlo.v[Q], h);
    moved<Q>(1);
  }

  // ---- outputs ----
  __device__ __forceinline__ void emit_resp(int rid, int kind, int dppn,
                                            int status) {
    int* r = S.resp_buf +
             (size_t)fmod(resp_n, G.queue_cap, G.lg_queue_cap) * 4;
    on_lanes<false>(4, [&](int i) { r[i] = sel(i, rid, kind, dppn, status); });
    resp_n += 1;
  }
  __device__ __forceinline__ void emit_fc(int tppn, int s, int w) {
    int* r = S.fc_buf + (size_t)fmod(fc_n, G.queue_cap, G.lg_queue_cap) * 3;
    on_lanes(3, [&](int i) { r[i] = sel(i, tppn, s, w); });
    fc_n += 1;
    bump(S_FC);
  }
  __device__ __forceinline__ void emit_prog(int tvpn, int tppn) {
    int* r = S.prog_buf +
             (size_t)fmod(prog_n, G.queue_cap, G.lg_queue_cap) * 2;
    on_lanes<false>(2, [&](int i) { r[i] = sel(i, tvpn, tppn); });
    prog_n += 1;
    bump(S_PROG);
  }

  // ---- second chance over a set's flags row `fl` of W ways from the
  // clock: the victim way or -1. The plain version's scan of 2W slots
  // picks the first eligible (clean, not transient) way without REF in
  // clock order, clearing the REF bits of the eligible ways it passes;
  // if every eligible way has REF, the second lap picks the first
  // eligible way with every eligible REF bit cleared. Here: a ballot of
  // the eligible ways and one of those without REF, rotated into clock
  // order (bit p: the way at position p from the clock). On a victim
  // the row is rewritten with those bits cleared and the victim
  // TRANS|REF (what the callers store). ----
  __device__ __forceinline__ int second_chance(int* fl, int clock, int W,
                                               int lgW) {
    const int c = fmod(clock, W, lgW);
    auto elig = [](int f) { return !(f & (F_DIRTY | F_TRANS)); };
#ifdef FSM_SERIAL
    unsigned e = 0, r = 0;
    for (int w = 0; w < W; ++w) {
      const int f = fl[w];
      if (elig(f)) e |= 1u << w;
      if (elig(f) && !(f & F_REF)) r |= 1u << w;
    }
#else
    const int f0 = lane < W ? fl[lane] : F_DIRTY;
    const unsigned e = __ballot_sync(kFull, elig(f0));
    const unsigned r = __ballot_sync(kFull, elig(f0) && !(f0 & F_REF));
#endif
    if (!e) return -1;
    const bool lap2 = !r;
    const unsigned long long m = lap2 ? e : r;
    const unsigned long long mm = (m | (m << W)) >> c;
    const int pv = lowest_bit((unsigned)mm);   // nonzero: a bit below W
    const int vic = fmod(c + pv, W, lgW);
    on_lanes(W, [&](int w) {
      const int f = fl[w];
      int nf = f;
      if (elig(f) && (f & F_REF) && (lap2 || fmod(w - c, W, lgW) < pv))
        nf = f & ~F_REF;
      fl[w] = w == vic ? (F_TRANS | F_REF) : nf;
    });
    return vic;
  }

  // ---- DTL ----
  __device__ __forceinline__ int dtl_find(int tvpn) const {
    return first(G.dtl_entries, [&](int i) { return dtvpn[i] == tvpn; });
  }
  __device__ __forceinline__ int dtl_oldest() const {  // argmin dtl_seq
    return argmin(G.dtl_entries, [&](int i) { return dseq[i]; });
  }
  __device__ __forceinline__ bool any_dtl() const {
    return first(G.dtl_entries, [&](int i) { return dtvpn[i] != NIL; }) >= 0;
  }
  __device__ __forceinline__ void flush_tvpn(int idx) {
    const int tvpn = dtvpn[idx];
    const int E = G.cmt_entries;
    bump(S_FTV);
    int p = dhead[idx];
    while (p != NIL) {      // block p = (p // ways) * ways + p % ways
      const int nxt = cnext[p];
      const int fl = cflags[p];
      if (fl & F_DIRTY) {
        const int chunk = fmod(ctag[p], G.cpt, G.lg_cpt);
        const int* d = cdata + p * E;
        qpush<Q_CTP_REQ>(FLUSH_BLK, tvpn, chunk, NIL, NIL,
                         [&](int i) { return d[i]; });
        cflags[p] = fl & ~F_DIRTY;
        cnext[p] = NIL;
        cmt_dirty -= 1;
        bump(S_FBLK);
      }
      p = nxt;
    }
    dtvpn[idx] = NIL;
    dhead[idx] = NIL;
    dnd[idx] = 0;
    dupd[idx] = 0;
    dseq[idx] = kInt32Max;
  }
  __device__ __forceinline__ void dtl_register(int s, int w, int tvpn) {
    const int p = s * G.cmt_ways + w;
    int slot;
    const int idx = first2(
        G.dtl_entries, [&](int i) { return dtvpn[i] == tvpn; },
        [&](int i) { return dtvpn[i] == NIL; }, slot);
    if (idx >= 0) {
      cnext[p] = dhead[idx];
      dhead[idx] = p;
      dnd[idx] += 1;
      dupd[idx] = 1;
      return;
    }
    if (slot < 0) {       // full: flush the oldest, the one free slot after
      slot = dtl_oldest();
      flush_tvpn(slot);
    }
    cnext[p] = NIL;
    dtvpn[slot] = tvpn;
    dhead[slot] = p;
    dnd[slot] = 1;
    dupd[slot] = 1;
    dseq[slot] = dtl_ctr;
    dtl_ctr += 1;
  }
  // max ndirty over valid entries (-1 for a free one), ties -> min seq
  __device__ __forceinline__ int pick_flush_victim() const {
    const int D = G.dtl_entries;
    const int best = wmax(D, [&](int i) {
      return dtvpn[i] != NIL ? dnd[i] : -1;
    });
    return argmin(D, [&](int i) {
      return dtvpn[i] != NIL && dnd[i] == best ? dseq[i] : kInt32Max;
    });
  }

  // ---- CMT ----
  __device__ __forceinline__ void cmt_apply(int s, int w, int kind, int off,
                                            int rid, int dppn, int old) {
    const int b = s * G.cmt_ways + w;
    int* cell = cdata + b * G.cmt_entries + off;
    const int cur = *cell;
    if (kind == LOOKUP) {
      emit_resp(rid, LOOKUP, cur, ST_OK);
      return;
    }
    if (kind == COND_UPDATE && cur != old) {
      emit_resp(rid, COND_UPDATE, cur, ST_STALE);
      return;
    }
    *cell = dppn;
    const int fl = cflags[b];
    if (!(fl & F_DIRTY)) {
      cflags[b] = fl | F_DIRTY;
      cmt_dirty += 1;
      dtl_register(s, w, fdiv(ctag[b], G.cpt, G.lg_cpt));
    }
    emit_resp(rid, kind, dppn, ST_OK);
  }
  __device__ __forceinline__ void targeted_cmt_flush(int s) {
    const int base = s * G.cmt_ways;
    const int w = first_way(G.cmt_ways,
                            [&](int i) { return cflags[base + i] & F_DIRTY; });
    if (w < 0) return;
    const int idx = dtl_find(fdiv(ctag[base + w], G.cpt, G.lg_cpt));
    if (idx >= 0) flush_tvpn(idx);
  }
  // a LOOKUP / UPDATE / COND_UPDATE; true: the caller stalls it (back)
  __device__ __forceinline__ bool cmt_handle(const Pkt& P) {
    const int kind = P.kind, dlpn = P.f1, dppn = P.f2, old = P.f3,
              rid = P.f4;
    const int W = G.cmt_ways;
    const int block_id = fdiv(dlpn, G.cmt_entries, G.lg_cmt_entries);
    const int s = fmod(block_id, G.cmt_sets, G.lg_cmt_sets);
    const int off = fmod(dlpn, G.cmt_entries, G.lg_cmt_entries);
    const int base = s * W;
    const int way = first_way(W, [&](int w) {
      return ctag[base + w] == block_id &&
             (cflags[base + w] & (F_VALID | F_TRANS));
    });
    const int mk = kind == LOOKUP ? M_LOOKUP
                   : kind == UPDATE ? M_UPDATE : M_COND;
    auto row_word = [&](int i) { return sel(i, mk, off, rid, dppn, old); };
    if (way >= 0) {
      const int b = base + way;
      const int fw = cflags[b];
      if (fw & F_TRANS) {
        const int n = cmn[b];
        if (n >= G.mshr_cap) return true;
        bump(S_MERGE);
        int* row = S.cmt_mshr + ((size_t)b * G.mshr_cap + n) * 5;
        on_lanes(5, [&](int i) { row[i] = row_word(i); });
        cmn[b] = n + 1;
        return false;
      }
      bump(S_HIT);
      cflags[b] = fw | F_REF;
      cmt_apply(s, way, kind, off, rid, dppn, old);
      return false;
    }
    bump(S_MISS);
    const int vic = second_chance(cflags + base, cclock[s], W, G.lg_cmt_ways);
    if (vic < 0) {
      targeted_cmt_flush(s);
      return true;
    }
    cclock[s] = (vic + 1) % W;
    const int b = base + vic;
    ctag[b] = block_id;
    cnext[b] = NIL;
    int* row = S.cmt_mshr + (size_t)b * G.mshr_cap * 5;
    on_lanes(5, [&](int i) { row[i] = row_word(i); });
    cmn[b] = 1;
    qpush<Q_CTP_REQ>(
        LOAD, fdiv(dlpn, G.ept, G.lg_ept),
        fdiv(fmod(dlpn, G.ept, G.lg_ept), G.cmt_entries, G.lg_cmt_entries), b,
        NIL, [](int) { return NIL; });
    return false;
  }
  // LOAD_RESP: fill the block, replay its MSHR rows in order
  __device__ __forceinline__ void cmt_fill(const Pkt& P) {
    const int dest = P.f3;     // block (dest // ways) * ways + dest % ways
    const int s = fdiv(dest, G.cmt_ways, G.lg_cmt_ways);
    const int w = fmod(dest, G.cmt_ways, G.lg_cmt_ways);
    const int b = dest;
    int* d = cdata + b * G.cmt_entries;
    on_lanes(G.cmt_entries, [&](int i) { d[i] = P.p[5 + i]; });
    cflags[b] = (cflags[b] & ~F_TRANS) | F_VALID;
    const int cnt = imin(cmn[b], G.mshr_cap);
    cmn[b] = 0;
    if (cnt <= 0) return;
    const int* src = S.cmt_mshr + (size_t)b * G.mshr_cap * 5;
    for_lanes(cnt * 5, [&](int i) { rows[i] = src[i]; });
    for (int r = 0; r < cnt; ++r) {
      const int* row = rows + r * 5;
      const int kind = row[0] == M_LOOKUP ? LOOKUP
                       : row[0] == M_UPDATE ? UPDATE : COND_UPDATE;
      cmt_apply(s, w, kind, row[1], row[2], row[3], row[4]);
    }
  }
  __device__ __forceinline__ bool cmt_flush_needed() const {
    return (G.cmt_blocks - cmt_dirty) < G.cmt_low && any_dtl();
  }

  // ---- CTP ----
  __device__ __forceinline__ void fifo_push(int tvpn) {
    if (first(G.fifo_cap, [&](int i) { return fifo[i] == tvpn; }) >= 0)
      return;
    fifo[floor_mod(fifo_tail, G.fifo_cap)] = tvpn;
    fifo_tail += 1;
  }
  // a LOAD or FLUSH_BLK on CTP block (s, w); `staged`: the block was
  // just filled, and the staging copy of its page is current
  __device__ __forceinline__ void ctp_apply(int s, int w, int kind, int chunk,
                                            int dest, const int* data,
                                            bool staged) {
    const int b = s * G.ctp_ways + w;
    const int E = G.cmt_entries;
    const int start = slice_start(chunk * E, G.ept, E);
    int* gpage = S.ctp_data + (size_t)b * G.ept + start;
    if (kind == LOAD) {
      const int* src = staged ? page + start : gpage;
      qpush<Q_CTP_RESP>(LOAD_RESP, ttag[b], chunk, dest, NIL,
                        [&](int i) { return src[i]; });
      return;
    }
    if (wb_block == b) wait_wb();     // its write-back reads this page
    on_lanes(E, [&](int i) {
      const int v = data[i];
      gpage[i] = v;
      if (staged) page[start + i] = v;
    });
    const int fl = tflags[b];
    if (!(fl & F_DIRTY)) {
      tflags[b] = fl | F_DIRTY;
      ctp_dirty += 1;
      fifo_push(ttag[b]);
    }
  }
  // _ctp_fill_data: the page, then the flags, then the MSHR replays
  __device__ __forceinline__ void ctp_fill(int s, int w, int src) {
    const int b = s * G.ctp_ways + w;
    const int m2w = 3 + G.cmt_entries;
    fill_page(b, src);
    tflags[b] = (tflags[b] & ~F_TRANS) | F_VALID;
    const int cnt = imin(tmn[b], G.ctp_mshr_cap);
    tmn[b] = 0;
    if (cnt <= 0) return;
    const int* row0 = S.ctp_mshr + (size_t)b * G.ctp_mshr_cap * m2w;
    for_lanes(cnt * m2w, [&](int i) { rows[i] = row0[i]; });
    for (int r = 0; r < cnt; ++r) {
      const int* row = rows + r * m2w;
      ctp_apply(s, w, row[0] == M_LOAD ? LOAD : FLUSH_BLK, row[1], row[2],
                row + 3, true);
    }
  }
  __device__ __forceinline__ void writeback_block(int s, int w) {
    const int b = s * G.ctp_ways + w;
    const int tppn = tppn_next;
    const int tvpn = ttag[b];
    int j = tppn;
    if (wr_idx(j, G.tppn_cap)) start_wb(b, j);
    int k = tvpn;
    if (wr_idx(k, G.n_tvpns)) gtd[k] = tppn;
    tppn_next += 1;
    tflags[b] &= ~F_DIRTY;
    ctp_dirty -= 1;
    emit_prog(tvpn, tppn);
  }
  __device__ __forceinline__ void targeted_ctp_writeback(int s) {
    const int base = s * G.ctp_ways;
    const int w = first_way(G.ctp_ways, [&](int i) {
      const int f = tflags[base + i];
      return (f & F_DIRTY) && (f & F_VALID);
    });
    if (w >= 0) writeback_block(s, w);
  }
  // a LOAD or FLUSH_BLK; true: the caller stalls it (front)
  __device__ __forceinline__ bool ctp_handle(const Pkt& P) {
    const int kind = P.kind, tvpn = P.f1, chunk = P.f2, dest = P.f3;
    const int W = G.ctp_ways;
    const int s = fmod(tvpn, G.ctp_sets, G.lg_ctp_sets);
    const int base = s * W;
    const int E = G.cmt_entries;
    const int way = first_way(W, [&](int w) {
      return ttag[base + w] == tvpn &&
             (tflags[base + w] & (F_VALID | F_TRANS));
    });
    const int mk = kind == LOAD ? M_LOAD : M_FLUSH;
    auto write_row = [&](int* row) {   // kind, chunk, dest, then the data
      on_lanes(imax(E, 3), [&](int i) {
        if (i < 3) row[i] = sel(i, mk, chunk, dest);
        if (i < E) row[3 + i] = P.p[5 + i];
      });
    };
    if (way >= 0) {
      const int b = base + way;
      const int fw = tflags[b];
      if (fw & F_TRANS) {
        const int n = tmn[b];
        if (n >= G.ctp_mshr_cap) return true;
        bump(S_MERGE);
        write_row(S.ctp_mshr + ((size_t)b * G.ctp_mshr_cap + n) * (3 + E));
        tmn[b] = n + 1;
        return false;
      }
      bump(S_CHIT);
      tflags[b] = fw | F_REF;
      ctp_apply(s, way, kind, chunk, dest, P.p + 5, false);
      return false;
    }
    bump(S_CMISS);
    const int vic = second_chance(tflags + base, tclock[s], W, G.lg_ctp_ways);
    if (vic < 0) {
      targeted_ctp_writeback(s);
      return true;
    }
    tclock[s] = (vic + 1) % W;
    const int b = base + vic;
    ttag[b] = tvpn;
    write_row(S.ctp_mshr + (size_t)b * G.ctp_mshr_cap * (3 + E));
    tmn[b] = 1;
    const int tppn = gtd[rd_idx(tvpn, G.n_tvpns)];
    if (tppn == NIL) ctp_fill(s, vic, -1);
    else emit_fc(tppn, s, vic);
    return false;
  }
  __device__ __forceinline__ void fc_handle(const Pkt& P) {
    ctp_fill(P.f2, P.f3, rd_idx(P.f1, G.tppn_cap));
  }
  __device__ __forceinline__ bool ctp_writeback_needed() const {
    return (G.ctp_blocks - ctp_dirty) < G.ctp_low && fifo_tail > fifo_head;
  }
  __device__ __forceinline__ bool ctp_writeback_one() {
    while (fifo_tail > fifo_head) {
      const int pos = floor_mod(fifo_head, G.fifo_cap);
      const int tvpn = fifo[pos];
      fifo_head += 1;
      fifo[pos] = NIL;
      const int s = fmod(tvpn, G.ctp_sets, G.lg_ctp_sets);
      const int base = s * G.ctp_ways;
      const int w = first_way(G.ctp_ways, [&](int i) {
        const int f = tflags[base + i];
        return ttag[base + i] == tvpn && (f & F_VALID) && (f & F_DIRTY);
      });
      if (w >= 0) {
        writeback_block(s, w);
        return true;
      }
    }
    return false;
  }

  // ---- arbitration + step ----
  // weighted round robin on the masks: all credits reload when no
  // nonempty queue has one; the lowest ready queue is picked and pays a
  // credit
  __device__ __forceinline__ int arbitrate(bool& picked) {
    if (ne && !(ne & ok)) {
      cr = wt;
      ok = wok;
    }
    const unsigned m = ne & ok;
    picked = m != 0;
    if (!picked) return 0;
    const int qid = lowest_bit(m);
    ok = 0;
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      cr.v[q] -= qid == q ? 1 : 0;
      ok |= (unsigned)(cr.v[q] > 0) << q;
    }
    return qid;
  }
  __device__ __forceinline__ int step() {
    bump(S_STEPS);
    if (ctp_writeback_needed() && ctp_writeback_one()) return WORKED;
    if (cmt_flush_needed()) {
      flush_tvpn(pick_flush_victim());
      return WORKED;
    }
    bool picked;
    const int qid = arbitrate(picked);
    if (!picked) return IDLE;
    if (stalls > qlens + 4) {
      stalls = 0;
      return BLOCKED;
    }
    const int before = stalls;
    if (qid == Q_FC_RESP) {
      fc_handle(qpop<Q_FC_RESP>());
    } else if (qid == Q_CTP_RESP) {
      cmt_fill(qpop<Q_CTP_RESP>());
    } else if (qid == Q_CTP_REQ) {
      if (ctp_handle(qpop<Q_CTP_REQ>())) stall_front<Q_CTP_REQ>();
    } else {                          // Q_HRM, Q_GCM: one cmt_handle
      const Pkt P = qid == Q_HRM ? qpop<Q_HRM>() : qpop<Q_GCM>();
      if (cmt_handle(P)) {
        if (qid == Q_HRM) stall_back<Q_HRM>(P);
        else stall_back<Q_GCM>(P);
      }
    }
    if (stalls == before) stalls = 0;
    return WORKED;
  }
  // auto_flash: every pending flash read answered at once, in order
  __device__ __forceinline__ void deliver_fc() {
    const int cnt = fc_n - fc_head;
    if (cnt > 0) {
      // past cap entries, a later one overwrites an earlier one's slot
      const int skip = imax(cnt - G.queue_cap, 0);
      const int t0 = qt.v[Q_FC_RESP];
      const int pw = G.pw;
      for_lanes((cnt - skip) * pw, [&](int k) {
        const int e = skip + k / pw, word = k % pw;
        const int* r =
            S.fc_buf +
            (size_t)fmod(fc_head + e, G.queue_cap, G.lg_queue_cap) * 3;
        qslot<Q_FC_RESP>(t0 + e)[word] =
            word == 0 ? FC_READ_RESP : word < 4 ? r[word - 1] : NIL;
      });
      qt.v[Q_FC_RESP] = t0 + cnt;
      moved<Q_FC_RESP>(cnt);
    }
    fc_head = fc_n;
  }
  // mode 0: up to max_steps steps, the count returned
  __device__ __forceinline__ int run(int max_steps, int auto_flash) {
    int n = 0;
    for (;;) {
      const bool worked = step() == WORKED;
      n += 1;
      bool cont = worked;
      if (auto_flash) {
        const bool can = !worked && fc_n > fc_head;
        if (can) deliver_fc();
        cont = worked || can;
      }
      if (!cont || n >= max_steps) return n;
    }
  }
};

// ---- the resident set, between global and shared memory ----
__device__ __forceinline__ int* scalar_ptr(const State& S, int i) {
  if (i < K_QTAIL) return S.qhead + i;
  if (i < K_CREDITS) return S.qtail + i - K_QTAIL;
  if (i < K_WEIGHTS) return S.credits + i - K_CREDITS;
  if (i < K_CMT_DIRTY) return S.weights + i - K_WEIGHTS;
  if (i >= K_STATS) return S.stats + i - K_STATS;
  switch (i) {
    case K_CMT_DIRTY: return S.cmt_dirty;
    case K_CTP_DIRTY: return S.ctp_dirty;
    case K_DTL_CTR: return S.dtl_ctr;
    case K_FIFO_HEAD: return S.fifo_head;
    case K_FIFO_TAIL: return S.fifo_tail;
    case K_TPPN_NEXT: return S.tppn_next;
    case K_STALLS: return S.stalls_in_row;
    case K_RESP_N: return S.resp_n;
    case K_RESP_HEAD: return S.resp_head;
    case K_FC_N: return S.fc_n;
    case K_FC_HEAD: return S.fc_head;
    case K_PROG_N: return S.prog_n;
    default: return S.prog_head;
  }
}

// in: global -> shared at entry (asynchronous copies, all landed on
// return); else shared -> global at exit
__device__ __forceinline__ void move_state(const State& S, const Geom& G,
                                           int* sm, bool in, int t, int nt) {
  const int cb = G.cmt_blocks, tb = G.ctp_blocks, D = G.dtl_entries;
  auto run = [&](int region, int* g, int n) {
    int* s = sm + G.off[region];
    if (in) load(s, g, n, t, nt);
    else store(g, s, n, t, nt, 32 * region);   // a warp's lane 0 each
  };
  run(R_CMT_DATA, S.cmt_data, cb * G.cmt_entries);
  run(R_CMT_TAG, S.cmt_tag, cb);
  run(R_CMT_FLAGS, S.cmt_flags, cb);
  run(R_CMT_NEXT, S.cmt_next, cb);
  run(R_CMT_MSHR_N, S.cmt_mshr_n, cb);
  run(R_CMT_CLOCK, S.cmt_clock, G.cmt_sets);
  run(R_CTP_TAG, S.ctp_tag, tb);
  run(R_CTP_FLAGS, S.ctp_flags, tb);
  run(R_CTP_MSHR_N, S.ctp_mshr_n, tb);
  run(R_CTP_CLOCK, S.ctp_clock, G.ctp_sets);
  run(R_DTL_TVPN, S.dtl_tvpn, D);
  run(R_DTL_HEAD, S.dtl_head, D);
  run(R_DTL_NDIRTY, S.dtl_ndirty, D);
  run(R_DTL_UPDATED, S.dtl_updated, D);
  run(R_DTL_SEQ, S.dtl_seq, D);
  run(R_GTD, S.gtd, G.n_tvpns);
  run(R_FIFO, S.fifo, G.fifo_cap);
  int* k = sm + G.off[R_SCALARS];
  for (int i = t; i < K_COUNT; i += nt) {
    if (in) k[i] = *scalar_ptr(S, i);
    else *scalar_ptr(S, i) = k[i];
  }
  const int* ctl = sm + G.off[R_CTL];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    if (!((kRingMask >> q) & 1)) continue;
    int* global = S.qbuf + (size_t)q * G.queue_cap * G.pw;
    const int lo = in ? S.qhead[q] : ctl[C_LO + q];
    const int hi = in ? S.qtail[q] : ctl[C_HI + q];
    ring_move(sm + G.off[R_RING0 + q], global, lo, hi, G.queue_cap, G.pw, in,
              t, nt);
  }
#ifndef FSM_SERIAL
  if (in) {
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
#endif
}

// mode 0: run up to max_steps steps (out[0] = steps taken); 1: flush the
// oldest DTL entry; 2: write back one FIFO entry (out[0] = done).
// Thread t of nt: warp 0 runs the machine, the others move pages.
template <bool P2>
__device__ __forceinline__ void fsm_body(const State& S, const Geom& G,
                                         int* sm, int mode, int max_steps,
                                         int auto_flash, int* out, int t,
                                         int nt) {
  if (mode == 0 && max_steps <= 0) {
    if (t == 0) out[0] = 0;
    return;
  }
  move_state(S, G, sm, true, t, nt);
  block_sync();
  if (t < 32) {
    Fsm<P2> m(S, G, sm, t, nt);
    int res = 0;
    if (mode == 0) res = m.run(max_steps, auto_flash);
    else if (mode == 1) {
      if (m.any_dtl()) m.flush_tvpn(m.dtl_oldest());
    } else {
      res = m.ctp_writeback_one() ? 1 : 0;
    }
    m.finish();
    if (t == 0 && mode != 1) out[0] = res;
  } else {
#ifndef FSM_SERIAL
    const int* ctl = sm + G.off[R_CTL];
    int* page = sm + G.off[R_PAGE];
    // until the first command: the flash pages and CTP MSHR rows of the
    // fills the queued flash responses ask for, into L2 (a hint: the
    // addresses are clamped as the fill clamps them)
    if (mode == 0) {
      const int m2w = 3 + G.cmt_entries;
      for (int e = S.qhead[Q_FC_RESP] + t - 32; e < S.qtail[Q_FC_RESP];
           e += nt - 32) {
        const int* pkt =
            S.qbuf + ((size_t)Q_FC_RESP * G.queue_cap +
                      floor_mod(e, G.queue_cap)) * G.pw;
        const int b = pkt[2] * G.ctp_ways + pkt[3];
        if ((G.ept & 3) == 0)
          bulk_prefetch(
              S.flash_tp + (size_t)rd_idx(pkt[1], G.tppn_cap) * G.ept,
              4 * G.ept);
        if (b >= 0 && b < G.ctp_blocks && ((G.ctp_mshr_cap * m2w) & 3) == 0)
          bulk_prefetch(S.ctp_mshr + (size_t)b * G.ctp_mshr_cap * m2w,
                        4 * G.ctp_mshr_cap * m2w);
      }
    }
    for (;;) {
      bar_sync(kBarGo, nt);
      const int op = ctl[C_OP];
      if (op == OP_EXIT) break;
      move_page(S, G, page, op, ctl[C_A], ctl[C_B], t - 32, nt - 32);
      bar_arrive(kBarDone, nt);
    }
#endif
  }
#ifndef FSM_SERIAL
  // the exit's bulk copies (async proxy) read what this thread wrote
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
  block_sync();
  move_state(S, G, sm, false, t, nt);
}

#ifndef FSM_SERIAL
template <bool P2>
__global__ void __launch_bounds__(kThreads, 1) fmmu_fsm_kernel(
    State S, Geom G, int mode, int max_steps, int auto_flash, int* out) {
  extern __shared__ int4 smem4[];
  fsm_body<P2>(S, G, reinterpret_cast<int*>(smem4), mode, max_steps,
               auto_flash, out, threadIdx.x, blockDim.x);
}
#endif

bool geom_ok(const Geom& G, int mode) {
  return G.magic == kMagic && G.ring_mask == kRingMask &&
         G.cmt_entries <= kMaxEntries &&
         G.cmt_ways <= kMaxWays && G.ctp_ways <= kMaxWays && mode >= 0 &&
         mode <= 2;
}
bool pow2_geom(const Geom& G) {
  return G.lg_cmt_sets >= 0 && G.lg_cmt_ways >= 0 && G.lg_cmt_entries >= 0 &&
         G.lg_ctp_sets >= 0 && G.lg_ctp_ways >= 0 && G.lg_ept >= 0 &&
         G.lg_cpt >= 0 && G.lg_queue_cap >= 0;
}

}  // namespace

#ifndef FSM_SERIAL
// state: 43 device pointers in FMMUState's field order; geom: the ints of
// Geom (kernels/fmmu_fsm.py _geom); out: one device int32
extern "C" int fmmu_fsm_launch(const void* const* state, const int* geom,
                               int mode, int max_steps, int auto_flash,
                               void* out, void* stream) {
  State S;
  Geom G;
  memcpy(&S, state, sizeof(State));
  memcpy(&G, geom, sizeof(Geom));
  if (!geom_ok(G, mode)) return (int)cudaErrorInvalidValue;
  const bool p2 = pow2_geom(G);
  void (*kernel)(State, Geom, int, int, int, int*) =
      p2 ? fmmu_fsm_kernel<true> : fmmu_fsm_kernel<false>;
  // the opt-in above the default 48 KB, once per device and body
  static int granted[64][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (G.smem_bytes > granted[dev][p2]) {
    err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, G.smem_bytes);
    if (err != cudaSuccess) return (int)err;
    granted[dev][p2] = G.smem_bytes;
  }
  kernel<<<1, kThreads, G.smem_bytes, (cudaStream_t)stream>>>(
      S, G, mode, max_steps, auto_flash, (int*)out);
  return (int)cudaGetLastError();
}
#else
// the same on host memory, by one thread: the CPU check build
extern "C" int fmmu_fsm_serial(const void* const* state, const int* geom,
                               int mode, int max_steps, int auto_flash,
                               void* out, void* smem) {
  State S;
  Geom G;
  memcpy(&S, state, sizeof(State));
  memcpy(&G, geom, sizeof(Geom));
  if (!geom_ok(G, mode)) return 1;
  if (pow2_geom(G))
    fsm_body<true>(S, G, (int*)smem, mode, max_steps, auto_flash, (int*)out,
                   0, 1);
  else
    fsm_body<false>(S, G, (int*)smem, mode, max_steps, auto_flash, (int*)out,
                    0, 1);
  return 0;
}
#endif
