// The fmmu_fsm kernel's first version (one thread walks the state in
// global memory; 256 threads move the pages between two block-wide
// barriers a step), kept unchanged as the baseline that
// chip_smoke.check_fmmu_fsm and tools/fmmu_fsm_probe.py time the kernel
// of src/repro_torch/csrc/fmmu_fsm.cu against. Nothing of the package
// builds or loads it. It reads the first 19 ints of the geometry
// kernels/fmmu_fsm.py passes and takes the same C entry point; built
// with -I src/repro_torch/csrc.
//
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
// writes of a few words of state (a queue head, a set's tags and
// flags, a DTL scan), a few hundred bytes; only a CTP page fill
// (flash page -> CTP block) and a write-back (CTP block -> flash page)
// move a whole 16 KB translation page. A loop of steps driven from the
// host would pay a host sync at every branch; here the loop never
// leaves the card, and the host reads the step count once per call.
//
// Design: one block; the state stays in global memory (its tensors are
// updated in place, 256 MB of flash pages at the paper geometry).
// Thread 0 runs the serial machine, mirroring the plain version helper
// by helper. The whole block does the wide moves between barriers: a
// fill is decided by thread 0, copied by every thread, and then thread
// 0 replays the block's MSHRs over the filled page (the rest of
// `_ctp_fill_data`); a write-back's page copy runs after the step, as
// nothing in the same step reads the page it writes. Python's floor `//`
// and `%` are kept (a queue head that moves back one slot wraps to
// cap - 1), and so are jnp's index rules where an index comes from
// data: a gather normalizes a negative index once and clamps it, a
// scatter drops an out-of-range write (a page programmed at tppn >=
// tppn_cap is dropped; a read of it returns page tppn_cap - 1), and a
// chunk slice's start is clamped as lax.dynamic_slice clamps it.
// Ties break on the first index, as argmax/argmin do.
#include "common.cuh"

namespace {

constexpr int NIL = -1;
constexpr int F_VALID = 1, F_DIRTY = 2, F_TRANS = 4, F_REF = 8;
constexpr int Q_FC_RESP = 0, Q_CTP_RESP = 1, Q_CTP_REQ = 2;
constexpr int WORKED = 0, IDLE = 1, BLOCKED = 2;
constexpr int LOOKUP = 0, UPDATE = 1, COND_UPDATE = 2, LOAD = 3,
              FLUSH_BLK = 4, LOAD_RESP = 5, FC_READ_RESP = 7;
constexpr int ST_OK = 0, ST_STALE = 1;
constexpr int M_LOOKUP = 0, M_UPDATE = 1, M_COND = 2, M_LOAD = 3,
              M_FLUSH = 4;
enum { S_HIT, S_MISS, S_MERGE, S_STALL, S_FTV, S_FBLK, S_FC, S_PROG,
       S_STEPS, S_CHIT, S_CMISS };
constexpr int kInt32Max = 0x7fffffff;
constexpr int kMaxEntries = 32;   // CMT entries a block (host checks)
constexpr int kMaxWays = 32;      // ways a set, CMT and CTP (host checks)
constexpr int kThreads = 256;

// geometry, in the order of kernels/fmmu_fsm.py's _geom()
struct Geom {
  int cmt_sets, cmt_ways, cmt_entries, ctp_sets, ctp_ways, ept, n_tvpns,
      dtl_entries, queue_cap, mshr_cap, ctp_mshr_cap, tppn_cap, fifo_cap,
      cmt_low, ctp_low, cmt_blocks, ctp_blocks, cpt, pw;
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

// a step's wide moves, decided by thread 0 and done by the block
struct Wide {
  int fill, fs, fw, fsrc;  // fill CTP block (fs, fw) from flash page fsrc
                           // (-1: the never-written all-NIL page)
  int wb, ws, ww, wdst;    // copy CTP block (ws, ww) to flash page wdst
};

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

struct Fsm {
  State S;
  Geom G;
  Wide W;

  __device__ void bump(int i) { S.stats[i] += 1; }

  // ---- queues ----
  __device__ int* qslot(int q, int pos) {
    return S.qbuf + ((size_t)q * G.queue_cap + floor_mod(pos, G.queue_cap)) *
                        G.pw;
  }
  __device__ void qpush(int q, const int* pkt) {
    int* d = qslot(q, S.qtail[q]);
    for (int i = 0; i < G.pw; ++i) d[i] = pkt[i];
    S.qtail[q] += 1;
  }
  __device__ void qpush_front(int q, const int* pkt) {
    int* d = qslot(q, S.qhead[q] - 1);
    for (int i = 0; i < G.pw; ++i) d[i] = pkt[i];
    S.qhead[q] -= 1;
  }
  __device__ void qpop(int q, int* pkt) {
    const int* s = qslot(q, S.qhead[q]);
    for (int i = 0; i < G.pw; ++i) pkt[i] = s[i];
    S.qhead[q] += 1;
  }
  __device__ void mkpkt(int* p, int kind, int f1, int f2, int f3, int f4,
                        const int* data) {
    p[0] = kind; p[1] = f1; p[2] = f2; p[3] = f3; p[4] = f4;
    for (int i = 0; i < G.cmt_entries; ++i) p[5 + i] = data ? data[i] : NIL;
  }

  // ---- outputs ----
  __device__ void emit_resp(int rid, int kind, int dppn, int status) {
    int* r = S.resp_buf + (size_t)floor_mod(*S.resp_n, G.queue_cap) * 4;
    r[0] = rid; r[1] = kind; r[2] = dppn; r[3] = status;
    *S.resp_n += 1;
  }
  __device__ void emit_fc(int tppn, int s, int w) {
    int* r = S.fc_buf + (size_t)floor_mod(*S.fc_n, G.queue_cap) * 3;
    r[0] = tppn; r[1] = s; r[2] = w;
    *S.fc_n += 1;
    bump(S_FC);
  }
  __device__ void emit_prog(int tvpn, int tppn) {
    int* r = S.prog_buf + (size_t)floor_mod(*S.prog_n, G.queue_cap) * 2;
    r[0] = tvpn; r[1] = tppn;
    *S.prog_n += 1;
    bump(S_PROG);
  }
  __device__ void stall(int q, const int* pkt, bool front) {
    bump(S_STALL);
    *S.stalls_in_row += 1;
    if (front) qpush_front(q, pkt); else qpush(q, pkt);
  }

  // ---- second chance: scan 2W slots from the clock ----
  // flags: the set's row, updated in place in `fl` (refbits cleared);
  // returns the victim way or -1
  __device__ int second_chance(int* fl, int clock, int n_ways) {
    for (int i = 0; i < 2 * n_ways; ++i) {
      const int w = floor_mod(clock + i, n_ways);
      const int f = fl[w];
      if (f & (F_DIRTY | F_TRANS)) continue;
      if (f & F_REF) { fl[w] = f & ~F_REF; continue; }
      return w;
    }
    return -1;
  }

  // ---- DTL ----
  __device__ int dtl_find(int tvpn) {
    for (int i = 0; i < G.dtl_entries; ++i)
      if (S.dtl_tvpn[i] == tvpn) return i;
    return -1;
  }
  __device__ int dtl_oldest() {  // argmin of dtl_seq, first on ties
    int best = 0;
    for (int i = 1; i < G.dtl_entries; ++i)
      if (S.dtl_seq[i] < S.dtl_seq[best]) best = i;
    return best;
  }
  __device__ void flush_tvpn(int idx) {
    const int tvpn = S.dtl_tvpn[idx];
    bump(S_FTV);
    int p = S.dtl_head[idx];
    int pkt[5 + kMaxEntries];
    while (p != NIL) {
      const int s = floor_div(p, G.cmt_ways), w = floor_mod(p, G.cmt_ways);
      const int b = s * G.cmt_ways + w;
      const int nxt = S.cmt_next[b];
      const int fl = S.cmt_flags[b];
      if (fl & F_DIRTY) {
        const int chunk = floor_mod(S.cmt_tag[b], G.cpt);
        mkpkt(pkt, FLUSH_BLK, tvpn, chunk, NIL, NIL,
              S.cmt_data + (size_t)b * G.cmt_entries);
        qpush(Q_CTP_REQ, pkt);
        S.cmt_flags[b] = fl & ~F_DIRTY;
        S.cmt_next[b] = NIL;
        *S.cmt_dirty -= 1;
        bump(S_FBLK);
      }
      p = nxt;
    }
    S.dtl_tvpn[idx] = NIL;
    S.dtl_head[idx] = NIL;
    S.dtl_ndirty[idx] = 0;
    S.dtl_updated[idx] = 0;
    S.dtl_seq[idx] = kInt32Max;
  }
  __device__ void dtl_register(int s, int w, int tvpn) {
    const int p = s * G.cmt_ways + w;
    const int idx = dtl_find(tvpn);
    if (idx >= 0) {
      S.cmt_next[p] = S.dtl_head[idx];
      S.dtl_head[idx] = p;
      S.dtl_ndirty[idx] += 1;
      S.dtl_updated[idx] = 1;
      return;
    }
    if (dtl_find(NIL) < 0) flush_tvpn(dtl_oldest());  // full: make room
    int slot = dtl_find(NIL);
    if (slot < 0) slot = 0;
    S.cmt_next[p] = NIL;
    S.dtl_tvpn[slot] = tvpn;
    S.dtl_head[slot] = p;
    S.dtl_ndirty[slot] = 1;
    S.dtl_updated[slot] = 1;
    S.dtl_seq[slot] = *S.dtl_ctr;
    *S.dtl_ctr += 1;
  }
  __device__ int pick_flush_victim() {  // max ndirty; tie -> min seq
    int best_nd = -1;
    for (int i = 0; i < G.dtl_entries; ++i) {
      const int nd = S.dtl_tvpn[i] != NIL ? S.dtl_ndirty[i] : -1;
      if (nd > best_nd) best_nd = nd;
    }
    int best = 0, best_seq = kInt32Max;
    for (int i = 0; i < G.dtl_entries; ++i) {
      const bool valid = S.dtl_tvpn[i] != NIL;
      const int seq = (valid && S.dtl_ndirty[i] == best_nd) ? S.dtl_seq[i]
                                                            : kInt32Max;
      if (seq < best_seq) { best_seq = seq; best = i; }
    }
    return best;
  }
  __device__ bool any_dtl() {
    for (int i = 0; i < G.dtl_entries; ++i)
      if (S.dtl_tvpn[i] != NIL) return true;
    return false;
  }

  // ---- CMT ----
  __device__ void cmt_apply(int s, int w, int kind, int off, int rid,
                            int dppn, int old) {
    const int b = s * G.cmt_ways + w;
    const int cur = S.cmt_data[(size_t)b * G.cmt_entries + off];
    if (kind == LOOKUP) { emit_resp(rid, LOOKUP, cur, ST_OK); return; }
    if (kind == COND_UPDATE && cur != old) {
      emit_resp(rid, COND_UPDATE, cur, ST_STALE);
      return;
    }
    S.cmt_data[(size_t)b * G.cmt_entries + off] = dppn;
    const int fl = S.cmt_flags[b];
    if (!(fl & F_DIRTY)) {
      S.cmt_flags[b] = fl | F_DIRTY;
      *S.cmt_dirty += 1;
      dtl_register(s, w, floor_div(S.cmt_tag[b], G.cpt));
    }
    emit_resp(rid, kind, dppn, ST_OK);
  }
  __device__ void targeted_cmt_flush(int s) {
    for (int w = 0; w < G.cmt_ways; ++w) {
      const int b = s * G.cmt_ways + w;
      if (S.cmt_flags[b] & F_DIRTY) {
        const int idx = dtl_find(floor_div(S.cmt_tag[b], G.cpt));
        if (idx >= 0) flush_tvpn(idx);
        return;
      }
    }
  }
  __device__ void cmt_handle(const int* pkt, int qid) {
    const int kind = pkt[0], dlpn = pkt[1], dppn = pkt[2], old = pkt[3],
              rid = pkt[4];
    const int block_id = floor_div(dlpn, G.cmt_entries);
    const int s = floor_mod(block_id, G.cmt_sets);
    const int off = floor_mod(dlpn, G.cmt_entries);
    const int base = s * G.cmt_ways;
    int way = -1;
    for (int w = 0; w < G.cmt_ways; ++w)
      if (S.cmt_tag[base + w] == block_id &&
          (S.cmt_flags[base + w] & (F_VALID | F_TRANS))) { way = w; break; }
    const int mk = kind == LOOKUP ? M_LOOKUP
                   : kind == UPDATE ? M_UPDATE : M_COND;
    if (way >= 0 && (S.cmt_flags[base + way] & F_TRANS)) {
      const int b = base + way;
      const int n = S.cmt_mshr_n[b];
      if (n >= G.mshr_cap) { stall(qid, pkt, false); return; }
      bump(S_MERGE);
      int* row = S.cmt_mshr + ((size_t)b * G.mshr_cap + n) * 5;
      row[0] = mk; row[1] = off; row[2] = rid; row[3] = dppn; row[4] = old;
      S.cmt_mshr_n[b] = n + 1;
      return;
    }
    if (way >= 0) {
      bump(S_HIT);
      S.cmt_flags[base + way] |= F_REF;
      cmt_apply(s, way, kind, off, rid, dppn, old);
      return;
    }
    bump(S_MISS);
    int fl[kMaxWays];
    for (int w = 0; w < G.cmt_ways; ++w) fl[w] = S.cmt_flags[base + w];
    const int vic = second_chance(fl, S.cmt_clock[s], G.cmt_ways);
    if (vic < 0) {
      targeted_cmt_flush(s);
      stall(qid, pkt, false);
      return;
    }
    fl[vic] = F_TRANS | F_REF;
    for (int w = 0; w < G.cmt_ways; ++w) S.cmt_flags[base + w] = fl[w];
    S.cmt_clock[s] = (vic + 1) % G.cmt_ways;
    const int b = base + vic;
    S.cmt_tag[b] = block_id;
    S.cmt_next[b] = NIL;
    int* row = S.cmt_mshr + (size_t)b * G.mshr_cap * 5;
    row[0] = mk; row[1] = off; row[2] = rid; row[3] = dppn; row[4] = old;
    S.cmt_mshr_n[b] = 1;
    int load[5 + kMaxEntries];
    mkpkt(load, LOAD, floor_div(dlpn, G.ept),
          floor_div(floor_mod(dlpn, G.ept), G.cmt_entries), b, NIL, nullptr);
    qpush(Q_CTP_REQ, load);
  }
  __device__ void cmt_fill(const int* pkt) {
    const int dest = pkt[3];
    const int s = floor_div(dest, G.cmt_ways), w = floor_mod(dest, G.cmt_ways);
    const int b = s * G.cmt_ways + w;
    for (int i = 0; i < G.cmt_entries; ++i)
      S.cmt_data[(size_t)b * G.cmt_entries + i] = pkt[5 + i];
    S.cmt_flags[b] = (S.cmt_flags[b] & ~F_TRANS) | F_VALID;
    const int n = S.cmt_mshr_n[b];
    S.cmt_mshr_n[b] = 0;
    for (int i = 0; i < G.mshr_cap && i < n; ++i) {
      const int* row = S.cmt_mshr + ((size_t)b * G.mshr_cap + i) * 5;
      const int kind = row[0] == M_LOOKUP ? LOOKUP
                       : row[0] == M_UPDATE ? UPDATE : COND_UPDATE;
      cmt_apply(s, w, kind, row[1], row[2], row[3], row[4]);
    }
  }
  __device__ bool cmt_flush_needed() {
    return (G.cmt_blocks - *S.cmt_dirty) < G.cmt_low && any_dtl();
  }

  // ---- CTP ----
  __device__ void fifo_push(int tvpn) {
    for (int i = 0; i < G.fifo_cap; ++i)
      if (S.fifo[i] == tvpn) return;
    S.fifo[floor_mod(*S.fifo_tail, G.fifo_cap)] = tvpn;
    *S.fifo_tail += 1;
  }
  __device__ void ctp_apply(int s, int w, int kind, int chunk, int dest,
                            const int* data) {
    const int b = s * G.ctp_ways + w;
    const int ec = G.cmt_entries;
    const int start = slice_start(chunk * ec, G.ept, ec);
    int* page = S.ctp_data + (size_t)b * G.ept;
    if (kind == LOAD) {
      int pkt[5 + kMaxEntries];
      mkpkt(pkt, LOAD_RESP, S.ctp_tag[b], chunk, dest, NIL, page + start);
      qpush(Q_CTP_RESP, pkt);
      return;
    }
    for (int i = 0; i < ec; ++i) page[start + i] = data[i];
    const int fl = S.ctp_flags[b];
    if (!(fl & F_DIRTY)) {
      S.ctp_flags[b] = fl | F_DIRTY;
      *S.ctp_dirty += 1;
      fifo_push(S.ctp_tag[b]);
    }
  }
  // _ctp_fill_data after the page copy: flags, then the MSHR replays
  __device__ void ctp_fill_rest(int s, int w) {
    const int b = s * G.ctp_ways + w;
    const int m2w = 3 + G.cmt_entries;
    S.ctp_flags[b] = (S.ctp_flags[b] & ~F_TRANS) | F_VALID;
    const int n = S.ctp_mshr_n[b];
    S.ctp_mshr_n[b] = 0;
    for (int i = 0; i < G.ctp_mshr_cap && i < n; ++i) {
      const int* row = S.ctp_mshr + ((size_t)b * G.ctp_mshr_cap + i) * m2w;
      ctp_apply(s, w, row[0] == M_LOAD ? LOAD : FLUSH_BLK, row[1], row[2],
                row + 3);
    }
  }
  __device__ void ctp_fill_data(int s, int w, int src) {
    W.fill = 1; W.fs = s; W.fw = w; W.fsrc = src;
  }
  __device__ void writeback_block(int s, int w) {
    const int b = s * G.ctp_ways + w;
    int tppn = *S.tppn_next;
    const int tvpn = S.ctp_tag[b];
    int j = tppn;
    if (wr_idx(j, G.tppn_cap)) { W.wb = 1; W.ws = s; W.ww = w; W.wdst = j; }
    int k = tvpn;
    if (wr_idx(k, G.n_tvpns)) S.gtd[k] = tppn;
    *S.tppn_next += 1;
    S.ctp_flags[b] &= ~F_DIRTY;
    *S.ctp_dirty -= 1;
    emit_prog(tvpn, tppn);
  }
  __device__ void targeted_ctp_writeback(int s) {
    for (int w = 0; w < G.ctp_ways; ++w) {
      const int f = S.ctp_flags[s * G.ctp_ways + w];
      if ((f & F_DIRTY) && (f & F_VALID)) { writeback_block(s, w); return; }
    }
  }
  __device__ void ctp_handle(const int* pkt) {
    const int kind = pkt[0], tvpn = pkt[1], chunk = pkt[2], dest = pkt[3];
    const int* data = pkt + 5;
    const int s = floor_mod(tvpn, G.ctp_sets);
    const int base = s * G.ctp_ways;
    const int m2w = 3 + G.cmt_entries;
    int way = -1;
    for (int w = 0; w < G.ctp_ways; ++w)
      if (S.ctp_tag[base + w] == tvpn &&
          (S.ctp_flags[base + w] & (F_VALID | F_TRANS))) { way = w; break; }
    const int mk = kind == LOAD ? M_LOAD : M_FLUSH;
    if (way >= 0 && (S.ctp_flags[base + way] & F_TRANS)) {
      const int b = base + way;
      const int n = S.ctp_mshr_n[b];
      if (n >= G.ctp_mshr_cap) { stall(Q_CTP_REQ, pkt, true); return; }
      bump(S_MERGE);
      int* row = S.ctp_mshr + ((size_t)b * G.ctp_mshr_cap + n) * m2w;
      row[0] = mk; row[1] = chunk; row[2] = dest;
      for (int i = 0; i < G.cmt_entries; ++i) row[3 + i] = data[i];
      S.ctp_mshr_n[b] = n + 1;
      return;
    }
    if (way >= 0) {
      bump(S_CHIT);
      S.ctp_flags[base + way] |= F_REF;
      ctp_apply(s, way, kind, chunk, dest, data);
      return;
    }
    bump(S_CMISS);
    int fl[kMaxWays];
    for (int w = 0; w < G.ctp_ways; ++w) fl[w] = S.ctp_flags[base + w];
    const int vic = second_chance(fl, S.ctp_clock[s], G.ctp_ways);
    if (vic < 0) {
      targeted_ctp_writeback(s);
      stall(Q_CTP_REQ, pkt, true);
      return;
    }
    fl[vic] = F_TRANS | F_REF;
    for (int w = 0; w < G.ctp_ways; ++w) S.ctp_flags[base + w] = fl[w];
    S.ctp_clock[s] = (vic + 1) % G.ctp_ways;
    const int b = base + vic;
    S.ctp_tag[b] = tvpn;
    int* row = S.ctp_mshr + (size_t)b * G.ctp_mshr_cap * m2w;
    row[0] = mk; row[1] = chunk; row[2] = dest;
    for (int i = 0; i < G.cmt_entries; ++i) row[3 + i] = data[i];
    S.ctp_mshr_n[b] = 1;
    const int tppn = S.gtd[rd_idx(tvpn, G.n_tvpns)];
    if (tppn == NIL) ctp_fill_data(s, vic, -1);
    else emit_fc(tppn, s, vic);
  }
  __device__ void fc_handle(const int* pkt) {
    ctp_fill_data(pkt[2], pkt[3], rd_idx(pkt[1], G.tppn_cap));
  }
  __device__ bool ctp_writeback_needed() {
    return (G.ctp_blocks - *S.ctp_dirty) < G.ctp_low &&
           *S.fifo_tail > *S.fifo_head;
  }
  __device__ bool ctp_writeback_one() {
    while (*S.fifo_tail > *S.fifo_head) {
      const int pos = floor_mod(*S.fifo_head, G.fifo_cap);
      const int tvpn = S.fifo[pos];
      *S.fifo_head += 1;
      S.fifo[pos] = NIL;
      const int s = floor_mod(tvpn, G.ctp_sets);
      for (int w = 0; w < G.ctp_ways; ++w) {
        const int b = s * G.ctp_ways + w;
        const int f = S.ctp_flags[b];
        if (S.ctp_tag[b] == tvpn && (f & F_VALID) && (f & F_DIRTY)) {
          writeback_block(s, w);
          return true;
        }
      }
    }
    return false;
  }

  // ---- arbitration + step ----
  __device__ int arbitrate(bool& picked) {
    bool any_ne = false, all_zero = true;
    for (int q = 0; q < 5; ++q) {
      if (S.qtail[q] - S.qhead[q] > 0) {
        any_ne = true;
        if (S.credits[q] > 0) all_zero = false;
      }
    }
    if (any_ne && all_zero)
      for (int q = 0; q < 5; ++q) S.credits[q] = S.weights[q];
    picked = false;
    int qid = 0;
    for (int q = 0; q < 5; ++q) {
      if (S.qtail[q] - S.qhead[q] > 0 && S.credits[q] > 0) {
        picked = true;
        qid = q;
        break;
      }
    }
    if (picked) S.credits[qid] -= 1;
    picked = picked && any_ne;
    return qid;
  }
  // one step up to a fill's page copy: returns the code; with W.fill set
  // the caller copies the page, then runs finish_fill(before)
  __device__ int step(int& before) {
    bump(S_STEPS);
    if (ctp_writeback_needed() && ctp_writeback_one()) return WORKED;
    if (cmt_flush_needed()) {
      flush_tvpn(pick_flush_victim());
      return WORKED;
    }
    bool picked;
    const int qid = arbitrate(picked);
    if (!picked) return IDLE;
    int qlens = 0;
    for (int q = 0; q < 5; ++q) qlens += S.qtail[q] - S.qhead[q];
    if (*S.stalls_in_row > qlens + 4) {
      *S.stalls_in_row = 0;
      return BLOCKED;
    }
    before = *S.stalls_in_row;
    int pkt[5 + kMaxEntries];
    qpop(qid, pkt);
    switch (qid < 0 ? 0 : (qid > 4 ? 4 : qid)) {
      case Q_FC_RESP: fc_handle(pkt); break;
      case Q_CTP_RESP: cmt_fill(pkt); break;
      case Q_CTP_REQ: ctp_handle(pkt); break;
      default: cmt_handle(pkt, qid); break;
    }
    if (!W.fill && *S.stalls_in_row == before) *S.stalls_in_row = 0;
    return WORKED;
  }
  __device__ void finish_fill(int before) {
    ctp_fill_rest(W.fs, W.fw);
    if (*S.stalls_in_row == before) *S.stalls_in_row = 0;
  }
  __device__ void deliver_fc() {
    int pkt[5 + kMaxEntries];
    for (int i = *S.fc_head; i < *S.fc_n; ++i) {
      const int* r = S.fc_buf + (size_t)floor_mod(i, G.queue_cap) * 3;
      mkpkt(pkt, FC_READ_RESP, r[0], r[1], r[2], NIL, nullptr);
      qpush(Q_FC_RESP, pkt);
    }
    *S.fc_head = *S.fc_n;
  }
};

// n ints from src to dst by the whole block (16-byte moves when n % 4 ==
// 0: every page starts at a multiple of n ints); src null: fill with NIL
__device__ void block_copy(int* dst, const int* src, int n) {
  if ((n & 3) == 0) {
    int4* d = reinterpret_cast<int4*>(dst);
    const int4* s = reinterpret_cast<const int4*>(src);
    const int4 nil = make_int4(NIL, NIL, NIL, NIL);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      d[i] = src ? s[i] : nil;
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[i] = src ? src[i] : NIL;
  }
}

// mode 0: run up to max_steps steps (out[0] = steps taken); 1: flush the
// oldest DTL entry; 2: write back one FIFO entry (out[0] = done)
__global__ void __launch_bounds__(kThreads) fmmu_fsm_kernel(
    State S, Geom G, int mode, int max_steps, int auto_flash, int* out) {
  __shared__ Wide s_wide;
  __shared__ int s_cont;
  Fsm m{S, G, Wide{}};
  int n = 0, before = 0;
  if (mode == 0 && max_steps <= 0) {
    if (threadIdx.x == 0) out[0] = 0;
    return;
  }
  for (;;) {
    if (threadIdx.x == 0) {
      m.W = Wide{0, 0, 0, 0, 0, 0, 0, 0};
      int cont = 0;
      if (mode == 0) {
        const bool worked = m.step(before) == WORKED;
        n += 1;
        if (auto_flash) {
          const bool can = !worked && *S.fc_n > *S.fc_head;
          if (can) m.deliver_fc();
          cont = worked || can;
        } else {
          cont = worked;
        }
        cont = cont && n < max_steps;
      } else if (mode == 1) {
        if (m.any_dtl()) m.flush_tvpn(m.dtl_oldest());
      } else {
        out[0] = m.ctp_writeback_one() ? 1 : 0;
      }
      s_wide = m.W;
      s_cont = cont;
    }
    __syncthreads();
    const Wide w = s_wide;
    const int cont = s_cont;
    if (w.fill) {
      block_copy(S.ctp_data + ((size_t)w.fs * G.ctp_ways + w.fw) * G.ept,
                 w.fsrc < 0 ? nullptr : S.flash_tp + (size_t)w.fsrc * G.ept,
                 G.ept);
      __syncthreads();
      if (threadIdx.x == 0) m.finish_fill(before);
    }
    if (w.wb)
      block_copy(S.flash_tp + (size_t)w.wdst * G.ept,
                 S.ctp_data + ((size_t)w.ws * G.ctp_ways + w.ww) * G.ept,
                 G.ept);
    __syncthreads();
    if (!cont) break;
  }
  if (threadIdx.x == 0 && mode == 0) out[0] = n;
}

}  // namespace

// state: 43 device pointers in FMMUState's field order; geom: the 19
// ints of Geom; out: one device int32
extern "C" int fmmu_fsm_launch(const void* const* state, const int* geom,
                               int mode, int max_steps, int auto_flash,
                               void* out, void* stream) {
  State S;
  Geom G;
  memcpy(&S, state, sizeof(State));
  memcpy(&G, geom, sizeof(Geom));
  if (G.cmt_entries > kMaxEntries || G.cmt_ways > kMaxWays ||
      G.ctp_ways > kMaxWays || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  fmmu_fsm_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      S, G, mode, max_steps, auto_flash, (int*)out);
  return (int)cudaGetLastError();
}
