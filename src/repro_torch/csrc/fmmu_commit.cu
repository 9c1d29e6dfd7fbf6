// The whole FMMU map commit in one launch, for Hopper (sm_90a).
//
// Redesign of the Pallas TPU kernel repro/kernels/fmmu_translate.py
// (`fmmu_translate`, body `_ft_kernel`: the CMT probe, backing fallback
// and ref-bit touch) as the map commit it sits in
// (repro/core/fmmu/batch.py `alloc_serving`, `_translate_core`,
// `_insert_blocks`, `translate_serving`). One launch, in order:
//   1. optional alloc (serving_grow): rank of the `grow` lanes, pop
//      free_stack[free_n - 1 - rank], lanes past the stack's depth fail
//      and raise the sticky oob flag;
//   2. probe: first matching way, the cached DPPN on a hit, backing on an
//      active miss, NIL on an inactive lane, ref-bit touch for probed
//      hits; every lane reads the pre-batch state;
//   3. write-through of the committed lanes (UPDATE, and COND_UPDATE
//      whose guard held) to backing, to the cached copy of a hit, and to
//      the serving block table;
//   4. the MSHR-merged insert pass: priority collapsed per block id, one
//      sort of the packed key (set*4 + prio) * q_cap + bid / S, the
//      first of each equal key kept, ranks within each set segment,
//      ranks >= W overflow, ways (clock + rank) % W filled from the
//      post-write backing, clocks advanced;
//   5. stats, commit_seq, free_n and oob, each written by one thread.
// The result is bit-identical to that chain of torch ops (the plain
// version, core/fmmu/batch.commit_chain).
//
// Channel-sharded map (repro/core/fmmu/batch.py `translate_sharded`,
// `grow_sharded`: a jax.vmap of that commit over the channel axis): the
// state tensors carry a leading [C] axis and one launch runs C blocks,
// block c committing shard c, as the paper's one FMMU per channel. Every
// block reads every lane. Lane i is block c's own when it lies in channel
// c (dlpn >= 0 and dlpn mod C == c; in grow mode any dlpn with
// dlpn mod C == c); an own lane runs with the channel-local dlpn
// dlpn div C, any other as an inactive lane (-1), and in grow mode only
// the own lanes pop (so the requester ranks count only the channel's
// pops). Each output lane has one writer, its owner block, or block 0
// for a lane no channel owns (an inactive lane: NIL, not ok), so the
// reference's "+1" sum over the channels is a plain write. The unstacked
// state (kSharded = false) is the one-block kernel unchanged.
//
// What bounds it here: latency. A serving commit carries 8 to a few
// hundred lanes and touches kilobytes; the chain it replaces was ~230
// launches of a few microseconds each. So the design is one launch and
// as few barriers as the reference's ordering allows.
//
// What the design does about it:
// - One thread block per shard (one in all unsharded), on one SM, up
//   to 1024 threads; lanes are strided over the threads, so lane i
//   lives on thread i % blockDim in every phase and a thread re-reads
//   its own earlier global writes without a barrier. Blocks share no
//   state: each writes its shard and its own lanes' outputs.
// - Phases are separated by __syncthreads(): the block's global writes
//   before a barrier are visible to the block after it, which gives the
//   reference's ordering (probe on the pre-batch state, write-through,
//   then an insert that reads the post-write backing).
// - Per-lane scratch lives in dynamic shared memory sized to the batch:
//   the sort keys, the kept-entry prefix, an open-addressing hash of
//   block id -> minimum priority (atomicMin: the minimum does not depend
//   on the order of the updates), the lane flags. ~25 bytes a lane: the
//   wrapper's lane cap (8192) is what the 227 KB of a block allow.
// - Ranks and the alloc's requester ranks are block scans (warp
//   shuffles); the sort is a bitonic sort in shared memory.
// - Counts are block reductions; every scalar of the state (stats,
//   commit_seq, free_n, oob) and each set's clock has one writer, so no
//   atomic's order shows in the result.
// - The CMT is not staged: the few touched sets are read from global
//   memory (the paper geometry's data array alone is 64 KB).
// - Values are plain int32 loads and stores: host-tier ids at 1<<24 and
//   above move exactly. Integer arithmetic wraps as torch's does.
#include "common.cuh"

namespace {

constexpr int kLookup = 0, kUpdate = 1, kCondUpdate = 2;  // fmmu/types.py
constexpr int kNil = -1;
constexpr int kBig = 0x7fffffff;  // int32 max: the "no miss" key
constexpr int kEmpty = -1;        // a free hash slot (block ids are >= 0)
constexpr unsigned kFull = 0xffffffffu;

// lane flags kept in shared memory between phases; priority in bits 3-4
constexpr uint8_t kHit = 1, kWrite = 2, kMiss = 4;

// elements between two channels' shards of each stacked state tensor
struct ShardStrides {
  int tags, valid, ref, clock, data, backing, stats, table, commit_seq,
      free_stack, free_n, oob;
};

struct Commit {
  int* tags;
  uint8_t* valid;
  uint8_t* ref;
  int* clock;
  int* data;
  int* backing;
  int* stats;
  int* table;            // null: no block table (translate_batch)
  int* commit_seq;
  const int* free_stack;  // grow mode (serving_grow) only
  int* free_n;
  uint8_t* oob;
  const uint8_t* grow;   // null: opcodes/dppns/old_dppns are given
  const int* opcodes;
  const int* dlpns;
  const int* dppns;
  const int* old_dppns;
  int* out;              // null in grow mode
  uint8_t* ok;
  int* blocks;           // grow mode only
  int n_sets, n_ways, n_entries, n_backing, n_table, n_stack, n_lanes;
  int n_sorted, n_hash, q_cap, n_blocks;
  int n_channels;
  ShardStrides stride;
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// sum over the block, returned to every thread; red: 32 shared ints
__device__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();  // red may still be read by the previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

// exclusive prefix sum of a[0..n) in place; returns the total. Thread t
// owns a contiguous run of a, so the prefix is in index order.
__device__ int block_exclusive_scan(int* a, int n, int* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = x;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int t = red[w];
    if (w < warp) before += t;
    total += t;
  }
  int run = before + x - s;
  for (int i = lo; i < hi; ++i) {
    const int t = a[i];
    a[i] = run;
    run += t;
  }
  __syncthreads();
  return total;
}

__device__ __forceinline__ unsigned hash_slot(int key, int mask) {
  unsigned x = (unsigned)key;  // murmur3's finalizer
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x & (unsigned)mask;
}

// min-merge `val` into the entry of `key` (the table is never full: it
// has at least twice as many slots as lanes)
__device__ void hash_min(int* hkey, int* hval, int mask, int key, int val) {
  for (unsigned h = hash_slot(key, mask);; h = (h + 1) & (unsigned)mask) {
    const int prev = atomicCAS(&hkey[h], kEmpty, key);
    if (prev == kEmpty || prev == key) {
      atomicMin(&hval[h], val);
      return;
    }
  }
}

__device__ int hash_get(const int* hkey, const int* hval, int mask, int key,
                        int dflt) {
  for (unsigned h = hash_slot(key, mask);; h = (h + 1) & (unsigned)mask) {
    const int k = hkey[h];
    if (k == key) return hval[h];
    if (k == kEmpty) return dflt;
  }
}

// first index of a[0..n) (ascending) that is >= v
__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (a[m] < v) lo = m + 1; else hi = m;
  }
  return lo;
}

// first matching way of block `bid` in set `set`, -1 when none
__device__ __forceinline__ int find_way(const Commit& c, int set, int bid) {
  for (int w = 0; w < c.n_ways; ++w) {
    const int i = set * c.n_ways + w;
    if (c.valid[i] && c.tags[i] == bid) return w;
  }
  return -1;
}

// block ch's shard of every stacked state tensor
__device__ void select_shard(Commit& c, int ch) {
  const ShardStrides& s = c.stride;
  c.tags += ch * s.tags;
  c.valid += ch * s.valid;
  c.ref += ch * s.ref;
  c.clock += ch * s.clock;
  c.data += ch * s.data;
  c.backing += ch * s.backing;
  c.stats += ch * s.stats;
  if (c.table != nullptr) {
    c.table += ch * s.table;
    c.commit_seq += ch * s.commit_seq;
  }
  if (c.grow != nullptr) {
    c.free_stack += ch * s.free_stack;
    c.free_n += ch * s.free_n;
    c.oob += ch * s.oob;
  }
}

template <bool kSharded>
__global__ void __launch_bounds__(1024, 1) fmmu_commit_kernel(Commit c) {
  extern __shared__ int smem[];
  const int n = c.n_sorted, bq = c.n_lanes, T = blockDim.x, tid = threadIdx.x;
  const int S = c.n_sets, W = c.n_ways, E = c.n_entries;
  const int hmask = c.n_hash - 1;
  int* keys = smem;                 // [n] miss block ids, then sort keys
  int* cf = keys + n;               // [n + 1] scans
  int* hkey = cf + n + 1;           // [n_hash] block id (or a set, last)
  int* hval = hkey + c.n_hash;      // [n_hash] min priority (or a clock)
  uint8_t* flags = reinterpret_cast<uint8_t*>(hval + c.n_hash);  // [bq]
  __shared__ int red[32];
  const bool grow_mode = c.grow != nullptr;
  const int C = c.n_channels, ch = blockIdx.x;
  if (kSharded) select_shard(c, ch);

  for (int i = tid; i < c.n_hash; i += T) {
    hkey[i] = kEmpty;
    hval[i] = 3;
  }
  for (int i = bq + tid; i < n; i += T) keys[i] = kBig;
  int n_alloc = 0, n_fail = 0;
  if (grow_mode) {  // 1. ranks of the requesting (own) lanes
    for (int i = tid; i < bq; i += T) {
      cf[i] = c.grow[i] && (!kSharded || floor_mod(c.dlpns[i], C) == ch);
    }
  }
  // every hash slot is empty before any lane inserts into it
  __syncthreads();
  if (grow_mode) block_exclusive_scan(cf, bq, red);
  const int free_n0 = grow_mode ? *c.free_n : 0;

  // 1-2. alloc and probe, on the pre-batch state
  int n_hit = 0, n_miss = 0;
  for (int i = tid; i < bq; i += T) {
    int d, op;
    bool writer = true;  // this block writes lane i's outputs
    const int dg = c.dlpns[i];
    if (grow_mode) {
      writer = !kSharded || floor_mod(dg, C) == ch;
      const bool want = c.grow[i] && writer;
      const int idx = free_n0 - 1 - cf[i];
      const bool ok = want && idx >= 0;
      const int picked =
          c.n_stack > 0 ? c.free_stack[min(max(idx, 0), c.n_stack - 1)] : kNil;
      if (writer) {
        c.blocks[i] = ok ? picked : kNil;
        c.ok[i] = ok;
      }
      n_alloc += ok;
      n_fail += want && !ok;
      d = ok ? (kSharded ? floor_div(dg, C) : dg) : -1;
      op = kUpdate;
    } else {
      d = dg;
      if (kSharded) {
        const bool own = dg >= 0 && floor_mod(dg, C) == ch;
        writer = own || (dg < 0 && ch == 0);
        d = own ? floor_div(dg, C) : -1;
      }
      op = c.opcodes[i];
    }
    const bool active = d >= 0;
    const bool is_l = op == kLookup, is_u = op == kUpdate,
               is_c = op == kCondUpdate;
    const bool probed = active && (is_l || is_c);
    const int bid = floor_div(d, E);
    const int set = floor_mod(bid, S);
    const int way = find_way(c, set, bid);
    const bool hit = active && way >= 0;
    int cur = kNil;
    if (hit) {
      cur = c.data[(set * W + way) * E + floor_mod(d, E)];
    } else if (active) {
      cur = c.backing[min(d, c.n_backing - 1)];
    }
    bool ok = active;
    if (!grow_mode) {
      if (is_c) ok = active && cur == c.old_dppns[i];
      if (writer) {
        c.out[i] = active ? cur : kNil;
        c.ok[i] = ok;
      }
    }
    const bool write = (is_u && active) || (is_c && ok);
    if (hit && probed) c.ref[set * W + way] = 1;  // every toucher stores 1
    n_hit += probed && hit;
    n_miss += probed && !hit;
    const bool miss = active && !hit && bid != kBig;  // BIG: "no miss"
    const int prio = is_l ? 0 : is_u ? 1 : 2;
    flags[i] = (hit ? kHit : 0) | (write ? kWrite : 0) | (miss ? kMiss : 0) |
               (uint8_t)(prio << 3);
    keys[i] = miss ? bid : kBig;
    if (miss && bid < c.n_blocks) hash_min(hkey, hval, hmask, bid, prio);
  }
  __syncthreads();

  // 3. write-through, then the packed insert keys (hash complete)
  int n_write = 0;
  for (int i = tid; i < bq; i += T) {
    const int f = flags[i];
    if (f & kWrite) {
      // a write lane is active, the block's own (and allocated)
      const int d = kSharded ? floor_div(c.dlpns[i], C) : c.dlpns[i];
      const int v = grow_mode ? c.blocks[i] : c.dppns[i];
      if (d < c.n_backing) c.backing[d] = v;
      if (f & kHit) {
        const int bid = d / E, set = bid % S;
        c.data[(set * W + find_way(c, set, bid)) * E + d % E] = v;
      }
      if (c.table != nullptr && d < c.n_table) c.table[d] = v;
      ++n_write;
    }
    if (f & kMiss) {
      const int bid = keys[i];
      // a block id past the map reads the last block's priority, as the
      // reference's clamped gather does
      const int pe = hash_get(hkey, hval, hmask, min(bid, c.n_blocks - 1), 3);
      keys[i] = wrap_add(wrap_mul((bid % S) * 4 + pe, c.q_cap), bid / S);
    }
  }
  __syncthreads();

  // 4. the insert pass over the sorted keys
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n; i += T) {
        const int l = i ^ j;
        if (l > i) {
          const int x = keys[i], y = keys[l];
          if ((x > y) == ((i & k) == 0)) {
            keys[i] = y;
            keys[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  const int seg = 4 * c.q_cap;  // keys per set
  for (int i = tid; i < n; i += T) {
    const int g = keys[i];
    const int gs = g != kBig ? floor_div(g, seg) : S;
    cf[i] = (i == 0 || g != keys[i - 1]) && gs < S;
  }
  __syncthreads();
  const int n_kept = block_exclusive_scan(cf, n, red);
  if (tid == 0) cf[n] = n_kept;
  __syncthreads();
  int n_fill = 0;
  for (int i = tid; i < n; i += T) {
    hkey[i] = kEmpty;  // the hash is done with: pending clocks, below
    const int g = keys[i];
    const int gs = g != kBig ? floor_div(g, seg) : S;
    const bool kept = (i == 0 || g != keys[i - 1]) && gs < S;
    if (!kept) continue;
    const int start = lower_bound(keys, n, gs * seg);
    const int rank = cf[i] - cf[start];
    if (rank >= W) continue;
    const int c0 = c.clock[gs];
    const int way = floor_mod(c0 + rank, W);
    const int gbid = wrap_add(wrap_mul(floor_mod(g, c.q_cap), S), gs);
    const int slot = gs * W + way;
    c.tags[slot] = gbid;
    c.valid[slot] = 1;
    c.ref[slot] = 1;
    const int base = wrap_mul(gbid, E);
    for (int e = 0; e < E; ++e) {
      const int src = min(max(wrap_add(base, e), 0), c.n_backing - 1);
      c.data[slot * E + e] = c.backing[src];
    }
    ++n_fill;
    if (rank == 0) {  // one writer per set: the clock advances by its fills
      const int end = lower_bound(keys, n, (gs + 1) * seg);
      hkey[i] = gs;
      hval[i] = floor_mod(c0 + min(W, cf[end] - cf[start]), W);
    }
  }
  __syncthreads();  // every clock read above precedes the writes below
  for (int i = tid; i < n; i += T) {
    if (hkey[i] != kEmpty) c.clock[hkey[i]] = hval[i];
  }

  // 5. counts, each scalar written by one thread
  n_hit = block_sum(n_hit, red);
  n_miss = block_sum(n_miss, red);
  n_write = block_sum(n_write, red);
  n_fill = block_sum(n_fill, red);
  if (grow_mode) {
    n_alloc = block_sum(n_alloc, red);
    n_fail = block_sum(n_fail, red);
  }
  if (tid == 0) {
    c.stats[0] = wrap_add(c.stats[0], n_hit);
    c.stats[1] = wrap_add(c.stats[1], n_miss);
    c.stats[2] = wrap_add(c.stats[2], n_fill);
    c.stats[3] = wrap_add(c.stats[3], n_write);
    if (c.table != nullptr) *c.commit_seq = wrap_add(*c.commit_seq, n_write);
    if (grow_mode) {
      *c.free_n = free_n0 - n_alloc;
      if (n_fail > 0) *c.oob = 1;
    }
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// Dynamic shared memory of a launch over n_lanes lanes (the wrapper's
// fmmu_commit.smem_bytes mirrors it).
extern "C" int fmmu_commit_smem_bytes(int n_lanes) {
  const int n = next_pow2(n_lanes), hs = next_pow2(2 * n_lanes);
  return 4 * (n + n + 1 + 2 * hs) + n_lanes;
}

template <bool kSharded>
int launch(const Commit& c, int grid, int threads, int smem,
           cudaStream_t stream) {
  static int opted_in = 48 * 1024;  // the default dynamic shared memory
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fmmu_commit_kernel<kSharded>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  fmmu_commit_kernel<kSharded><<<grid, threads, smem, stream>>>(c);
  return (int)cudaGetLastError();
}

// n_channels == 0: an unstacked state (one block); n_channels >= 1: a
// state stacked on n_channels shards, whose strides the s_* give.
extern "C" int fmmu_commit_launch(
    void* tags, void* valid, void* ref, void* clock, void* data,
    void* backing, void* stats, void* table, void* commit_seq,
    const void* free_stack, void* free_n, void* oob, const void* grow,
    const void* opcodes, const void* dlpns, const void* dppns,
    const void* old_dppns, void* out, void* ok, void* blocks, int n_sets,
    int n_ways, int n_entries, int n_backing, int n_table, int n_stack,
    int n_lanes, int q_cap, int n_blocks, int n_channels, int s_tags,
    int s_valid, int s_ref, int s_clock, int s_data, int s_backing,
    int s_stats, int s_table, int s_commit_seq, int s_free_stack,
    int s_free_n, int s_oob, void* stream) {
  if (n_lanes < 1 || n_channels < 0) return (int)cudaErrorInvalidValue;
  Commit c{(int*)tags, (uint8_t*)valid, (uint8_t*)ref, (int*)clock,
           (int*)data, (int*)backing, (int*)stats, (int*)table,
           (int*)commit_seq, (const int*)free_stack, (int*)free_n,
           (uint8_t*)oob, (const uint8_t*)grow, (const int*)opcodes,
           (const int*)dlpns, (const int*)dppns, (const int*)old_dppns,
           (int*)out, (uint8_t*)ok, (int*)blocks, n_sets, n_ways, n_entries,
           n_backing, n_table, n_stack, n_lanes, next_pow2(n_lanes),
           next_pow2(2 * n_lanes), q_cap, n_blocks, n_channels,
           ShardStrides{s_tags, s_valid, s_ref, s_clock, s_data, s_backing,
                        s_stats, s_table, s_commit_seq, s_free_stack,
                        s_free_n, s_oob}};
  const int smem = fmmu_commit_smem_bytes(n_lanes);
  const int threads = n_lanes >= 1024 ? 1024 : (n_lanes + 31) / 32 * 32;
  if (n_channels == 0) {
    return launch<false>(c, 1, threads, smem, (cudaStream_t)stream);
  }
  return launch<true>(c, n_channels, threads, smem, (cudaStream_t)stream);
}
