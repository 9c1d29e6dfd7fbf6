// Probe-only FMMU CMT lookup for Hopper (sm_90a): the probe of the
// unfused map path (core/fmmu/batch.*_unfused).
//
// Replaces the Pallas TPU kernel repro/kernels/fmmu_lookup.py
// (`fmmu_lookup`, body `_fl_kernel`): for every lane, set = (dlpn // E)
// mod S, a tag compare over the W ways of that set, the hit flag, the
// FIRST matching way (0 when none) and the cached DPPN on a hit (-1
// otherwise). No side effects: no backing read, no ref-bit touch (the
// fused fmmu_translate kernel does those).
//
// What bounds it here: launch latency. A batch carries tens to a few
// thousand lanes; each lane needs the W tags and valid bits of one set
// and, on a hit, one data word, so the kernel moves kilobytes.
//
// What the design does about it: one thread per lane, reading only what
// its lane needs straight from global memory (lanes of one set share
// the lines in L1/L2). Nothing is staged in shared memory: a stage of
// the whole CMT would make every block read all 74 KB of a paper-sized
// CMT (512 sets x 4 ways x 8 entries) to probe a few sets. The TPU kernel
// gathered the probe sets with one-hot f32 matmuls and compared tags in
// f32, which aliases block ids at and above 1<<24; here tags compare and
// values move as int32, so every id is exact. `//` and `mod` follow
// Python's floor rules, as jnp's do (an inactive lane with dlpn -1
// reports set S-1).
#include "common.cuh"

__global__ void fmmu_lookup_kernel(
    const int* __restrict__ tags, const uint8_t* __restrict__ valid,
    const int* __restrict__ data, const int* __restrict__ dlpns,
    uint8_t* __restrict__ hit_out, int* __restrict__ dppn_out,
    int* __restrict__ set_out, int* __restrict__ way_out, int n_sets,
    int n_ways, int n_entries, int n_lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int d = dlpns[lane];
  const int block_id = floor_div(d, n_entries);
  const int offset = floor_mod(d, n_entries);
  const int set = floor_mod(block_id, n_sets);
  int way = -1;
  for (int w = 0; w < n_ways; ++w) {
    const int i = set * n_ways + w;
    if (valid[i] && tags[i] == block_id) { way = w; break; }
  }
  const bool hit = d >= 0 && way >= 0;
  if (way < 0) way = 0;
  hit_out[lane] = hit ? 1 : 0;
  dppn_out[lane] =
      hit ? data[(set * n_ways + way) * n_entries + offset] : -1;
  set_out[lane] = set;
  way_out[lane] = way;
}

extern "C" int fmmu_lookup_launch(const void* tags, const void* valid,
                                  const void* data, const void* dlpns,
                                  void* hit, void* dppn, void* set,
                                  void* way, int n_sets, int n_ways,
                                  int n_entries, int n_lanes, void* stream) {
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  fmmu_lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)tags, (const uint8_t*)valid, (const int*)data,
      (const int*)dlpns, (uint8_t*)hit, (int*)dppn, (int*)set, (int*)way,
      n_sets, n_ways, n_entries, n_lanes);
  return (int)cudaGetLastError();
}
