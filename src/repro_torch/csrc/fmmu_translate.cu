// Fused FMMU translate probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fmmu_translate.py
// (`fmmu_translate`, body `_ft_kernel`): for every lane of a map commit,
// the CMT tag probe over the W ways of the lane's set, the cached DPPN
// on a hit, the backing-table entry on an active miss, NIL on an
// inactive lane, and the ref-bit touch of the hit way.
//
// What bounds it here: nothing but launch latency. A serving commit
// carries a few to a few hundred lanes; each lane needs the W tags and
// valid bits of one set and one data or backing word, so the kernel
// moves kilobytes; its floor is the ~2-4 us of one launch.
//
// What the design does about it: one launch does the whole probe side
// of a commit (the reference's single-probe invariant), one thread per
// lane, reading only what its lane needs straight from global memory
// (lanes of one set share the lines in L1/L2). Nothing is staged in
// shared memory: a stage of the whole CMT would make every block read
// all 74 KB of a paper-sized CMT (512 sets x 4 ways x 8 entries) to
// probe a few sets. Values are plain int32 loads: the TPU kernel's
// 16-bit-half gather (fmmu_lookup.gather16) worked around an f32-only
// matrix unit and has no reason to exist here, so host-tier ids at
// 1<<24 and above come out exact. `//` and `mod` follow Python's floor
// rules (an inactive lane with dlpn -1 reports set S-1, as jnp does),
// and the hit way is the FIRST matching way, as the reference's argmax.
// The ref-bit output is a copy of the input made by the wrapper; each
// touching hit lane stores 1 into it, and lanes that touch the same bit
// store the same value.
#include "common.cuh"

__global__ void fmmu_translate_kernel(
    const int* __restrict__ tags, const uint8_t* __restrict__ valid,
    const int* __restrict__ data, const int* __restrict__ backing,
    const int* __restrict__ dlpns, const uint8_t* __restrict__ touch,
    uint8_t* __restrict__ hit_out, int* __restrict__ dppn_out,
    int* __restrict__ set_out, int* __restrict__ way_out,
    uint8_t* __restrict__ ref_out, int n_sets, int n_ways, int n_entries,
    int n_backing, int n_lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int d = dlpns[lane];
  const bool active = d >= 0;
  const int block_id = floor_div(d, n_entries);
  const int offset = floor_mod(d, n_entries);
  const int set = floor_mod(block_id, n_sets);
  int way = -1;
  for (int w = 0; w < n_ways; ++w) {
    const int i = set * n_ways + w;
    if (valid[i] && tags[i] == block_id) { way = w; break; }
  }
  const bool hit = active && way >= 0;
  if (way < 0) way = 0;
  int out;
  if (hit) {
    out = data[(set * n_ways + way) * n_entries + offset];
  } else if (active) {
    out = backing[min(d, n_backing - 1)];
  } else {
    out = -1;
  }
  hit_out[lane] = hit ? 1 : 0;
  dppn_out[lane] = out;
  set_out[lane] = set;
  way_out[lane] = way;
  if (hit && touch[lane]) ref_out[set * n_ways + way] = 1;
}

extern "C" int fmmu_translate_launch(
    const void* tags, const void* valid, const void* data,
    const void* backing, const void* dlpns, const void* touch, void* hit,
    void* dppn, void* set, void* way, void* ref_out, int n_sets,
    int n_ways, int n_entries, int n_backing, int n_lanes, void* stream) {
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  fmmu_translate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)tags, (const uint8_t*)valid, (const int*)data,
      (const int*)backing, (const int*)dlpns, (const uint8_t*)touch,
      (uint8_t*)hit, (int*)dppn, (int*)set, (int*)way, (uint8_t*)ref_out,
      n_sets, n_ways, n_entries, n_backing, n_lanes);
  return (int)cudaGetLastError();
}
