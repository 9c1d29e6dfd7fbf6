#!/usr/bin/env python3
"""Where a step of the fmmu_fsm kernel spends its cycles, on the smoke's
timed run calls (chip_smoke.check_fmmu_fsm's: the paper geometry, from
round FSM_SNAPSHOT_ROUND of the miss-heavy and of the hit-heavy trace):

    python3 tools/fmmu_fsm_probe.py
    python3 tools/fmmu_fsm_probe.py --segments

Builds modified copies of src/repro_torch/csrc/fmmu_fsm.cu (the kernel)
and tools/fmmu_fsm_first_version.cu (its first version) into
build/probe/ (the sources are not touched) with clock64() stamps around
every step of the run loop, taken by the thread that runs the machine.
Each step is put in one class by what it did (the first that applies):
stall, fill (a page filled: a flash response, or a miss on an unmapped
TVPN), write-back (a program), DTL flush, MSHR merge, CTP miss, CTP hit,
CMT miss, CMT hit, LOAD_RESP (a CMT fill with no stat of its own),
idle/blocked (the step that ends the run). Prints each class's count and
mean cycles for the first version, the kernel, and the kernel with no
queue ring resident (the same source built with -DFSM_RING_MASK=0 and
launched at ``fmmu_fsm._geom(g, rings=())``), and each version's phases: entry
(loading the resident state), the run loop, the exit's last page move
and register save, and the state written back. Then the unmodified kernel timed with and
without the resident rings, beside the first version, in turns
(chip_smoke's timer). Stamps and their stats reads cost cycles of their
own, so class means are upper bounds; the unmodified times are the
times.

--segments: the kernel alone, with stamps inside a step (SEGMENTS):
the cycles from the step's start to the arbitration's end, to the pop,
to the CMT way probe, to a stall's decision, and to the step's end, each
summed over the steps that pass it (a stamp re-reads the clock after
its own bookkeeping). Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "probe"
CLASSES = ("stall", "fill", "write-back", "DTL flush", "MSHR merge",
           "CTP miss", "CTP hit", "CMT miss", "CMT hit", "LOAD_RESP",
           "idle/blocked")
PHASES = ("entry", "run loop", "exit: last page move, registers saved",
          "exit: state written back")
SEGMENTS = ("start -> arbitrated", "-> popped", "-> CMT way probed",
            "-> stall decided", "-> step end")

GLOBALS = r'''
__device__ unsigned long long g_probe[16][2];
__device__ long long g_phase[4];
// the step's class from its stat deltas (S_* order), fill flag and code
__device__ __forceinline__ int probe_class(int hit, int miss, int merge,
                                           int stall, int ftv, int prog,
                                           int chit, int cmiss, int fill,
                                           bool worked) {
  if (!worked) return 10;
  if (stall) return 0;
  if (fill) return 1;
  if (prog) return 2;
  if (ftv) return 3;
  if (merge) return 4;
  if (cmiss) return 5;
  if (chit) return 6;
  if (miss) return 7;
  if (hit) return 8;
  return 9;
}
#define PROBE_RECORD(D, FILL, WORKED, T0)                                  \
  {                                                                       \
    const int c = probe_class(D(0), D(1), D(2), D(3), D(4), D(7), D(9),   \
                              D(10), FILL, WORKED);                       \
    const long long dt = clock64() - (T0);                                \
    g_probe[c][0] += 1;                                                   \
    g_probe[c][1] += dt;                                                  \
  }
'''
TAIL = r'''
extern "C" int probe_reset() {
  static unsigned long long z[16][2];
  static long long zp[4];
  int e = (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
  return e ? e : (int)cudaMemcpyToSymbol(g_phase, zp, sizeof(zp));
}
extern "C" int probe_read(void* probe, void* phase) {
  int e = (int)cudaMemcpyFromSymbol(probe, g_probe, sizeof(g_probe));
  return e ? e : (int)cudaMemcpyFromSymbol(phase, g_phase, sizeof(g_phase));
}
'''
SEG = r'''
__device__ unsigned long long g_seg[8][2];
#define PSEG(k)                                                           \
  if (lane == 0) {                                                        \
    const long long now_ = clock64();                                     \
    g_seg[k][0] += 1;                                                     \
    g_seg[k][1] += now_ - p_last;                                         \
    p_last = clock64();                                                   \
  }
extern "C" int probe_segments(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_seg, sizeof(g_seg));
}
extern "C" int probe_segments_reset() {
  static unsigned long long z[8][2];
  return (int)cudaMemcpyToSymbol(g_seg, z, sizeof(z));
}
'''
# (anchor, replacement) pairs: each anchor must occur once
SEGMENT_EDITS = [
    ("#include \"common.cuh\"\n", "#include \"common.cuh\"\n" + SEG),
    ("  int wb_pending, wb_block;\n",
     "  int wb_pending, wb_block;\n  long long p_last;\n"),
    ("      const bool worked = step() == WORKED;\n",
     "      p_last = clock64();\n      const bool worked = step() == WORKED;\n"),
    ("    const int qid = arbitrate(picked);\n",
     "    const int qid = arbitrate(picked);\n    PSEG(0)\n"),
    ("    return Pkt{p, p[0], p[1], p[2], p[3], p[4]};\n",
     "    const Pkt popped{p, p[0], p[1], p[2], p[3], p[4]};\n    PSEG(1)\n"
     "    return popped;\n"),
    ("    const int mk = kind == LOOKUP ? M_LOOKUP\n",
     "    PSEG(2)\n    const int mk = kind == LOOKUP ? M_LOOKUP\n"),
    ("    bump(S_STALL);\n    stalls += 1;\n    qpush<Q>",
     "    bump(S_STALL);\n    PSEG(3)\n    stalls += 1;\n    qpush<Q>"),
    ("    bump(S_STALL);\n    stalls += 1;\n    const int h",
     "    bump(S_STALL);\n    PSEG(3)\n    stalls += 1;\n    const int h"),
    ("    if (stalls == before) stalls = 0;\n    return WORKED;\n",
     "    if (stalls == before) stalls = 0;\n    PSEG(4)\n    return WORKED;\n"),
]
KERNEL_EDITS = [
    ("#include \"common.cuh\"\n", "#include \"common.cuh\"\n" + GLOBALS),
    ("  int wb_pending, wb_block;\n",
     "  int wb_pending, wb_block;\n  int probe_fill;\n"),
    ("    for (int i = 0; i < S_COUNT; ++i) st[i] = k[K_STATS + i];\n",
     "    for (int i = 0; i < S_COUNT; ++i) st[i] = k[K_STATS + i];\n"
     "    probe_fill = 0;\n"),
    ("    send(OP_FILL, b, src);\n",
     "    probe_fill = 1;\n    send(OP_FILL, b, src);\n"),
    ("      const bool worked = step() == WORKED;\n",
     "      const long long p_t0 = clock64();\n"
     "      int p_st[S_COUNT];\n#pragma unroll\n"
     "      for (int i = 0; i < S_COUNT; ++i) p_st[i] = st[i];\n"
     "      probe_fill = 0;\n"
     "      const bool worked = step() == WORKED;\n"
     "#define D(i) (st[i] - p_st[i])\n"
     "      if (lane == 0) PROBE_RECORD(D, probe_fill, worked, p_t0)\n"
     "#undef D\n"),
    ("  move_state(S, G, sm, true, t, nt);\n  block_sync();\n",
     "  const long long p0 = clock64();\n"
     "  move_state(S, G, sm, true, t, nt);\n  block_sync();\n"
     "  const long long p1 = clock64();\n  long long p2 = p1;\n"),
    ("    m.finish();\n", "    p2 = clock64();\n    m.finish();\n"),
    ("  block_sync();\n  move_state(S, G, sm, false, t, nt);\n}\n",
     "  block_sync();\n  const long long p3 = clock64();\n"
     "  move_state(S, G, sm, false, t, nt);\n"
     "  block_sync();\n  if (t == 0) {\n    g_phase[0] += p1 - p0;\n"
     "    g_phase[1] += p2 - p1;\n    g_phase[2] += p3 - p2;\n"
     "    g_phase[3] += clock64() - p3;\n  }\n}\n"),
]
FIRST_EDITS = [
    ("#include \"common.cuh\"\n", "#include \"common.cuh\"\n" + GLOBALS),
    ("  int n = 0, before = 0;\n",
     "  int n = 0, before = 0;\n  long long p_t0 = 0;\n  int p_st[11];\n"
     "  bool p_worked = false;\n  const long long p_start = clock64();\n"),
    ("      m.W = Wide{0, 0, 0, 0, 0, 0, 0, 0};\n",
     "      m.W = Wide{0, 0, 0, 0, 0, 0, 0, 0};\n      p_t0 = clock64();\n"
     "      for (int i = 0; i < 11; ++i) p_st[i] = S.stats[i];\n"),
    ("        const bool worked = m.step(before) == WORKED;\n",
     "        const bool worked = m.step(before) == WORKED;\n"
     "        p_worked = worked;\n"),
    ("    __syncthreads();\n    if (!cont) break;\n",
     "    __syncthreads();\n"
     "#define D(i) (S.stats[i] - p_st[i])\n"
     "    if (threadIdx.x == 0 && mode == 0)\n"
     "      PROBE_RECORD(D, w.fill, p_worked, p_t0)\n#undef D\n"
     "    if (!cont) break;\n"),
    ("  if (threadIdx.x == 0 && mode == 0) out[0] = n;\n",
     "  if (threadIdx.x == 0 && mode == 0) out[0] = n;\n"
     "  if (threadIdx.x == 0) g_phase[1] += clock64() - p_start;\n"),
]


def build(name: str, src: Path, edits, tail=TAIL,
          rings=None) -> ctypes.CDLL:
    from repro_torch.kernels import _build, fmmu_fsm
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: anchor not found once: {old!r}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(text + tail)
    mask = [] if rings is None else [
        f"-DFSM_RING_MASK={sum(1 << q for q in rings)}"]
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *mask, "-I",
                          str(CSRC), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{res.stdout[-3000:]}")
    lib = ctypes.CDLL(str(so))
    lib.fmmu_fsm_launch.argtypes = fmmu_fsm._ARGTYPES
    lib.fmmu_fsm_launch.restype = ctypes.c_int
    if tail == TAIL:
        lib.probe_read.argtypes = [ctypes.c_void_p] * 2
    return lib


def caller(lib, g, rings):
    """A run call of ``lib``'s kernel at the layout with ``rings``."""
    from repro_torch.kernels import _build, fmmu_fsm

    def call(st):
        out = torch.zeros(1, dtype=torch.int32, device="cuda")
        ptrs = (ctypes.c_void_p * len(st))(*(t.data_ptr() for t in st))
        err = lib.fmmu_fsm_launch(ptrs, fmmu_fsm._geom(g, rings),
                                  fmmu_fsm.MODE_RUN, 1_000_000, 0,
                                  out.data_ptr(), _build.stream_ptr(out))
        if err:
            raise SystemExit(f"launch failed ({err})")
        return out[0]
    return call


def segments(cs, g, timer) -> None:
    from repro_torch.kernels import fmmu_fsm
    lib = build("segments", CSRC / "fmmu_fsm.cu", SEGMENT_EDITS, tail="")
    for trace in ("miss_heavy", "hit_heavy"):
        base = cs.fsm_snapshot(g, trace)
        call = caller(lib, g, fmmu_fsm.RING_QUEUES)
        cs._fsm_timed_run(timer, base, call, 1)
        if lib.probe_segments_reset():
            raise SystemExit("could not reset the segments")
        ms, steps, _ = cs._fsm_timed_run(timer, base, call, 1)
        seg = np.zeros((8, 2), np.uint64)
        if lib.probe_segments(seg.ctypes.data):
            raise SystemExit("could not read the segments")
        print(json.dumps({"trace": trace, "steps": steps, "probe_ms": ms,
                          "segments": {
                              name: {"count": int(seg[i, 0]),
                                     "mean_cycles": float(seg[i, 1]) /
                                     max(int(seg[i, 0]), 1)}
                              for i, name in enumerate(SEGMENTS)}}),
              flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segments", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.fmmu.types import FMMUGeometry
    from repro_torch.kernels import _build, fmmu_fsm
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    g = FMMUGeometry()
    timer = cs.Timer()
    if a.segments:
        segments(cs, g, timer)
        return 0
    libs = {"first_version": build("first_version", cs.FSM_FIRST_VERSION,
                                   FIRST_EDITS),
            "kernel": build("kernel", CSRC / "fmmu_fsm.cu", KERNEL_EDITS),
            "kernel_no_rings": build("kernel_no_rings", CSRC / "fmmu_fsm.cu",
                                     KERNEL_EDITS, rings=())}
    plain = {"kernel": _build.load("fmmu_fsm", fmmu_fsm._ARGTYPES),
             "kernel_no_rings": build("plain_no_rings",
                                      CSRC / "fmmu_fsm.cu", [], tail="",
                                      rings=()),
             "first_version": cs.fsm_first_version()}
    variants = (("first_version", "first_version", fmmu_fsm.RING_QUEUES),
                ("kernel", "kernel", fmmu_fsm.RING_QUEUES),
                ("kernel_no_rings", "kernel_no_rings", ()))
    for trace in ("miss_heavy", "hit_heavy"):
        base = cs.fsm_snapshot(g, trace)
        ends = {}
        for tag, lib, rings in variants:
            cs._fsm_timed_run(timer, base, caller(libs[lib], g, rings), 1)
            if libs[lib].probe_reset():
                raise SystemExit("could not reset the probe")
            ms, steps, end = cs._fsm_timed_run(
                timer, base, caller(libs[lib], g, rings), 1)
            ends[tag] = end
            probe = np.zeros((16, 2), np.uint64)
            phase = np.zeros(4, np.int64)
            if libs[lib].probe_read(probe.ctypes.data, phase.ctypes.data):
                raise SystemExit("could not read the probe")
            cyc = int(phase.sum())
            print(json.dumps({
                "trace": trace, "variant": tag, "steps": steps,
                "probe_ms": ms, "cycles": cyc,
                "cycles_per_step": cyc / steps,
                "cycles_per_ns": cyc / (ms * 1e6),
                "phases": dict(zip(PHASES, phase.tolist())),
                "classes": {c: {"count": int(probe[i, 0]),
                                "mean_cycles": float(probe[i, 1])
                                / max(int(probe[i, 0]), 1)}
                            for i, c in enumerate(CLASSES)}}), flush=True)
        for tag, end in ends.items():
            if any(not torch.equal(x, y) for x, y in zip(end,
                                                         ends["kernel"])):
                raise SystemExit(f"{trace}: {tag}'s end state differs")
        # the unmodified kernels, in turns
        calls = {tag: caller(plain[tag], g, rings)
                 for tag, _, rings in variants}
        times = {k: [] for k in calls}
        for _ in range(5):
            for k, call in calls.items():
                times[k].append(cs._fsm_timed_run(timer, base, call, 1)[0])
        print(json.dumps({"trace": trace, "steps": steps, "ms": {
            k: statistics.median(v) for k, v in times.items()},
            "ms_each": times, "smem_bytes": {
                "kernel": fmmu_fsm.smem_bytes(g),
                "kernel_no_rings": fmmu_fsm.smem_bytes(g, rings=())}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
