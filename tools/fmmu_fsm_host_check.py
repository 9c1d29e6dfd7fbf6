#!/usr/bin/env python3
"""Run the fmmu_fsm kernel's C++ on the CPU beside the plain engine:

    PYTHONPATH=src python3 tools/fmmu_fsm_host_check.py [--quick]

Builds ``src/repro_torch/csrc/fmmu_fsm.cu`` with g++ and ``-DFSM_SERIAL``
(the lane-parallel primitives as serial loops, page moves in line, one
thread; ``-DFSM_RING_MASK`` for each set of resident rings a case
takes) into ``build/host_check/``, against a stub ``common.cuh`` that
keeps the real one's floor_div and floor_mod. Then drives each geometry's
engines in lockstep, as ``tests/test_torch_cuda.py``'s ``_fsm_lockstep``
does on the card: the same pushes, one run a round (the serial body on
one state, ``engine.run`` on the other), flash reads answered in one
shuffled order, and every one of the 43 state tensors equal after every
run and after flush_all. The shared-memory buffer starts filled with a
marker, so a read of a word the entry did not load shows as a
difference. Also: a run cut every few steps, the rings resident for
every queue and for none, a queue head moved below slot 0. Needs g++;
no card, nothing of the package built. Prints one line a case; exits
nonzero on the first difference.
"""
from __future__ import annotations

import argparse
import ctypes
import random
import re
import subprocess
import sys
from collections import deque
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "host_check"

from repro_torch.core.fmmu import engine as E  # noqa: E402
from repro_torch.core.fmmu import state as S  # noqa: E402
from repro_torch.core.fmmu.types import (COND_UPDATE, LOAD, LOOKUP, NIL,  # noqa: E402
                                         UPDATE, FMMUGeometry, Request)
from repro_torch.kernels import fmmu_fsm as F  # noqa: E402

STUB = """#pragma once
#include <cstddef>
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
"""


def build(rings=F.RING_QUEUES) -> ctypes.CDLL:
    """The serial build with ``rings`` resident (FSM_RING_MASK)."""
    OUT.mkdir(parents=True, exist_ok=True)
    mask = sum(1 << q for q in rings)
    real = (CSRC / "common.cuh").read_text()
    helpers = re.findall(r"__device__ __forceinline__ int floor_(?:div|mod)"
                         r"\(.*?\n}\n", real, re.S)
    if len(helpers) != 2:
        raise SystemExit("floor_div / floor_mod not found in common.cuh")
    (OUT / "common.cuh").write_text(STUB + "\n".join(helpers))
    src = OUT / "fmmu_fsm.cu"
    src.write_text((CSRC / "fmmu_fsm.cu").read_text())
    so = OUT / f"libfmmu_fsm_serial_{mask}.so"
    res = subprocess.run(["g++", "-std=c++17", "-O1", "-DFSM_SERIAL",
                          f"-DFSM_RING_MASK={mask}", "-shared", "-fPIC",
                          "-x", "c++", str(src), "-o", str(so)],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"g++ failed:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    lib.fmmu_fsm_serial.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 2
    lib.fmmu_fsm_serial.restype = ctypes.c_int
    return lib


class Serial:
    """The serial build of the kernel on a CPU engine's state."""

    def __init__(self, libs, g, rings):
        self.lib, self.g, self.rings = libs[rings], g, rings
        self.smem = np.empty(F.smem_bytes(g, rings) // 4 + 4, np.int32)

    def call(self, st, mode, max_steps=0, auto_flash=False) -> int:
        out = torch.zeros(1, dtype=torch.int32)
        ptrs = (ctypes.c_void_p * len(st))(*(t.data_ptr() for t in st))
        self.smem.fill(0x5EED5EED)
        err = self.lib.fmmu_fsm_serial(
            ptrs, F._geom(self.g, self.rings), mode, int(max_steps),
            int(bool(auto_flash)), out.data_ptr(), self.smem.ctypes.data)
        if err:
            raise SystemExit(f"fmmu_fsm_serial refused the call ({err})")
        return int(out[0])


def requests(g, seed, n):
    rng = random.Random(seed)
    pages = g.n_tvpns * g.entries_per_tp
    last, reqs = {}, []
    for rid in range(n):
        d, u, v = rng.randrange(pages), rng.random(), rng.randrange(1 << 20)
        if u < 0.1:
            old = last.get(d, NIL) if rng.random() < 0.5 else v + 1
            reqs.append(Request(COND_UPDATE, d, v, old, rid, 1))
        elif u < 0.775:
            last[d] = v
            reqs.append(Request(UPDATE, d, v, NIL, rid, 0))
        else:
            reqs.append(Request(LOOKUP, d, NIL, NIL, rid, 0))
    return reqs


def equal(a, b, tag):
    for name, x, y in zip(S.FMMUState._fields, a.state, b.state):
        if not torch.equal(x, y):
            diff = (x != y).nonzero()[:4].tolist()
            raise SystemExit(f"FAIL {tag}: {name} differs at {diff}")


def flush_all(eng, ser):
    """FMMUEngine.flush_all with the serial body's modes 1 and 2."""
    st = eng.state
    for _ in range(1000):
        dtl_left = bool((st.dtl_tvpn != NIL).any())
        fifo_left = int(st.fifo_tail - st.fifo_head) > 0
        if not (dtl_left or fifo_left or eng.pending_work()):
            break
        if dtl_left:
            ser.call(st, F.MODE_FLUSH_ONE)
        ser.call(st, F.MODE_RUN, 100_000, True)
        while int(st.fifo_tail - st.fifo_head) > 0:
            if not ser.call(st, F.MODE_WB):
                break
        ser.call(st, F.MODE_RUN, 100_000, True)


def lockstep(lib, g, reqs, seed, outstanding, rings=F.RING_QUEUES,
             max_steps=100_000, setup=None):
    ser = Serial(lib, g, rings)
    kern, ref = E.FMMUEngine(g, device="cpu"), E.FMMUEngine(g, device="cpu")
    if setup is not None:
        setup(kern.state)
        setup(ref.state)
    rng, pend, out, rounds, steps = random.Random(seed), deque(reqs), 0, 0, 0
    while True:
        batch = [pend.popleft() for _ in range(min(len(pend),
                                                   outstanding - out))]
        out += len(batch)
        kern.push_requests(batch)
        ref.push_requests(batch)
        n_k = ser.call(kern.state, F.MODE_RUN, max_steps)
        n_r = E.run(g, ref.state, max_steps)
        if n_k != n_r:
            raise SystemExit(f"FAIL round {rounds}: steps {n_k} != {n_r}")
        steps += n_k
        equal(kern, ref, f"round {rounds}")
        dk, dr = kern.drain_outputs(), ref.drain_outputs()
        if dk != dr:
            raise SystemExit(f"FAIL round {rounds}: drained outputs differ")
        resps, fcs, _ = dk
        out -= len(resps)
        fcs = list(fcs)
        rng.shuffle(fcs)
        kern.push_flash_responses(fcs)
        ref.push_flash_responses(fcs)
        rounds += 1
        if not pend and not kern.pending_work() and not fcs:
            break
    flush_all(kern, ser)
    ref.flush_all()
    equal(kern, ref, "flush_all")
    if ser.call(kern.state, F.MODE_RUN, 0) != 0:
        raise SystemExit("FAIL: max_steps 0 took a step")
    equal(kern, ref, "max_steps 0")
    return rounds, steps, dict(zip(S.STAT_NAMES, kern.state.stats.tolist()))


GEOMS = {
    "small": dict(cmt_sets=4, cmt_ways=2, cmt_entries=4, ctp_sets=2,
                  ctp_ways=2, entries_per_tp=16, n_tvpns=8, dtl_entries=4,
                  queue_cap=2048, mshr_cap=4, ctp_mshr_cap=4, tppn_cap=4096),
    "small_tppn_overflow": dict(cmt_sets=4, cmt_ways=2, cmt_entries=4,
                                ctp_sets=2, ctp_ways=2, entries_per_tp=16,
                                n_tvpns=8, dtl_entries=4, queue_cap=2048,
                                mshr_cap=2, ctp_mshr_cap=2, tppn_cap=8),
    "divisors": dict(cmt_sets=6, cmt_ways=3, cmt_entries=4, ctp_sets=3,
                     ctp_ways=3, entries_per_tp=12, n_tvpns=5,
                     dtl_entries=5, queue_cap=1000, mshr_cap=3,
                     ctp_mshr_cap=3),
    "wide": dict(cmt_sets=8, cmt_ways=32, cmt_entries=32, ctp_sets=2,
                 ctp_ways=32, entries_per_tp=64, n_tvpns=40, dtl_entries=70,
                 queue_cap=512, mshr_cap=32, ctp_mshr_cap=40, tppn_cap=300),
    "tiny_queues": dict(cmt_sets=4, cmt_ways=2, cmt_entries=4, ctp_sets=2,
                        ctp_ways=2, entries_per_tp=16, n_tvpns=8,
                        dtl_entries=4, queue_cap=40, mshr_cap=4,
                        ctp_mshr_cap=4, tppn_cap=4096),
    "paper": {},
}
# (geometry, requests, outstanding, rings, max_steps a run)
CASES = [("small", 600, 64, F.RING_QUEUES, 100_000),
         ("small", 400, 64, (), 100_000),
         ("small", 400, 64, (0, 1, 2, 3, 4), 7),
         ("small_tppn_overflow", 300, 16, F.RING_QUEUES, 100_000),
         ("divisors", 500, 40, F.RING_QUEUES, 100_000),
         ("divisors", 300, 40, (0, 1, 2, 3, 4), 5),
         ("wide", 600, 100, F.RING_QUEUES, 100_000),
         ("tiny_queues", 300, 20, (0, 1, 2, 3, 4), 100_000),
         ("tiny_queues", 300, 20, F.RING_QUEUES, 3),
         ("paper", 300, 300, F.RING_QUEUES, 100_000)]


def head_below_zero(st):
    """A LOAD re-inserted at the head of an empty CTP_REQ queue at slot
    0: the head moves to -1, the ring's live window starts below 0."""
    E._qpush_front(st, S.Q_CTP_REQ,
                   [LOAD, 1, 0, 0, NIL] + [NIL] * (st.qbuf.shape[2] - 5))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="skip the paper geometry")
    a = ap.parse_args(argv)
    lib = {r: build(r) for r in {c[3] for c in CASES}}
    for name, n, outstanding, rings, max_steps in CASES:
        if a.quick and name == "paper":
            continue
        g = FMMUGeometry(**GEOMS[name])
        rounds, steps, stats = lockstep(lib, g, requests(g, 1, n), 2,
                                        outstanding, rings, max_steps)
        print(f"OK {name} rings={rings} max_steps={max_steps}: {rounds} "
              f"rounds, {steps} steps, {stats}", flush=True)
    g = FMMUGeometry(**GEOMS["small"])
    lockstep(lib, g, requests(g, 3, 200), 4, 32, setup=head_below_zero)
    print("OK small, a head below slot 0", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
