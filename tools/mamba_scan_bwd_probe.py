#!/usr/bin/env python3
"""Where the bf16 scan backward (the tensor-core body of
src/repro_torch/csrc/mamba_scan_bwd.cu) spends its time, at mamba2-1.3b's
training shape (Bt=8, S=1024, H=64, P=64, N=128, no initial state):

    python3 tools/mamba_scan_bwd_probe.py [--variants kernel,no_mma,...]

Builds modified copies of the source into build/probe_bwd/ (the repo's
source is not touched) and calls them through the same C entry point as
the wrapper. Each variant is timed with chip_smoke.Timer, the
unmodified kernel first and last. Knock-outs drop one part of the
gradient block (`mamba_scan_bwd_grads`) or of the walk; their outputs
are then wrong, the time is what counts:

- no_dyS0, no_xG, no_GB, no_dyx, no_dx: one of the block's per-head
  products (dy S0, x G, B G^T, dy x^T, A1^T dy);
- no_mma: every product of the block (those five, C B^T and the
  group's A2 B and A2^T C): what is left is its scalar work, shared
  memory traffic, barriers and loads;
- no_state_loads: the block's loads of S0_c and G_c (zeros instead);
- no_walk_update, no_walk_store: the walk's product a chunk, its
  stores of the states;
- grads8: the gradient block with 8 warps instead of 16.

Then the unmodified call split by kernel (torch.profiler, device time a
launch) and the same timer around a one-element fill, the floor of any
timed launch. The anchors are literal lines of the source: edit them
together. Needs one CUDA card; prints the card's name and power limit
first, then one JSON line a variant.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "mamba_scan_bwd.cu"
OUT = ROOT / "build" / "probe_bwd"
BT, S, H, P, N = 8, 1024, 64, 64, 128

PRODUCTS = {
    "no_dyS0": "mma_tiles<NTN, false, false, 1, 2>(acc, dys, kTLDP",
    "no_xG": "mma_tiles<NTN, false, false, 1, 2>(acc, xs, kTLDP",
    "no_GB": "mma_tiles<NTP, false, true, 1, 2>(gb, bs,",
    "no_dyx": "mma_tiles<NTQ, false, true, 1, 1>(ra, dys,",
    "no_dx": "mma_tiles<NTP, true, false, 2, 1>(acc, a1s,",
}
OTHERS = ("mma_tiles<NTQ, false, true, 1, 1>(cb, cs,",
          "mma_tiles<NTN, false, false, 2, 1>(acc, a1s,",
          "mma_tiles<NTN, true, false, 2, 1>(acc, a1s,")
VARIANTS = {"kernel": []}
VARIANTS.update({k: [(v, "if (0) " + v)] for k, v in PRODUCTS.items()})
VARIANTS["no_mma"] = [(v, "if (0) " + v) for v in
                      tuple(PRODUCTS.values()) + OTHERS]
VARIANTS["no_state_loads"] = [
    (f"      {v}[i] = k4 < NF4 ? {p}[k4] : make_float4(0.f, 0.f, 0.f, 0.f);",
     f"      {v}[i] = make_float4(0.f, 0.f, 0.f, 0.f);")
    for v, p in (("vs", "sp"), ("vg", "gp"))]
VARIANTS["no_walk_update"] = [(
    "      mma_tiles<NTN, true, false, 2, 1>(m, vw,",
    "      if (0) mma_tiles<NTN, true, false, 2, 1>(m, vw,")]
VARIANTS["no_walk_store"] = [(
    "    // the value at this chunk's entry (walk) or end (adjoint) out\n"
    "    if (act) {",
    "    // the value at this chunk's entry (walk) or end (adjoint) out\n"
    "    if (act && S < 0) {")]
VARIANTS["grads8"] = [(
    "constexpr int kGW = 16, kGT = 32 * kGW",
    "constexpr int kGW = 8, kGT = 32 * kGW")]


def build(name: str, edits) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    src = SRC.read_text().replace('#include "common.cuh"',
                                  f'#include "{SRC.parent}/common.cuh"')
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: anchor not found once: {old!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{res.stdout[-3000:]}")
    lib = ctypes.CDLL(str(so))
    lib.mamba_scan_bwd_launch.argtypes = ([ctypes.c_void_p] * 17
                                          + [ctypes.c_int] * 6
                                          + [ctypes.c_void_p])
    lib.mamba_scan_bwd_workspace.argtypes = [ctypes.c_int] * 6
    lib.mamba_scan_bwd_workspace.restype = ctypes.c_longlong
    return lib


def caller(lib, args):
    """One backward call on the training shape's inputs, outputs and
    scratch allocated once."""
    x, dt, a, b, c, d, dy = args
    outs = [torch.empty_like(t) for t in (x, b, c, dt, a, d)]
    dx, db, dc, ddt, da, dd = outs
    ws = torch.empty(lib.mamba_scan_bwd_workspace(BT, S, H, P, N, 1) // 4,
                     device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.mamba_scan_bwd_launch(
            *(t.data_ptr() if t is not None else None for t in (
                x, dt, a, b, c, d, None, dy, None, dx, None, db, dc, ddt,
                da, dd, ws)), BT, S, H, P, N, 1, stream)
        if err:
            raise SystemExit(f"launch failed: {err}")
    return call


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    cs._setup()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    (x, dt, A, B, C, D, dy, _), _ = cs.scan_bwd_inputs(
        BT, S, H, P, N, torch.bfloat16, False)
    args = (x, dt, A, B, C, D, dy)
    timer = cs.Timer()
    names = a.variants.split(",")
    if "kernel" not in names:
        names = ["kernel"] + names
    libs = {n: build(n, VARIANTS[n]) for n in names}
    for n in names + ["kernel"]:
        print(json.dumps({"variant": n, "ms": timer.ms(caller(libs[n],
                                                              args))}),
              flush=True)
    from torch.profiler import ProfilerActivity, profile
    call = caller(libs["kernel"], args)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        m = re.search(r"(mamba_scan_bwd_\w+)", e.key)
        if m and e.device_time_total > 0:
            split[m.group(1)] = e.device_time_total / e.count / 1e3
    print(json.dumps({"split_ms": split}))
    tiny = torch.zeros(1, device="cuda")
    print(json.dumps({"one_element_fill_ms": timer.ms(tiny.zero_)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
