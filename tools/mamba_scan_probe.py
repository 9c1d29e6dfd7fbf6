#!/usr/bin/env python3
"""Where the bf16 mamba_chunk_scan kernel spends its time, at mamba2-1.3b's
prefill shape (Bt=1, S=1024, H=64, P=64, N=128):

    python3 tools/mamba_scan_probe.py            # variants, S sweep
    python3 tools/mamba_scan_probe.py --trace    # per-phase cycle stamps

Both build modified copies of src/repro_torch/csrc/mamba_scan.cu into
build/probe/ (the repo's source is not touched) and call them through
the same C entry point as the wrapper.

Variants, each timed with chip_smoke.Timer beside the unmodified kernel:
other launch plans ("rows16": 16 rows of P a block, 256 blocks; "q64":
chunks of 64 tokens and four warps), and knock-outs, which drop one part
of the tensor-core body's chunk loop (their outputs are then wrong; the
time is what counts): the G = C B^T products, the C S^T products, the
state update, the y stores, the lo halves of the three hi + lo
operands, and all of the large products at once ("skeleton": what is
left is the loop's scalar work, barriers and loads). Then the kernel at
S = 128 .. 1024, for the time a chunk of the dependent chain adds, and
the same timer around a one-element fill, the floor of any timed
launch.

--trace: clock64() stamps at the phase boundaries of every warp of one
block, averaged over the chunks: the chunk period and each phase's
cycles (issue time, so a phase also holds the time its warp waited for
the scheduler it shares). Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "mamba_scan.cu"
OUT = ROOT / "build" / "probe"
H, P, N, S = 64, 64, 128, 1024

Y_OFF = ("    for (int s = 0; s < NKS; ++s) {\n#pragma unroll\n"
         "      for (int pp = 0; pp < NPT / 2; ++pp) {")
G_LOOP = ("      for (int s = 0; s < NKS; ++s) {\n#pragma unroll\n"
          "        for (int jh = 0; jh < 2; ++jh) {")
STATE = "    for (int jp = 0; jp < Q / 16; ++jp) {"
GL = ("          M::run(yd[1][2 * pp], gl, bb[0], bb[1]);\n"
      "          M::run(yd[1][2 * pp + 1], gl, bb[2], bb[3]);\n")
SL = ("        M::run(sl[2 * np], af[1], bb[0], bb[1]);\n"
      "        M::run(sl[2 * np + 1], af[1], bb[2], bb[3]);\n")
VARIANTS = {
    "kernel": [],
    "no_G": [(G_LOOP, G_LOOP.replace("s < NKS", "s < 0"))],
    "no_CS": [(Y_OFF, Y_OFF.replace("s < NKS", "s < 0"))],
    "no_state_update": [(STATE, STATE.replace("jp < Q / 16", "jp < 0"))],
    "no_y_store": [("    const int nrow = min(Q, S - t0);",
                    "    const int nrow = 0;")],
    "no_lo_Gx": [(GL, "")],
    "no_lo_CS": [("part < 2; ++part) {    // S = hi + lo",
                  "part < 1; ++part) {    // S = hi + lo")],
    "no_lo_state": [(SL, "")],
    "rows16": [("return launch_tc<128, 32, 128>(REPRO_SCAN_ARGS);",
                "return launch_tc<128, 16, 128>(REPRO_SCAN_ARGS);")],
    "q64": [("return launch_tc<128, 32, 128>(REPRO_SCAN_ARGS);",
             "return launch_tc<128, 32, 64>(REPRO_SCAN_ARGS);")],
}
VARIANTS["skeleton"] = (VARIANTS["no_G"] + VARIANTS["no_CS"]
                        + VARIANTS["no_state_update"])

# --trace: a stamp at each phase boundary, block (0, 0, 0), lane 0
STAMP = ("if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && "
         "lane == 0) g_stamp[warp][c][{k}] = clock64();\n")
MARKS = [  # (anchor, stamp index, before / after the anchor)
    ("    __syncthreads();     // chunk c and S landed; chunk c-1 fully "
     "read\n", 0, "after"),
    ("    if (next) load_chunk(c + 1, st ^ 1);\n", 1, "after"),
    ("    __syncwarp();\n", 2, "after"),
    ("    // the intra-chunk term, 32 tokens j at a time", 3, "before"),
    ("    if (next) load_bc(c + 1, st ^ 1, 2);", 4, "before"),
    ("    __syncthreads();     // xw and the y tile written; S's copy "
     "read\n", 5, "before"),
    ("    __syncthreads();     // xw and the y tile written; S's copy "
     "read\n", 6, "after"),
    ("    // this chunk's y rows out", 7, "before"),
]
PHASES = ["load issue", "prefix sums", "C S^T", "G and G x", "epilogue + xw",
          "barrier 2", "state update", "y store"]


def build(name: str, edits, trace=False) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    src = SRC.read_text().replace('#include "common.cuh"',
                                  f'#include "{SRC.parent}/common.cuh"')
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: anchor not found once: {old!r}")
        src = src.replace(old, new)
    if trace:
        src = src.replace("#include", "__device__ long long "
                          "g_stamp[16][64][9];\n#include", 1)
        for old, k, where in MARKS:
            stamp = "    " + STAMP.format(k=k)
            src = src.replace(old, old + stamp if where == "after"
                              else stamp + old, 1)
        end = ("  }\n\n#pragma unroll\n  for (int j = 0; j < NTW; ++j) {\n"
               "#pragma unroll\n    for (int hi = 0; hi < 2; ++hi) {\n"
               "      const int p = p0")
        if src.count(end) != 1:
            raise SystemExit("trace: loop end not found")
        src = src.replace(end, "    " + STAMP.format(k=8) + end)
        src += ("\nextern \"C\" int probe_stamps(void* dst) {\n  return "
                "(int)cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp));"
                "\n}\n")
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{res.stdout[-3000:]}")
    lib = ctypes.CDLL(str(so))
    lib.mamba_scan_launch.argtypes = ([ctypes.c_void_p] * 9
                                      + [ctypes.c_int] * 6
                                      + [ctypes.c_void_p])
    return lib


def inputs(S=S):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, S, H, P), generator=g, device="cuda").bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn((1, S, H), generator=g, device="cuda") - 4.0)
    a = -torch.rand((H,), generator=g, device="cuda") * 15 - 1
    b = torch.randn((1, S, N), generator=g, device="cuda").bfloat16()
    c = torch.randn((1, S, N), generator=g, device="cuda").bfloat16()
    d = torch.ones((H,), device="cuda")
    s0 = torch.randn((1, H, P, N), generator=g, device="cuda")
    return x, dt, a, b, c, d, s0


def caller(lib, args):
    x, dt, a, b, c, d, s0 = args
    s = x.shape[1]
    y, fin = torch.empty_like(x), torch.empty_like(s0)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.mamba_scan_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d.data_ptr(), s0.data_ptr(), y.data_ptr(),
            fin.data_ptr(), 1, s, H, P, N, 1, stream)
        if err:
            raise SystemExit(f"launch failed: {err}")
    return call


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    args = inputs()
    if a.trace:
        lib = build("trace", [], trace=True)
        lib.probe_stamps.argtypes = [ctypes.c_void_p]
        call = caller(lib, args)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        buf = np.zeros((16, 64, 9), np.int64)
        if lib.probe_stamps(buf.ctypes.data):
            raise SystemExit("could not read the stamps")
        nch, warps = S // 128, 8
        t = buf[:warps, :nch].astype(np.float64)
        period = np.diff(t[:, :, 0], axis=1).mean()
        dur = np.diff(t, axis=2)[:, 1:].mean(axis=1)   # skip chunk 0
        print(json.dumps({"chunk_period_cycles": period, "chunks": nch,
                          "phase_cycles_per_warp": {
                              f"warp {w}": dict(zip(PHASES, dur[w].round()
                                                    .tolist()))
                              for w in range(warps)}}))
        return 0
    timer = cs.Timer()
    names = a.variants.split(",")
    libs = {n: build(n, VARIANTS[n]) for n in names}
    for n in names:
        print(json.dumps({"variant": n, "ms": timer.ms(caller(libs[n],
                                                              args))}),
              flush=True)
    lib = libs.get("kernel") or build("kernel", [])
    for s in (128, 256, 512, 1024):
        print(json.dumps({"S": s, "chunks": s // 128,
                          "ms": timer.ms(caller(lib, inputs(s)))}),
              flush=True)
    tiny = torch.zeros(1, device="cuda")
    print(json.dumps({"one_element_fill_ms": timer.ms(tiny.zero_)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
