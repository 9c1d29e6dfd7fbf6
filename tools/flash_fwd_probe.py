#!/usr/bin/env python3
"""Where the flash forward's head_dim 256 body spends its time, and what
other launch plans would give:

    python3 tools/flash_fwd_probe.py [--variants a,b+c,...]

Builds modified copies of src/repro_torch/csrc/flash_attention.cu into
build/probe/ (the repo's source is not touched; the copies are patched
at literal lines of the source, so edit the anchors below with it) and
calls each through the same C entry point as the wrapper, bf16, at
three shapes: gemma2-9b's prefill at S 1000 (B=1 H=16 KV=8, causal,
window 4096, softcap 50: chip_smoke's ``ms_d256_bf16``), its packed
training shape (B=8 S=1024, make_batch step 0's ids, softcap 50) and
S 6144 with the window binding. Each variant is timed with
chip_smoke.Timer beside the unmodified kernel ("kernel", timed again
last for the drift), and its output held against ``attention_lse``
(a knock-out's error is then large: its time is what counts).

Variants, combined with "+" (e.g. "s_no_mma+trace"):
- knock-outs: "s_no_mma" without Q K^T's products (its reads stay),
  "no_pv" without P V;
- "trace": clock64() stamps of each warp of block (0, 0, 0) at the
  phase boundaries of its heaviest q tile, printed as mean cycles a
  tile by phase and warp.
Prints the card's name and power limit, the registers and spill bytes
of each variant's 8 head_dim 256 instantiations, and one JSON line a
shape (and a variant's trace). Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "probe"

# anchors: literal lines of the wide body
S_MMA = ("          Mma<T>::run(sc[2 * np], a, bb[0], bb[1]);\n"
         "          Mma<T>::run(sc[2 * np + 1], a, bb[2], bb[3]);\n")
PV_LOOP = ("      for (int s = 0; s < BK / 16; ++s) {\n"
           "        uint32_t a[4];\n")
LOGITS = "      // the logits (log2 units) and this half's row maxima\n"
PV_END = "      kt = nxt;\n    }\n\n    // the row sums"
SYNC_MAX = "      __syncthreads();   // both halves' maxima\n"
SYNC_P = "      __syncthreads();   // the tile's P staged\n"

# --trace: stamps of every warp of block (0, 0, 0), rep 0 (its heaviest
# q tile), at the boundaries of PHASES
STAMP = ("      if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && "
         "lane == 0 && rep == 0 && it < 64) g_stamp[warp][it][{k}] = "
         "clock64();\n")
TRACE = [
    ('#include "common.cuh"\n',
     '#include "common.cuh"\n__device__ long long g_stamp[8][64][8];\n'),
    ("    for (int st = 0; kt <= range.hi; st ^= 1) {\n"
     "      cp_async_wait<0>();\n",
     "    int it = 0;\n    for (int st = 0; kt <= range.hi; st ^= 1, ++it) {\n"
     + STAMP.format(k=0) + "      cp_async_wait<0>();\n"),
    ("      __syncthreads();\n      const int nxt =\n",
     "      __syncthreads();\n" + STAMP.format(k=1) +
     "      const int nxt =\n"),
    ("      const int* skt = sks + st * BK;\n",
     "      const int* skt = sks + st * BK;\n" + STAMP.format(k=2)),
    (LOGITS, STAMP.format(k=3) + "      // the logits (log2 units)\n"),
    (SYNC_MAX, STAMP.format(k=4) + "      __syncthreads();\n" +
     STAMP.format(k=5)),
    (SYNC_P, "      __syncthreads();\n" + STAMP.format(k=6)),
    (PV_END, STAMP.format(k=7) + PV_END),
]
TRACE_END = (
    'extern "C" int flash_probe_stamps(long long* host, int reset) {\n'
    "  if (reset) {\n"
    "    void* p;\n"
    "    cudaGetSymbolAddress(&p, g_stamp);\n"
    "    return (int)cudaMemset(p, 0, sizeof(g_stamp));\n"
    "  }\n"
    "  return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));\n"
    "}\n")
PHASES = ("wait_and_top_barrier", "walk_and_prefetch", "S", "logits_and_max",
          "barrier_maxima", "P_and_barrier", "PV")

VARIANTS = {
    "kernel": [],
    "s_no_mma": [(S_MMA, "")],
    "no_pv": [(PV_LOOP, PV_LOOP.replace("s < BK / 16", "s < 0"))],
    "trace": TRACE,
}
# (tag, B, S, H, KV, mask options, ids)
SHAPES = (("s1000", 1, 1000, 16, 8, dict(window=4096, softcap=50.0), False),
          ("train", 8, 1024, 16, 8, dict(softcap=50.0), True),
          ("s6144", 1, 6144, 16, 8, dict(window=4096, softcap=50.0), False))


def patched(name) -> str:
    """The source of variant ``name`` (parts joined by "+")."""
    text = (CSRC / "flash_attention.cu").read_text()
    parts = name.split("+")
    for anchor, repl in [x for p in parts for x in VARIANTS.get(p, [])]:
        if anchor not in text:
            raise SystemExit(f"{name}: anchor not found: {anchor!r}")
        text = text.replace(anchor, repl)
    return text + (TRACE_END if "trace" in parts else "")


def build(names):
    """The variants built in parallel -> {name: (ctypes lib, nvcc log)}."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        path = OUT / f"flash_attention_{name.replace('+', '_')}.cu"
        path.write_text(patched(name))
        so = path.with_name(f"lib{path.stem}.so")
        jobs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o",
             str(so), str(path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = [p] * 7 + [i] * 6 + \
            [f, f, i, i, i, p]
        libs[name] = (lib, log)
    return libs


def trace(lib, call):
    """Mean cycles a tile of each phase, by warp, over the heaviest q
    tile's walk of block (0, 0, 0) (its first tile left out)."""
    import numpy as np
    st = np.zeros((8, 64, 8), dtype=np.int64)
    lib.flash_probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.flash_probe_stamps(None, 1):
        raise SystemExit("flash_probe_stamps reset failed")
    call()
    torch.cuda.synchronize()
    if lib.flash_probe_stamps(st.ctypes.data, 0):
        raise SystemExit("flash_probe_stamps failed")
    n = int((st[0, :, 7] > 0).sum())
    out = {"tiles": n}
    for w in range(8):
        d = np.diff(st[w, 1:n, :], axis=1).mean(0)
        period = float(np.diff(st[w, 1:n, 0]).mean())
        out[f"warp{w}"] = dict(zip(PHASES, map(float, d)), period=period)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    a = ap.parse_args()
    import chip_smoke as cs
    from repro_torch.kernels.ref import attention_lse
    cs._setup()
    names = a.variants.split(",")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = build(names)
    for name, (_, log) in libs.items():
        wide = [e for e in cs.ptxas_resources({"f": log}, ("f",))
                if "_wide_tc_kernel<" in e.get("kernel", "")]
        print(json.dumps({"variant": name, "registers_spills": [
            [e.get("registers"), e.get("spill_store_bytes")] for e in wide]}))
    timer = cs.Timer()
    for tag, b, s, h, kv, kw, ids in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn((b, s, h, 256), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((b, s, kv, 256), generator=g,
                            device="cuda").bfloat16() for _ in range(2))
        segs = None
        if ids:
            seg = torch.from_numpy(cs.train_batch(0, cs.TRAIN_GEMMA)[
                "segment_ids"]).cuda()
            segs = (seg, seg)
        want = attention_lse(q, k, v, segment_ids=segs, **kw)[0] \
            if s <= 1024 else None
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib):
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *((None, None) if segs is None else
                  (segs[0].data_ptr(), segs[1].data_ptr())),
                None, b, s, s, h, kv, 256, 1.0 / math.sqrt(256),
                kw["softcap"], kw.get("window", 0), 1, 1, stream)
            if err:
                raise SystemExit(f"launch failed: {err}")
        row = {"shape": tag}
        for name in names:
            lib = libs[name][0]
            call(lib)
            torch.cuda.synchronize()
            row[f"err_{name}"] = None if want is None else \
                float((out.float() - want.float()).abs().max())
            row[f"ms_{name}"] = timer.ms(lambda: call(lib))
        if "kernel" in libs:     # again, last, for the drift
            row["ms_kernel_again"] = timer.ms(
                lambda: call(libs["kernel"][0]))
        print(json.dumps(row), flush=True)
        for name, (lib, _) in libs.items():
            if "trace" in name.split("+"):
                print(json.dumps(dict(trace(lib, lambda: call(lib)),
                                      variant=name, shape=tag)), flush=True)
        del q, k, v, out, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
