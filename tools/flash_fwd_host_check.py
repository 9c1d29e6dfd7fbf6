#!/usr/bin/env python3
"""Run the flash attention forward kernel's C++ on the CPU beside its
blocked plain version:

    PYTHONPATH=src python3 tools/flash_fwd_host_check.py [--quick]

Builds ``src/repro_torch/csrc/flash_attention.cu`` with g++,
``-DREPRO_HOST_EMULATION`` and ``-DREPRO_HOST_WARPS`` into
``build/host_check/``: ``common.cuh`` then takes the CUDA primitives
from ``csrc/host_emulation.cuh`` (each CUDA thread a CPU thread, a
block's threads meeting at a ``std::barrier`` for every
``__syncthreads()``, a warp's lanes at one of their own in every warp
primitive, ``ldmatrix`` and ``mma.sync.m16n8k16`` with their fragment
layouts, ``cp.async`` a copy, dynamic shared memory NaN before each
block). Each case calls ``flash_attention_launch`` as the wrapper does,
with the row log-sum-exp, twice (the repeat must be bit-identical), and
holds (out, lse) against ``flash_attention_fwd_blocked`` walking the
kernel's tiles (head_dim 64: 64-row q and key tiles; head_dim 256, the
eight-warp body: 64-row q tiles over 32-row key tiles) within 2e-2
(bf16) / 1e-2 (f16) of max |got - want|; rows with no key must be 0
with lse -inf. With relabelled ids (the same mask, other tile spans,
so other tiles skipped) out and lse must equal the packed ids' bit for
bit. Cases: the window binding (S 130, window 40, softcap 50), G = 1 /
2 / 8, packed ids crossing the tile edges and relabelled, Sq < Skv and
Sq > Skv (rows with no key), bidirectional with ids. (The f32 body is
not run: its shuffles sit under per-row branches, and the stand-in's
warps meet at barriers every lane must reach.) Needs g++ with C++20;
no card. Prints one line a case; exits nonzero on the first failure.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "host_check"

from repro_torch.kernels.ref import (flash_attention_fwd_blocked,  # noqa: E402
                                     fwd_tile_walk)

DTYPES = {torch.bfloat16: 1, torch.float16: 2}   # csrc/common.cuh's codes
TOL = {torch.bfloat16: 2e-2, torch.float16: 1e-2}
TILES = {64: (64, 64), 256: (64, 32)}   # the bodies' (q tile, key tile)
BOTH = (torch.bfloat16, torch.float16)

# (B, Sq, Skv, H, KV, ids, mask options, dtypes); ids: None, "packed"
# or "relabelled" (checked against "packed" bit for bit as well)
CASES = [
    (1, 130, 130, 2, 1, None, dict(window=40, softcap=50.0), BOTH),
    (1, 100, 100, 2, 2, None, dict(), (torch.bfloat16,)),
    (1, 70, 70, 8, 1, "packed", dict(softcap=30.0), (torch.bfloat16,)),
    (2, 130, 130, 2, 1, "packed", dict(softcap=30.0), BOTH),
    (2, 130, 130, 2, 1, "relabelled", dict(softcap=30.0), (torch.bfloat16,)),
    (1, 70, 130, 2, 1, "packed", dict(window=50), (torch.bfloat16,)),
    (1, 130, 70, 2, 1, None, dict(), (torch.bfloat16,)),
    (1, 96, 96, 2, 1, "packed", dict(causal=False, bidirectional=True),
     (torch.bfloat16,)),
]


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "libflash_attention_host.so"
    res = subprocess.run(["g++", "-std=c++20", "-O2", "-pthread",
                          "-fno-strict-aliasing", "-DREPRO_HOST_EMULATION",
                          "-DREPRO_HOST_WARPS", "-Wno-unknown-pragmas",
                          "-shared", "-fPIC", "-x", "c++",
                          str(CSRC / "flash_attention.cu"), "-o", str(so)],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"g++ failed:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [p] * 7 + [i] * 6 + \
        [f, f, i, i, i, p]
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def inputs(b, sq, skv, h, kv, d, dtype, ids, seed):
    """Seeded standard normals rounded to ``dtype``; packed ids (runs of
    mean length 12, so documents cross the 32- and 64-row tile edges)
    right-aligned between the queries and keys; ``relabelled``: the
    packed ids with each label mapped through a seeded permutation.
    Returns (q, k, v, packed ids, ids)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g).to(dtype)
    k, v = (torch.randn((b, skv, kv, d), generator=g).to(dtype)
            for _ in range(2))
    if ids is None:
        return q, k, v, None, None
    rng = np.random.default_rng(seed)
    s = max(sq, skv)
    seg = np.cumsum(rng.random((b, s)) < 1 / 12, axis=1).astype(np.int32)
    packed = tuple(torch.from_numpy(x[:, s - n:].copy())
                   for x, n in ((seg, sq), (seg, skv)))
    if ids == "packed":
        return q, k, v, packed, packed
    labels = (rng.permutation(int(seg.max()) + 1) * 7 - 40).astype(np.int32)
    seg = labels[seg]
    return q, k, v, packed, tuple(torch.from_numpy(seg[:, s - n:].copy())
                                  for n in (sq, skv))


def run_kernel(lib, q, k, v, segs, kw):
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32)
    seg_q, seg_k = segs if segs is not None else (None, None)
    causal = kw.get("causal", True) and not kw.get("bidirectional", False)
    err = lib.flash_attention_launch(
        *(None if t is None else t.data_ptr()
          for t in (q, k, v, out, seg_q, seg_k, lse)),
        b, sq, skv, h, kv, d, 1.0 / math.sqrt(d),
        float(kw.get("softcap", 0.0)), int(kw.get("window", 0)),
        int(causal), DTYPES[q.dtype], None)
    if err:
        raise SystemExit(f"launch returned {err}")
    return out, lse


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="the first two cases only")
    a = ap.parse_args()
    lib = build()
    cases = CASES[:2] if a.quick else CASES
    for d in (64, 256):
        for n, (b, sq, skv, h, kv, ids, kw, dtypes) in enumerate(cases):
            for dtype in dtypes:
                t0 = time.perf_counter()
                q, k, v, packed, segs = inputs(b, sq, skv, h, kv, d, dtype,
                                               ids, n)
                got, lse = run_kernel(lib, q, k, v, segs, kw)
                again = run_kernel(lib, q, k, v, segs, kw)
                tag = (f"B={b} Sq={sq} Skv={skv} H={h} KV={kv} D={d} "
                       f"{ids or 'no ids'} {kw} {str(dtype)[6:]}")
                if not (torch.equal(got, again[0]) and
                        torch.equal(lse, again[1])):
                    raise SystemExit(f"FAIL {tag}: repeat differs")
                if ids == "relabelled":
                    base = run_kernel(lib, q, k, v, packed, kw)
                    if not (torch.equal(got, base[0]) and
                            torch.equal(lse, base[1])):
                        raise SystemExit(f"FAIL {tag}: differs from the "
                                         "packed ids' output")
                want, want_lse = flash_attention_fwd_blocked(
                    q.float(), k.float(), v.float(), segment_ids=segs,
                    tiles=TILES[d], **kw)
                err = float((got.float() - want).abs().max())
                dead = torch.isinf(want_lse)
                if not torch.equal(torch.isinf(lse), dead):
                    raise SystemExit(f"FAIL {tag}: rows with no key differ")
                lse_err = float((lse - want_lse)[~dead].abs().max())
                if not (math.isfinite(err) and math.isfinite(lse_err)) or \
                        max(err, lse_err) > TOL[dtype]:
                    raise SystemExit(f"FAIL {tag}: out error {err}, lse "
                                     f"error {lse_err} > {TOL[dtype]}")
                if got.transpose(1, 2)[dead].float().abs().sum():
                    raise SystemExit(f"FAIL {tag}: a row with no key is "
                                     "not 0")
                walk_kw = {n: x for n, x in kw.items() if n != "softcap"}
                walked, cut = (int(fwd_tile_walk(sq, skv, TILES[d],
                                                 segment_ids=s, **walk_kw)
                                   .sum()) * (b if s is None else 1)
                               for s in (segs, None))
                print(f"ok {tag}: out error {err:.2e}, lse error "
                      f"{lse_err:.2e}, {int(dead.sum())} rows with no key, "
                      f"{walked} of {cut} tile pairs walked "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
