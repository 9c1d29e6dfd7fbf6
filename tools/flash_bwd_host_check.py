#!/usr/bin/env python3
"""Run the flash attention backward kernel's C++ on the CPU beside its
blocked plain version:

    PYTHONPATH=src python3 tools/flash_bwd_host_check.py [--quick]

Builds ``src/repro_torch/csrc/flash_attention_bwd.cu`` with g++,
``-DREPRO_HOST_EMULATION`` and ``-DREPRO_HOST_WARPS`` into
``build/host_check/``: ``common.cuh`` then takes the CUDA primitives
from ``csrc/host_emulation.cuh``, a CPU stand-in in which each CUDA
thread is a CPU thread, a block's threads meet at a ``std::barrier``
for every ``__syncthreads()`` and a warp's lanes at one of their own in
every warp primitive (``ldmatrix`` plain and transposed,
``mma.sync.m16n8k16`` with its fragment layouts, the shuffles, ballots
and reductions), ``cp.async`` is a copy and dynamic shared memory is
NaN before each block. Each case calls ``flash_attention_bwd_launch``
as the wrapper does (the spans scratch with ids), twice, and holds
(dq, dk, dv) against ``flash_attention_bwd_blocked`` walking the
kernel's tiles (at head_dim 256 the eight-warp bodies' 64-row blocks
over 32-row tiles) on the same (out, lse): bf16 and f16 at head_dim 256
run the tensor-core bodies, gated at the smoke's metric, max |got -
want| / max(1, |want|), 2e-2 (bf16) and 1e-2 (f16). (The f32 first
version is not run: its shuffles sit under per-row branches, and the
stand-in's warps meet at barriers that every lane must reach.) Cases: the window binding (S 130, window 40,
softcap 50), GQA G = 1 / 2, packed ids crossing the tile edges, Sq <
Skv and Sq > Skv (rows with no key: their dq is 0 and they add
nothing), bidirectional. Repeats must be bit-identical. Needs g++ with
C++20; no card. Prints one line a case; exits nonzero on the first
failure.
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

from repro_torch.kernels.ref import (attention_lse,  # noqa: E402
                                     flash_attention_bwd_blocked)

DTYPES = {torch.bfloat16: 1, torch.float16: 2}   # csrc/common.cuh's codes
TOL = {torch.bfloat16: 2e-2, torch.float16: 1e-2}
WIDE_TILES = (64, 32)     # the head_dim 256 bodies' (block rows, walked)

# (B, Sq, Skv, H, KV, ids, mask options, dtypes)
CASES = [
    (1, 130, 130, 2, 1, False, dict(window=40, softcap=50.0),
     (torch.bfloat16, torch.float16)),
    (1, 100, 100, 2, 2, False, dict(), (torch.bfloat16,)),
    (2, 130, 130, 2, 1, True, dict(softcap=30.0),
     (torch.bfloat16, torch.float16)),
    (1, 70, 130, 2, 1, True, dict(window=50), (torch.bfloat16,)),
    (1, 130, 70, 2, 1, False, dict(), (torch.bfloat16,)),
    (1, 96, 96, 2, 1, True, dict(causal=False, bidirectional=True),
     (torch.bfloat16,)),
]


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "libflash_attention_bwd_host.so"
    res = subprocess.run(["g++", "-std=c++20", "-O2", "-pthread",
                          "-fno-strict-aliasing", "-DREPRO_HOST_EMULATION",
                          "-DREPRO_HOST_WARPS", "-Wno-unknown-pragmas",
                          "-shared", "-fPIC", "-x", "c++",
                          str(CSRC / "flash_attention_bwd.cu"), "-o",
                          str(so)], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"g++ failed:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_launch.argtypes = [p] * 13 + [i] * 6 + \
        [f, f, i, i, i, p]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    return lib


def inputs(b, sq, skv, h, kv, d, dtype, ids, seed):
    """Seeded standard normals rounded to ``dtype``; packed ids (runs of
    mean length 12, so documents cross the 32- and 64-row tile edges)
    right-aligned between the queries and keys."""
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((b, sq, h, d), generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, skv, kv, d), generator=g).to(dtype)
            for _ in range(2))
    segs = None
    if ids:
        rng = np.random.default_rng(seed)
        s = max(sq, skv)
        seg = torch.from_numpy(np.cumsum(rng.random((b, s)) < 1 / 12,
                                         axis=1).astype(np.int32))
        segs = (seg[:, s - sq:].contiguous(), seg[:, s - skv:].contiguous())
    return q, k, v, do, segs


def run_kernel(lib, q, k, v, out, lse, do, segs, kw):
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, sq), dtype=torch.float32)
    spans = None if segs is None else torch.empty(
        2 * b * ((sq + 31) // 32 + (skv + 31) // 32), dtype=torch.int32)

    def ptr(t):
        return None if t is None else t.data_ptr()
    seg_q, seg_k = segs if segs is not None else (None, None)
    causal = kw.get("causal", True) and not kw.get("bidirectional", False)
    err = lib.flash_attention_bwd_launch(
        *(ptr(t) for t in (q, k, v, out, do, lse, delta, spans, dq, dk, dv,
                           seg_q, seg_k)),
        b, sq, skv, h, kv, d, 1.0 / math.sqrt(d),
        float(kw.get("softcap", 0.0)), int(kw.get("window", 0)),
        int(causal), DTYPES[q.dtype], None)
    if err:
        raise SystemExit(f"launch returned {err}")
    return dq, dk, dv


def grad_err(got, want) -> float:
    w = want.float()
    return float(((got.float() - w).abs() / w.abs().clamp_min(1.0)).max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="the first two cases only")
    a = ap.parse_args()
    lib = build()
    cases = CASES[:2] if a.quick else CASES
    d = 256
    for n, (b, sq, skv, h, kv, ids, kw, dtypes) in enumerate(cases):
        for dtype in dtypes:
            t0 = time.perf_counter()
            q, k, v, do, segs = inputs(b, sq, skv, h, kv, d, dtype, ids, n)
            out, lse = attention_lse(q.float(), k.float(), v.float(),
                                     segment_ids=segs, **kw)
            out, lse = out.to(dtype).contiguous(), lse.contiguous()
            got = run_kernel(lib, q, k, v, out, lse, do, segs, kw)
            again = run_kernel(lib, q, k, v, out, lse, do, segs, kw)
            tag = (f"B={b} Sq={sq} Skv={skv} H={h} KV={kv} D={d} "
                   f"{'ids ' if ids else ''}{kw} {str(dtype)[6:]}")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise SystemExit(f"FAIL {tag}: repeat differs")
            want = flash_attention_bwd_blocked(
                *(x.float() for x in (q, k, v, out)), lse, do.float(),
                segment_ids=segs, tiles=WIDE_TILES, **kw)
            errs = [grad_err(g, w) for g, w in zip(got, want)]
            if not all(math.isfinite(e) for e in errs) or \
                    max(errs) > TOL[dtype]:
                raise SystemExit(f"FAIL {tag}: errors (dq, dk, dv) {errs} "
                                 f"> {TOL[dtype]}")
            dead = torch.isinf(lse).any(1)            # [B, Sq]: no key
            if dead.any() and got[0][dead].abs().sum():
                raise SystemExit(f"FAIL {tag}: a row with no key has dq")
            print(f"ok {tag}: (dq, dk, dv) errors "
                  f"{', '.join(f'{e:.2e}' for e in errs)} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
