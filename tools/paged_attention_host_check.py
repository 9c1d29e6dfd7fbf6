#!/usr/bin/env python3
"""Run the paged attention kernel's bf16 / f16 C++ on the CPU beside its
plain version:

    PYTHONPATH=src python3 tools/paged_attention_host_check.py [--quick]

Builds ``src/repro_torch/csrc/paged_attention.cu`` with g++,
``-DREPRO_HOST_EMULATION`` and ``-DREPRO_HOST_WARPS`` into
``build/host_check/``: ``common.cuh`` then takes the CUDA primitives
from ``csrc/host_emulation.cuh`` (each CUDA thread a CPU thread, a
block's threads meeting at a ``std::barrier`` for every
``__syncthreads()``, a warp's lanes at one of their own in every warp
primitive, ``ldmatrix`` and ``mma.sync.m16n8k16`` with their fragment
layouts, ``cp.async`` a copy, the ticket's ``atomicAdd``, dynamic
shared memory NaN before each block; the grid's blocks one after
another, so the last split's block combines). Each case calls
``paged_attention_launch`` as the wrapper does (the split plan of
``kernels/paged_attention.plan`` for a 132-SM card, the partials and
the ticket counters), with (m, l), and holds the output against
``paged_attention_naive`` on the same inputs in float32 within 2e-2
(bf16) / 1e-2 (f16) of max |got - want|, m within 1e-3 and l within
1e-3 of itself; lanes with ctx 0 must give 0 with m = -1e30, l = 0. A
second call must repeat the first bit for bit and leave the counters at
zero. Cases: G = 1 / 2 / 4 / 6 / 7 / 8 / 16 at head_dim 64 and 128, G =
2 at 256, G = 24 and 40 (two and four 16-row head tiles) and 80 (two
head chunks of 40), the window with the softcap, page 8, and the
combine's shared-memory stage in one and several head groups and past
its size; the contexts of each case (0 where it has three lanes or
more) sit on, one past and far from the split edges. Then one table read at 8, 64 and 128 pages (contexts within 8
pages) must give the same bits at every width, and at 64 and 128
(contexts within 64 pages). (The f32 body is not run: its shuffles sit
under per-lane branches, and the stand-in's warps meet at barriers
every lane must reach.) Needs g++ with C++20; no card. Prints one line
a case; exits nonzero on the first failure.
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

from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.ref import paged_attention_naive  # noqa: E402

DTYPES = {torch.bfloat16: 1, torch.float16: 2}   # csrc/common.cuh's codes
TOL = {torch.bfloat16: 2e-2, torch.float16: 1e-2}
N_SM = 132
BOTH = (torch.bfloat16, torch.float16)

# (B, H, KV, D, page, table pages, options, dtypes); each case's contexts
# come from ``contexts``
CASES = [
    (3, 2, 2, 64, 16, 24, dict(), BOTH),                       # G = 1
    (3, 4, 2, 64, 16, 24, dict(), (torch.bfloat16,)),          # G = 2
    (3, 8, 2, 64, 16, 24, dict(), (torch.bfloat16,)),          # G = 4
    (3, 12, 2, 128, 16, 24, dict(), (torch.bfloat16,)),        # G = 6
    (3, 14, 2, 128, 16, 24, dict(), (torch.float16,)),         # G = 7
    (3, 16, 2, 64, 16, 24, dict(), (torch.bfloat16,)),         # G = 8
    (2, 32, 2, 128, 16, 24, dict(), BOTH),                     # G = 16
    (2, 16, 1, 128, 16, 24, dict(window=40, softcap=30.0), BOTH),
    (3, 4, 2, 256, 16, 24, dict(), BOTH),                      # G = 2, D 256
    (2, 4, 2, 256, 16, 24, dict(window=150, softcap=50.0), (torch.bfloat16,)),
    (2, 24, 1, 64, 16, 24, dict(softcap=20.0), (torch.bfloat16,)),  # 2 tiles
    (2, 40, 1, 64, 8, 40, dict(), (torch.bfloat16,)),          # 4 tiles
    (1, 80, 1, 32, 16, 24, dict(window=100), (torch.bfloat16,)),  # 2 chunks
    (2, 16, 2, 16, 16, 24, dict(), (torch.float16,)),          # D 16
    # the combine's stage: G 16 over 16 splits (two head groups), G 40 at
    # D 16 over 3 splits (three) and over 16 (loads straight to the fold)
    (2, 32, 2, 128, 16, 128, dict(), (torch.bfloat16,)),
    (2, 40, 1, 16, 16, 24, dict(), (torch.bfloat16,)),
    (1, 40, 1, 16, 16, 128, dict(), (torch.bfloat16,)),
]


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "libpaged_attention_host.so"
    res = subprocess.run(["g++", "-std=c++20", "-O2", "-pthread",
                          "-fno-strict-aliasing", "-DREPRO_HOST_EMULATION",
                          "-DREPRO_HOST_WARPS", "-Wno-unknown-pragmas",
                          "-shared", "-fPIC", "-x", "c++",
                          str(CSRC / "paged_attention.cu"), "-o", str(so)],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"g++ failed:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_launch.argtypes = [p] * 10 + [i] * 9 + \
        [f, f, i, i, p]
    lib.paged_attention_launch.restype = ctypes.c_int
    return lib


def contexts(b, h, kv, page, maxp, seed):
    """``b`` contexts: of 0, one on a split edge, one past it, one just
    short of the table and the full table, as many as fit, then seeded
    ones (the window, when given, binds on the long ones)."""
    edge = pa.plan(b, h, kv, maxp, page, N_SM).pages_per_split * page
    full = maxp * page
    fixed = {1: [full - 1], 2: [edge + 1, full], 3: [0, edge, full - 1]}
    if b in fixed:
        return torch.tensor(fixed[b], dtype=torch.int32)
    rng = np.random.default_rng(seed)
    extra = rng.integers(1, full + 1, b - 4).tolist()
    return torch.tensor([0, edge, edge + 1, full - 1] + extra,
                        dtype=torch.int32)


def inputs(b, h, kv, d, page, maxp, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    nb = b * maxp + 3
    q = torch.randn((b, h, d), generator=g).to(dtype)
    kp, vp = (torch.randn((nb, page, kv, d), generator=g).to(dtype)
              for _ in range(2))
    table = torch.randperm(nb, generator=g)[:b * maxp].reshape(
        b, maxp).to(torch.int32).contiguous()
    return q, kp, vp, table


def run_kernel(lib, q, kp, vp, table, ctx, kw):
    """One launch as the wrapper makes it; (out, m, l, counters after)."""
    b, h, d = q.shape
    _, page, kv, _ = kp.shape
    maxp = table.shape[1]
    pl = pa.plan(b, h, kv, maxp, page, N_SM)
    cells = b * kv * pl.head_chunks
    part = torch.full((max(1, cells * pl.n_split *
                           pa.part_floats(pl.heads_per_block, d, q.dtype)),),
                      float("nan"))
    counters = torch.zeros(cells, dtype=torch.int32)
    out = torch.empty_like(q)
    m = torch.empty((b, h), dtype=torch.float32)
    l = torch.empty((b, h), dtype=torch.float32)
    err = lib.paged_attention_launch(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
        ctx.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        part.data_ptr(), counters.data_ptr(), b, h, kv, d, page, maxp,
        pl.heads_per_block, pl.n_split, pl.pages_per_split,
        1.0 / math.sqrt(d), float(kw.get("softcap", 0.0)),
        int(kw.get("window", 0)), DTYPES[q.dtype], None)
    if err:
        raise SystemExit(f"launch returned {err}")
    return out, m, l, counters, pl


def held(lib, tag, args, ctx, kw, dtype):
    """Kernel vs plain version, a bit-identical repeat; returns (out, m,
    l) and the error line."""
    got, m, l, counters, pl = run_kernel(lib, *args, ctx, kw)
    again = run_kernel(lib, *args, ctx, kw)
    if not all(torch.equal(x, y) for x, y in zip((got, m, l), again[:3])):
        raise SystemExit(f"FAIL {tag}: repeat differs")
    if int(counters.abs().sum()) or int(again[3].abs().sum()):
        raise SystemExit(f"FAIL {tag}: ticket counters not left at zero")
    q, kp, vp, table = args
    want, (wm, wl) = paged_attention_naive(q.float(), kp.float(),
                                           vp.float(), table, ctx,
                                           return_stats=True, **kw)
    err = float((got.float() - want).abs().max())
    dead = ctx == 0
    live = ~dead[:, None].expand_as(m)
    m_err = float((m - wm)[live].abs().max()) if live.any() else 0.0
    l_err = float(((l - wl).abs() / wl.clamp_min(1e-6))[live].max()) \
        if live.any() else 0.0
    if not (math.isfinite(err) and err <= TOL[dtype] and m_err <= 1e-3
            and l_err <= 1e-3):
        raise SystemExit(f"FAIL {tag}: out error {err}, m error {m_err}, "
                         f"l error {l_err}")
    if got[dead].float().abs().sum() or (m[dead] != -1e30).any() or \
            l[dead].abs().sum():
        raise SystemExit(f"FAIL {tag}: a lane with ctx 0 is not (0, -1e30,"
                         " 0)")
    return (got, m, l), (f"out error {err:.2e}, m {m_err:.1e}, l "
                         f"{l_err:.1e}, plan {tuple(pl)}")


def widths(lib, dtype):
    """One lane's bits at table widths 8 / 64 / 128 (contexts within 8
    pages) and 64 / 128 (within 64)."""
    b, h, kv, d, page = 4, 8, 2, 64, 16
    q, kp, vp, wide = inputs(b, h, kv, d, page, 128, dtype, 99)
    for ws, ctx in (((8, 64, 128), [128, 127, 0, 17]),
                    ((64, 128), [1024, 1000, 129, 0])):
        ctx = torch.tensor(ctx, dtype=torch.int32)
        outs = [run_kernel(lib, q, kp, vp, wide[:, :w].contiguous(), ctx,
                           {})[:3] for w in ws]
        for w, o in zip(ws[1:], outs[1:]):
            if not all(torch.equal(x, y) for x, y in zip(o, outs[0])):
                raise SystemExit(f"FAIL widths {ws[0]} vs {w}: differ")
        held(lib, f"widths {ws}", (q, kp, vp, wide[:, :ws[0]].contiguous()),
             ctx, {}, dtype)
        print(f"ok {str(dtype)[6:]} table widths {ws}: bit-identical "
              f"(n_split {[pa.plan(b, h, kv, w, page, N_SM).n_split for w in ws]})",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="the first two cases and the widths only")
    a = ap.parse_args()
    lib = build()
    for n, (b, h, kv, d, page, maxp, kw, dtypes) in enumerate(
            CASES[:2] if a.quick else CASES):
        for dtype in dtypes:
            t0 = time.perf_counter()
            args = inputs(b, h, kv, d, page, maxp, dtype, n)
            ctx = contexts(b, h, kv, page, maxp, n)
            tag = (f"B={b} H={h} KV={kv} D={d} P={page} maxp={maxp} {kw} "
                   f"{str(dtype)[6:]} ctx={ctx.tolist()}")
            _, line = held(lib, tag, args, ctx, kw, dtype)
            print(f"ok {tag}: {line} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    widths(lib, torch.bfloat16)
    return 0


if __name__ == "__main__":
    sys.exit(main())
