#!/usr/bin/env python3
"""Run the scan backward kernel's C++ on the CPU beside its plain
versions:

    PYTHONPATH=src python3 tools/mamba_scan_bwd_host_check.py [--quick]
    PYTHONPATH=src python3 tools/mamba_scan_bwd_host_check.py --warps

Builds ``src/repro_torch/csrc/mamba_scan_bwd.cu`` with g++ and
``-DREPRO_HOST_EMULATION`` into ``build/host_check/``: ``common.cuh``
then takes the CUDA primitives from ``csrc/host_emulation.cuh``, a CPU
stand-in (each block's CUDA threads run as CPU threads meeting at a
``std::barrier`` for every ``__syncthreads()``, blocks one after
another, bf16 as its 16 bits with round-to-nearest-even, and shared
memory filled with NaN before each block, so a read of a word no phase
wrote shows). Without ``--warps`` the tensor-core body is compiled out
and every case runs the first version (no warp primitive), bf16
included. With ``--warps`` (``-DREPRO_HOST_WARPS``) the tensor-core
body is built too and runs on the stand-in's warp primitives, each lane
a thread meeting its warp at a barrier: ``ldmatrix`` (plain and
transposed) and ``mma.sync.m16n8k16`` with their fragment layouts (the
products summed in f32 in k order), the shuffles, ``__syncwarp`` and
``cp.async`` (a copy); bf16 cases with P <= 64 then run the three
launches of the tensor-core body, held against the blocked version at
its chunk of 64.
Each case holds the launches' outputs against
``mamba_chunk_scan_bwd_blocked`` (the kernel's arithmetic in torch) and
``mamba_chunk_scan_bwd_ref`` (autograd through the naive scan) at
d_state 16 and 128, f32 and bf16, with and without an initial state and
dfinal, S a multiple of the chunk and not, P of one 64-row slice, of
two (the second ragged) and of 16, more than one group of eight heads,
and dt from ``init_ssm``'s range and ten times it. f32: each gradient
within 1e-5 of its max |value| of the blocked version and 1e-4 of the
autograd one; bf16 (dx, dB, dC rounded to bf16): max |got - want| /
max(1, |want|) within 1e-2, the f32 outputs within 1e-4. Needs g++ with
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

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "host_check"

from repro_torch.kernels.ref import (mamba_chunk_scan_bwd_blocked,  # noqa: E402
                                     mamba_chunk_scan_bwd_ref)

def build(warps: bool) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"libmamba_scan_bwd_host{'_warps' if warps else ''}.so"
    res = subprocess.run(["g++", "-std=c++20", "-O2", "-pthread",
                          "-fno-strict-aliasing", "-DREPRO_HOST_EMULATION",
                          "-Wno-unknown-pragmas",
                          *(["-DREPRO_HOST_WARPS"] if warps else []),
                          "-shared", "-fPIC", "-x", "c++",
                          str(CSRC / "mamba_scan_bwd.cu"), "-o", str(so)],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"g++ failed:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    lib.mamba_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 17 + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.mamba_scan_bwd_launch.restype = ctypes.c_int
    lib.mamba_scan_bwd_workspace.argtypes = [ctypes.c_int] * 6
    lib.mamba_scan_bwd_workspace.restype = ctypes.c_longlong
    return lib


def inputs(bt, s, h, p, n, dtype, init, dfin, dt_scale, seed):
    """Values in the model's ranges (models/ssm.py init_ssm): dt =
    softplus(0.5 N(0,1) + a per-head bias) around a rate drawn
    log-uniform in [0.001, 0.1] (times ``dt_scale``), A in -[1, 16]."""
    g = torch.Generator().manual_seed(seed)
    dt0 = dt_scale * torch.exp(torch.rand(h, generator=g) * (
        math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = torch.nn.functional.softplus(
        0.5 * torch.randn((bt, s, h), generator=g) + bias)
    A = -(1.0 + 15.0 * torch.rand(h, generator=g))
    D = 1.0 + 0.1 * torch.randn(h, generator=g)
    x = torch.randn((bt, s, h, p), generator=g).to(dtype)
    B = torch.randn((bt, s, n), generator=g).to(dtype)
    C = torch.randn((bt, s, n), generator=g).to(dtype)
    dy = torch.randn((bt, s, h, p), generator=g).to(dtype)
    s0 = torch.randn((bt, h, p, n), generator=g) if init else None
    df = torch.randn((bt, h, p, n), generator=g) if dfin else None
    return (x, dt, A, B, C, D, dy, df), s0


def run_kernel(lib, args, s0):
    x, dt, A, B, C, D, dy, df = args
    bt, s, h, p = x.shape
    n = B.shape[-1]
    dx = torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    ddt = torch.empty_like(dt)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    ds0 = torch.empty_like(s0) if s0 is not None else None
    code = 1 if x.dtype == torch.bfloat16 else 0
    ws = torch.empty(lib.mamba_scan_bwd_workspace(bt, s, h, p, n, code) // 4)

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = lib.mamba_scan_bwd_launch(
        *(ptr(t) for t in (x, dt, A, B, C, D, s0, dy, df, dx, ds0, dB, dC,
                           ddt, dA, dD, ws)),
        bt, s, h, p, n, code, None)
    if err:
        raise SystemExit(f"launch returned {err}")
    return dx, ddt, dA, dB, dC, dD, ds0


NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinitial_state")


def hold(tag, got, want, tol_rel_max, bf16):
    worst = {}
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            if g is not None:
                raise SystemExit(f"{tag}: {name} given without an initial "
                                 "state")
            continue
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise SystemExit(f"{tag}: {name} not finite")
        if bf16 and name in ("dx", "dB", "dC"):
            err = float(((g - w).abs() / w.abs().clamp_min(1.0)).max())
            tol = 1e-2
        else:
            err = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
            tol = tol_rel_max
        worst[name] = err
        if err > tol:
            raise SystemExit(f"FAIL {tag}: {name} error {err:.3e} > {tol}")
    return worst


CASES = [  # (bt, s, h, p, n, init, dfinal, dt_scale)
    (2, 64, 3, 64, 16, False, False, 1.0),
    (2, 70, 3, 64, 16, True, True, 1.0),
    (1, 33, 2, 80, 16, True, False, 1.0),
    (2, 45, 2, 16, 16, False, True, 10.0),
    (1, 96, 2, 64, 128, False, False, 1.0),
    (1, 100, 2, 64, 128, True, True, 1.0),
    (1, 40, 1, 72, 128, True, True, 10.0),
    (1, 1, 2, 64, 128, True, True, 1.0),
    (1, 130, 10, 64, 16, True, True, 1.0),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="the first four cases (d_state 16) only")
    ap.add_argument("--warps", action="store_true",
                    help="emulate the warp primitives: bf16 at P <= 64 "
                         "runs the tensor-core body")
    a = ap.parse_args()
    lib = build(a.warps)
    cases = CASES[:4] if a.quick else CASES
    for k, (bt, s, h, p, n, init, dfin, dts) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            tc = a.warps and dtype == torch.bfloat16 and p <= 64
            if a.warps and not tc:
                continue
            t0 = time.perf_counter()
            args, s0 = inputs(bt, s, h, p, n, dtype, init, dfin, dts, k)
            got = run_kernel(lib, args, s0)
            again = run_kernel(lib, args, s0)
            if not all(x is None or torch.equal(x, y)
                       for x, y in zip(got, again)):
                raise SystemExit(f"case {k}: repeat differs")
            tag = (f"Bt={bt} S={s} H={h} P={p} N={n} init={init} "
                   f"dfinal={dfin} dt x{dts:g} {str(dtype)[6:]}"
                   f"{' tensor cores' if tc else ''}")
            bf16 = dtype == torch.bfloat16
            blocked = mamba_chunk_scan_bwd_blocked(
                *args, initial_state=s0, chunk=64 if tc else 32)
            w1 = hold(tag + " vs blocked", got, blocked,
                      1e-4 if bf16 else 1e-5, bf16)
            autograd = mamba_chunk_scan_bwd_ref(*args, initial_state=s0)
            w2 = hold(tag + " vs autograd", got, autograd, 1e-4, bf16)
            f32_out = max(v for name, v in w2.items()
                          if not bf16 or name not in ("dx", "dB", "dC"))
            print(f"ok {tag}: worst vs blocked {max(w1.values()):.2e}, "
                  f"vs autograd {max(w2.values()):.2e} (f32 outputs "
                  f"{f32_out:.2e}) ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
