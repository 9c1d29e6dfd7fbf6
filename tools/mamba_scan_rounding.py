#!/usr/bin/env python3
"""Emulate, on the CPU, the rounding of the bf16 mamba_chunk_scan
kernel's tensor-core body, and hold it against the naive scan:

    python3 tools/mamba_scan_rounding.py

The body computes, per chunk of 128 tokens, y = 2^a_i C S^T + (G dt L) x
+ D x and S = 2^a_end S + (x w)^T B in f32, with bf16 operands. x, B and
C are bf16 already; three operands are made in f32 and must be rounded
to enter a bf16 product: G dt L, x w (w = dt 2^(a_end - a_j)) and the
copy of S. For each choice of how those three are rounded ("bf16": one
rounding; "pair": a bf16 hi + lo pair, two products; "f32": not at all)
it prints, per input distribution, the worst ratio of |error| to the
tolerance atol + rtol |ref| with atol = rtol = 8e-2 (the Pallas tests'
bf16 tolerance), for y and for the final state. A ratio above 1 fails.
Inputs: the GPU tests' draws (dt = softplus(N(0, 1)), A = -exp(N(0, 1)))
and the model's (chip_smoke.py's ranges), from a seed, with an initial
state.
"""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels.ref import mamba_chunk_scan_naive  # noqa: E402

TOL = 8e-2
Q = 128


def rounded(t, how):
    if how == "f32":
        return t
    hi = t.to(torch.bfloat16).float()
    return hi if how == "bf16" else hi + (t - hi).to(torch.bfloat16).float()


def emulate(x, dt, A, B, C, D, s0, g_how, xw_how, s_how):
    bt, s, h, p = x.shape
    n = B.shape[-1]
    st = s0.clone()
    y = torch.zeros(bt, s, h, p)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, :, :, None]
    for t0 in range(0, s, Q):
        ln = min(Q, s - t0)

        def chunk(t, shape):
            z = torch.zeros(shape)
            z[:, :ln] = t[:, t0:t0 + ln].float()
            return z
        xc, dc = chunk(x, (bt, Q, h, p)), chunk(dt, (bt, Q, h))
        bc, cc = chunk(B, (bt, Q, n)), chunk(C, (bt, Q, n))
        a = torch.cumsum(dc * A, dim=1)                       # [bt, Q, h]
        g = torch.einsum("bin,bjn->bij", cc, bc)
        diff = (a[:, :, None, :] - a[:, None, :, :]).clamp(max=0)
        gdl = torch.where(causal, g[..., None] * dc[:, None] *
                          torch.exp(diff), torch.zeros(()))
        y_off = torch.einsum("bin,bhpn->bihp", cc, rounded(st, s_how))
        yc = (y_off * torch.exp(a)[..., None]
              + torch.einsum("bijh,bjhp->bihp", rounded(gdl, g_how), xc)
              + xc * D[None, None, :, None])
        y[:, t0:t0 + ln] = yc[:, :ln]
        a_end = a[:, -1]
        xw = rounded(xc * (dc * torch.exp(a_end[:, None] - a))[..., None],
                     xw_how)
        st = (st * torch.exp(a_end)[..., None, None]
              + torch.einsum("bjhp,bjn->bhpn", xw, bc))
    return y.to(torch.bfloat16), st


def draws(kind, s, h=4, p=64, n=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    if kind == "gpu tests":
        dt = torch.nn.functional.softplus(torch.randn((1, s, h), generator=g))
        A = -torch.exp(torch.randn((h,), generator=g))
    else:                                    # mamba2's ranges
        u = torch.rand((h,), generator=g)
        dt0 = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
        bias = dt0 + torch.log(-torch.expm1(-dt0))
        dt = torch.nn.functional.softplus(
            0.5 * torch.randn((1, s, h), generator=g) + bias)
        A = -(1.0 + 15.0 * torch.rand((h,), generator=g))
    D = 1.0 + 0.1 * torch.randn((h,), generator=g)
    x = torch.randn((1, s, h, p), generator=g).bfloat16()
    B = torch.randn((1, s, n), generator=g).bfloat16()
    C = torch.randn((1, s, n), generator=g).bfloat16()
    s0 = torch.randn((1, h, p, n), generator=g)
    return x, dt, A, B, C, D, s0


def ratio(got, want):
    return float(((got.float() - want.float()).abs()
                  / (TOL + TOL * want.float().abs())).max())


def main() -> int:
    choices = [("bf16", "bf16", "bf16"), ("bf16", "pair", "pair"),
               ("pair", "bf16", "pair"), ("pair", "pair", "bf16"),
               ("pair", "pair", "pair")]
    for kind, s in (("gpu tests", 256), ("model", 1024)):
        args = draws(kind, s)
        yw, fw = mamba_chunk_scan_naive(*args[:6], chunk=Q,
                                        initial_state=args[6])
        for g_how, xw_how, s_how in choices:
            y, fin = emulate(*args, g_how, xw_how, s_how)
            print(json.dumps({"inputs": kind, "S": s, "G_dt_L": g_how,
                              "x_w": xw_how, "S_copy": s_how,
                              "y_ratio": ratio(y, yw),
                              "state_ratio": ratio(fin, fw)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
