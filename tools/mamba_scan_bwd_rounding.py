#!/usr/bin/env python3
"""Emulate, on the CPU, the operand rounding of the scan backward's bf16
tensor-core body and hold it against the card's gates:

    PYTHONPATH=src python3 tools/mamba_scan_bwd_rounding.py [--batch 1] \
        [--seq 1024] [--seed 0]

The body's products take x, dy, B and C as bf16 (exact) and round the
operands it makes in f32: the walk's x_j w_j and dy_i e^{c_i} (the
chunk's state and adjoint updates), the states S0_c and adjoints G_c
(in dy S0, x G and B G^T), the pair weights A1 = w C B^T (in A1^T dy)
and each group's sum of A2 = w dt_j dy_i.x_j (in A2 B and A2^T C). For
each choice of that rounding ("pair": every such operand a bf16 hi + lo
pair, two products, the kernel's; "bf16": every one rounded once;
"bf16:<operand>": that operand alone rounded once, the rest pairs) it
prints the share of its tolerance that each gradient's error reaches
against the same passes in f32 (``scan_bwd_passes``, the arithmetic of
``mamba_chunk_scan_bwd_blocked``, at the kernel's chunk of 64 and
groups of 8 heads, each made operand passed through the rounding), dx, dB
and dC rounded to bf16 as the kernel writes them: 1e-2 of max(1,
|want|) element by element for those, 1e-4 of the max |want| for ddt,
dA, dD and dinitial_state (the gates of
``chip_smoke.check_mamba_chunk_scan_bwd``, which holds the kernel
against the f32 autograd gradient; a share above 1 fails). Shapes:
mamba2-1.3b's training widths (H 64, P 64, N 128) at ``--batch`` rows
of ``--seq`` tokens, dt drawn as ``init_ssm`` draws it and ten times
it, with an initial state and dfinal. One JSON line a dt scale (~40 s).
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from repro_torch.kernels.ref import SCAN_BWD_GROUP as GROUP
from repro_torch.kernels.ref import scan_bwd_passes

H, P, N, Q = 64, 64, 128, 64
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinitial_state")
OPERANDS = ("walk", "states", "a1", "a2")   # x w and dy e^c; S0, G; A1; A2


def rounded(t, how):
    if how == "f32":
        return t
    hi = t.to(torch.bfloat16).float()
    return hi if how == "bf16" else hi + (t - hi).to(torch.bfloat16).float()


def made(mode):
    """The rounding of ``mode`` for ``scan_bwd_passes``' made operands."""
    def rnd(op, t):
        if mode in ("f32", "pair", "bf16"):
            return rounded(t, mode)
        return rounded(t, "bf16" if mode == "bf16:" + op else "pair")
    return rnd


def bwd(x, dt, A, B, C, D, dy, dfin, s0, mode):
    """The kernel's passes (chunks of Q, groups of GROUP heads) with its
    f32-made operands rounded as ``mode`` says."""
    return scan_bwd_passes(x, dt, A, B, C, D, dy, dfin, initial_state=s0,
                           chunk=Q, made=made(mode))


def share(name, got, want) -> float:
    """The gradient's error over its gate, dx / dB / dC written in bf16."""
    if name in ("dx", "dB", "dC"):
        got = got.to(torch.bfloat16).float()
        err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        return err / 1e-2
    return float((got - want).abs().max()) / 1e-4 / \
        max(float(want.abs().max()), 1e-30)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    for dt_scale in (1.0, 10.0):
        g = torch.Generator().manual_seed(a.seed)
        dt0 = dt_scale * torch.exp(torch.rand(H, generator=g) * (
            math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        bias = dt0 + torch.log(-torch.expm1(-dt0))
        dt = torch.nn.functional.softplus(
            0.5 * torch.randn((a.batch, a.seq, H), generator=g) + bias)
        A = -(1.0 + 15.0 * torch.rand(H, generator=g))
        D = 1.0 + 0.1 * torch.randn(H, generator=g)

        def draw(*shape):
            return torch.randn(shape, generator=g).bfloat16().float()
        x, dy = draw(a.batch, a.seq, H, P), draw(a.batch, a.seq, H, P)
        B, C = draw(a.batch, a.seq, N), draw(a.batch, a.seq, N)
        s0 = torch.randn((a.batch, H, P, N), generator=g)
        dfin = torch.randn((a.batch, H, P, N), generator=g)
        args = (x, dt, A, B, C, D, dy, dfin, s0)
        want = bwd(*args, "f32")
        worst = {}
        for mode in ("pair", "bf16") + tuple("bf16:" + o for o in OPERANDS):
            got = bwd(*args, mode)
            worst[mode] = {n: round(share(n, gg, w), 4)
                           for n, gg, w in zip(NAMES, got, want)}
        print(json.dumps({"shape": f"Bt={a.batch} S={a.seq} H={H} P={P} "
                          f"N={N} chunk {Q} groups of {GROUP}",
                          "dt_scale": dt_scale, "seed": a.seed,
                          "share_of_gate": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
