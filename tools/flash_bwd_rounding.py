#!/usr/bin/env python3
"""Emulate, on the CPU, the operand rounding of the bf16 flash attention
backward's tensor-core body, and hold it against the same arithmetic in
f32:

    python3 tools/flash_bwd_rounding.py [--batch 2] [--seed 0]

The body computes S = Q K^T and dP = dO V^T from bf16 inputs with f32
sums, then P and dS in f32, and must round P and dS to enter the bf16
products dV += P^T dO, dQ += dS K and dK += dS^T Q. For each choice of
that rounding ("bf16": one operand; "pair": a bf16 hi + lo pair, two
products) it prints the worst |error| / max(1, |ref|) of dq, dk and dv,
each rounded to bf16 as the kernel writes them, against the f32
arithmetic rounded alike: the metric and gate (2e-2) of
chip_smoke.check_flash_train. The shape is a training check's
at ``--batch`` of its 8 rows, one head at a time, causal with the packed
segment ids of make_batch's step 0: ``--shape llama`` (S 1024, H 32, KV
8, D 64; the head_dim 16-128 bodies) or ``--shape gemma2`` (S 1024, H
16, KV 8, D 256, softcap 50: the head_dim 256 bodies, where P and dS
also carry the softcap's derivative); inputs are seeded standard
normals rounded to bf16.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402

# (S, H, KV, D, softcap, vocabulary of the ids' make_batch)
SHAPES = {"llama": (1024, 32, 8, 64, 0.0, 128256),
          "gemma2": (1024, 16, 8, 256, 50.0, 256000)}


def rounded(t, how):
    if how == "f32":
        return t
    hi = t.to(torch.bfloat16).float()
    return hi if how == "bf16" else hi + (t - hi).to(torch.bfloat16).float()


def err(got, want) -> float:
    """The check's metric on bf16-rounded outputs."""
    got, want = (x.to(torch.bfloat16).float() for x in (got, want))
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shape", choices=sorted(SHAPES), default="llama")
    a = ap.parse_args(argv)
    b = a.batch
    S, H, KV, D, cap, vocab = SHAPES[a.shape]
    ids = torch.from_numpy(make_batch(DataConfig(
        vocab_size=vocab, seq_len=S, global_batch=8, pack=True),
        0)["segment_ids"][:b])
    i = torch.arange(S)
    mask = (i[None, :] <= i[:, None])[None] & (ids[:, :, None] ==
                                                 ids[:, None, :])
    g = torch.Generator().manual_seed(a.seed)

    def draw(*shape):
        return torch.randn(shape, generator=g).bfloat16().float()
    q, do = draw(b, S, H, D), draw(b, S, H, D)
    k, v = draw(b, S, KV, D), draw(b, S, KV, D)
    scale = 1.0 / math.sqrt(D)
    modes = ("f32", "bf16", "pair")
    worst = {m: {"dq": 0.0, "dk": 0.0, "dv": 0.0} for m in modes[1:]}
    for kvh in range(KV):
        dk = {m: torch.zeros(b, S, D) for m in modes}
        dv = {m: torch.zeros(b, S, D) for m in modes}
        for h in range(kvh * (H // KV), (kvh + 1) * (H // KV)):
            qh, doh, kh, vh = q[:, :, h], do[:, :, h], k[:, :, kvh], \
                v[:, :, kvh]
            logits = torch.einsum("bqd,bkd->bqk", qh * scale, kh)
            deriv = 1.0
            if cap:
                logits = cap * torch.tanh(logits / cap)
                deriv = 1.0 - (logits / cap) ** 2
            logits = logits.masked_fill(~mask, -math.inf)
            p = torch.exp(logits - torch.logsumexp(logits, -1)[..., None])
            out = torch.einsum("bqk,bkd->bqd", p, vh).bfloat16().float()
            delta = (doh * out).sum(-1)
            ds = p * (torch.einsum("bqd,bkd->bqk", doh, vh) -
                      delta[..., None]) * deriv
            dq = {}
            for m in modes:
                pm, dsm = rounded(p, m), rounded(ds, m)
                dq[m] = torch.einsum("bqk,bkd->bqd", dsm, kh) * scale
                dk[m] += torch.einsum("bqk,bqd->bkd", dsm, qh) * scale
                dv[m] += torch.einsum("bqk,bqd->bkd", pm, doh)
            for m in modes[1:]:
                worst[m]["dq"] = max(worst[m]["dq"], err(dq[m], dq["f32"]))
        for m in modes[1:]:
            worst[m]["dk"] = max(worst[m]["dk"], err(dk[m], dk["f32"]))
            worst[m]["dv"] = max(worst[m]["dv"], err(dv[m], dv["f32"]))
    print(json.dumps({"shape": f"B={b} S={S} H={H} KV={KV} D={D} causal "
                      f"packed ids softcap {cap:g}", "seed": a.seed,
                      "gate": 2e-2,
                      "worst": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
