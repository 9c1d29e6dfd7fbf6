#!/usr/bin/env python3
"""Time the paged_attention kernel at the llama serving shape (8 slots,
H=32, KV=8, D=64, page 16, 64-page bucket, bf16) over its launch plan
and the context length, to see where its time goes:

    python3 tools/paged_attention_sweep.py

For each blocks-per-SM target of the split plan (``BLOCKS_PER_SM``:
the plan takes the most splits that keep one wave of that many blocks
an SM) and each context length it prints the plan (heads a block, head
chunks, splits, pages a split), the kernel's median device time with
the L2 flushed before each launch (chip_smoke.Timer) and with the L2
warm, and the bytes the call must move; first, the same timers around
a one-element fill, the floor of any timed launch. Needs one CUDA
card.

    python3 tools/paged_attention_sweep.py --wide

times wide tables instead (512 to 8192 pages of 16 tokens, every page
live, 1 and 8 slots): the kernel's own plan, whose split length does
not depend on the width (so a wide table is thousands of splits that
the combine walks), beside a plan whose split length doubles until at
most 64 splits remain, with the bytes each call must move and their
time at the card's memory rate.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def warm_ms(fn, iters=50):
    for _ in range(5):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wide(timer) -> None:
    """The kernel at wide tables under its own plan and under one with
    at most 64 longer splits (``plan`` replaced for the call)."""
    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as pa
    h, kv, d, page = 32, 8, 64, 16
    own = pa.plan

    def capped(*args):
        pl = own(*args)
        pps = pl.pages_per_split
        while -(-args[3] // pps) > 64:
            pps *= 2
        return pl._replace(n_split=-(-args[3] // pps), pages_per_split=pps)
    for b in (1, 8):
        for maxp in (512, 1024, 2048, 4096, 8192):
            nb = b * maxp
            q = torch.randn((b, h, d), device="cuda").bfloat16()
            kp = torch.randn((nb, page, kv, d), device="cuda").bfloat16()
            vp = torch.randn((nb, page, kv, d), device="cuda").bfloat16()
            table = torch.randperm(nb, device="cuda").reshape(
                b, maxp).to(torch.int32)
            ctx = torch.full((b,), maxp * page, dtype=torch.int32,
                             device="cuda")

            def call():
                return pa.paged_attention(q, kp, vp, table, ctx)
            row = {"b": b, "pages": maxp, "ctx": maxp * page}
            for name, fn in (("own", own), ("capped", capped)):
                pa.plan = fn
                row[f"plan_{name}"] = fn(
                    b, h, kv, maxp, page, pa._sm_count(0))._asdict()
                row[f"ms_{name}"] = timer.ms(call)
                row[f"out_{name}"] = call()
            pa.plan = own
            diff = (row.pop("out_own").float()
                    - row.pop("out_capped").float()).abs().max()
            n_bytes = 2 * b * maxp * page * kv * d * 2
            row.update(max_abs_diff=float(diff), bytes=n_bytes,
                       bytes_ms=n_bytes / cs.HBM_BYTES_PER_S * 1e3)
            print(json.dumps(row), flush=True)
            del q, kp, vp
            torch.cuda.empty_cache()


def main() -> int:
    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as pa
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    b, h, kv, d, page, maxp = 8, 32, 8, 64, 16, 64
    rng = np.random.default_rng(0)
    nb = b * maxp + 1
    q = torch.randn((b, h, d), device="cuda").bfloat16()
    kp = torch.randn((nb, page, kv, d), device="cuda").bfloat16()
    vp = torch.randn((nb, page, kv, d), device="cuda").bfloat16()
    table = torch.from_numpy(rng.permutation(nb)[:b * maxp].reshape(
        b, maxp).astype(np.int32)).cuda()
    timer = cs.Timer()
    if "--wide" in sys.argv[1:]:
        wide(timer)
        return 0
    tiny = torch.zeros(1, device="cuda")
    print(json.dumps({"one_element_fill_ms_cold_l2": timer.ms(tiny.zero_),
                      "one_element_fill_ms_warm_l2": warm_ms(tiny.zero_)}))
    default = pa.BLOCKS_PER_SM
    for per_sm in (1, 2, 4, 8, 16):
        pa.BLOCKS_PER_SM = per_sm
        for ctx in (16, 256, 1024):
            ctx_t = torch.full((b,), ctx, dtype=torch.int32, device="cuda")

            def call():
                return pa.paged_attention(q, kp, vp, table, ctx_t)
            plan = pa.plan(b, h, kv, maxp, page, pa._sm_count(0))
            print(json.dumps({
                "blocks_per_sm": per_sm, "ctx": ctx, "plan": plan._asdict(),
                "bytes": 2 * b * ctx * kv * d * 2,
                "ms_cold_l2": timer.ms(call), "ms_warm_l2": warm_ms(call)}),
                flush=True)
    pa.BLOCKS_PER_SM = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
