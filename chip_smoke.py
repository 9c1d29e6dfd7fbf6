#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA
card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and passed over):
  1. build   — nvcc builds every kernel of the serving path from
               src/repro_torch/csrc (one process per source, all started
               together); prints the card's name and power limit.
  2. kernels — each CUDA kernel against its plain torch version on the
               card, on the shapes the serving path gives it: the fused
               translate probe bit-exact, the two attention kernels
               within the bf16 tolerance 2e-2 (f32 variants within
               1e-4). Times the kernel, the plain version, the bound and
               the PyTorch library call where one exists.
  3. serve   — llama3.2-1b at its published widths (bf16, page 16,
               8 slots x 2048 ctx, random weights from a seed) serves
               8 requests of 64..1024 prompt tokens for 32 new tokens
               each; every kernel's launch counter must be > 0 in that
               run. Then a 2-layer full-width f32 engine must emit the
               same greedy tokens with the kernels as with
               kernel_impl="ref".

Output: the ptxas resource lines on stderr; on stdout, before the last
line, the card's name and power limit, one JSON line {"kernels": [...]}
and one JSON line {"serve": {...}}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
            "int32": 67e12}          # dense peaks, H100 SXM data sheet
BF16_TOL = 2e-2
F32_TOL = 1e-4
SEED = 0


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------- timing
class Timer:
    """Median device time of one call. Before each launch the GPU is
    kept busy by a spin kernel while the host enqueues the call, so the
    events time the device work and not the wrapper's host overhead; the
    L2 is flushed first (the serving path finds its KV and weights cold:
    16 layers' pools and weights cycle through the 50 MB L2)."""

    SPIN_CYCLES = 10_000_000       # ~5 ms at the H100's clock

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.flush.zero_()
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


# --------------------------------------------------------------- kernels
def check_fmmu_translate(timer, rng):
    from repro_torch.core.fmmu.types import HOST_BASE
    from repro_torch.kernels.fmmu_translate import (fmmu_translate,
                                                    fmmu_translate_ref)

    def inputs(s, w, e, n_backing, bq, dup):
        tags = torch.from_numpy(
            (rng.integers(0, 64, (s, w)) * s + np.arange(s)[:, None])
            .astype(np.int32))
        if dup:
            tags[:, -1] = tags[:, 0]
        valid = torch.from_numpy(rng.random((s, w)) < 0.7)
        if dup:
            valid[:, 0] = valid[:, -1] = True
        refb = torch.from_numpy(rng.random((s, w)) < 0.3)
        data = torch.from_numpy(rng.integers(
            -1, HOST_BASE * 4, (s, w, e)).astype(np.int32))
        backing = torch.from_numpy(rng.integers(
            -1, HOST_BASE * 4, (n_backing,)).astype(np.int32))
        dl = rng.integers(-2, n_backing + 3, (bq,))
        dl[: min(bq, s)] = tags[: min(bq, s), 0].numpy() * e + 1  # hits
        dl[-3:] = [-1, n_backing + 1, -2]
        dlpns = torch.from_numpy(dl.astype(np.int32))
        touch = torch.from_numpy(rng.random((bq,)) < 0.6)
        return [t.cuda() for t in (tags, valid, refb, data, backing, dlpns,
                                   touch)], e

    cases = [(16, 4, 8, 1024, 8, False), (16, 4, 8, 1024, 128, True),
             (512, 4, 8, 262144, 4096, True), (4, 1, 4, 100, 33, False)]
    for s, w, e, n_backing, bq, dup in cases:
        args, e = inputs(s, w, e, n_backing, bq, dup)
        got = fmmu_translate(*args, entries_per_block=e)
        want = fmmu_translate_ref(*args, entries_per_block=e)
        torch.cuda.synchronize()
        for name, g, x in zip(("hit", "dppn", "set", "way", "ref"), got,
                              want):
            if g.dtype != x.dtype or not torch.equal(g, x):
                fail(f"fmmu_translate {name} differs at S={s} Bq={bq}")
    # the serving path's commit: one decode step's page growth, 8 lanes
    # against the _geometry(8, 128) map (16 sets x 4 ways x 8 entries)
    args, e = inputs(16, 4, 8, 1024, 8, False)
    hit = fmmu_translate_ref(*args, entries_per_block=e)[0]
    active = args[5] >= 0
    n_miss = int((active & ~hit).sum())
    s, w = 16, 4
    n_bytes = (s * w * (4 + 1 + 1) + s * w * e * 4 + 4 * n_miss
               + 8 * (4 + 1) + 8 * (1 + 4 + 4 + 4) + s * w)
    b_ms, b_by = bound_ms(n_bytes, 8 * (w + 4), "int32")
    return {
        "name": "fmmu_translate", "route": "cuda",
        "source": "src/repro_torch/csrc/fmmu_translate.cu",
        "replaces": "src/repro/kernels/fmmu_translate.py:115",
        "max_abs_err": 0.0,
        "ms": timer.ms(lambda: fmmu_translate(*args, entries_per_block=e)),
        "plain_ms": timer.ms(
            lambda: fmmu_translate_ref(*args, entries_per_block=e)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": "S=16 W=4 E=8 NP=1024 lanes=8",
    }


def _sdpa(q, k, v, **kw):
    import torch.nn.functional as F
    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:          # older torch: expand the KV heads
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), **kw)


def check_paged_attention(timer, rng):
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    b, h, kv, d, page = 8, 32, 8, 64, 16
    nb = b * 128 + 1

    def inputs(maxp, dtype, ctx=None):
        q = torch.randn((b, h, d), device="cuda").to(dtype)
        kp = torch.randn((nb, page, kv, d), device="cuda").to(dtype)
        vp = torch.randn((nb, page, kv, d), device="cuda").to(dtype)
        table = torch.from_numpy(rng.permutation(nb)[:b * maxp]
                                 .reshape(b, maxp).astype(np.int32)).cuda()
        if ctx is None:
            ctx = rng.integers(1, maxp * page + 1, (b,))
        return q, kp, vp, table, torch.tensor(np.asarray(ctx, np.int32),
                                              device="cuda")

    worst = 0.0
    for maxp in (4, 8, 16, 32, 64, 128):
        args = inputs(maxp, torch.bfloat16)
        got, (m, l) = paged_attention(*args, return_stats=True)
        want, (wm, wl) = paged_attention_ref(*args, return_stats=True)
        err = _max_err(got, want)
        worst = max(worst, err)
        if err > BF16_TOL or _max_err(m, wm) > 1e-3 or \
                float(((l - wl).abs() / wl.clamp_min(1e-6)).max()) > 1e-3:
            fail(f"paged_attention bucket {maxp}: max err {err}")
    for kw in (dict(softcap=30.0), dict(window=100),
               dict(window=40, softcap=20.0)):
        args = inputs(32, torch.float32)
        err = _max_err(paged_attention(*args, **kw),
                       paged_attention_ref(*args, **kw))
        if err > F32_TOL:
            fail(f"paged_attention f32 {kw}: max err {err}")
    # the serving path's shape: 8 slots at ctx 1024 (bucket 64 pages)
    ctx = 1024
    args = inputs(64, torch.bfloat16, ctx=[ctx] * b)
    n_bytes = (2 * b * ctx * kv * d * 2 + 2 * b * h * d * 2
               + 4 * b * 64 + 4 * b)
    b_ms, b_by = bound_ms(n_bytes, 4 * b * h * d * ctx, "bfloat16")
    q, kp, vp, table, ctx_t = args
    kg = kp[table.long()].reshape(b, 64 * page, kv, d).transpose(1, 2)
    vg = vp[table.long()].reshape(b, 64 * page, kv, d).transpose(1, 2)
    kg, vg, q4 = kg.contiguous(), vg.contiguous(), q[:, :, None, :]
    return {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:85",
        "max_abs_err": worst,
        "ms": timer.ms(lambda: paged_attention(*args)),
        "plain_ms": timer.ms(lambda: paged_attention_ref(*args)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: _sdpa(q4, kg, vg)),
        "shape": "B=8 H=32 KV=8 D=64 P=16 ctx=1024 bf16",
    }


def check_flash_attention(timer):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    h, kv, d = 32, 8, 64

    def inputs(s, dtype):
        return [torch.randn((1, s, n, d), device="cuda").to(dtype)
                for n in (h, kv, kv)]

    worst = 0.0
    for s in (100, 512, 1000):
        args = inputs(s, torch.bfloat16)
        err = _max_err(flash_attention(*args),
                       flash_attention_ref(*args))
        worst = max(worst, err)
        if err > BF16_TOL:
            fail(f"flash_attention S={s}: max err {err}")
    for kw in (dict(window=64), dict(softcap=30.0),
               dict(causal=False, bidirectional=True)):
        args = inputs(300, torch.float32)
        err = _max_err(flash_attention(*args, **kw),
                       flash_attention_ref(*args, **kw))
        if err > F32_TOL:
            fail(f"flash_attention f32 {kw}: max err {err}")
    s = 1000
    args = inputs(s, torch.bfloat16)
    pairs = s * (s + 1) // 2                       # causal (q, k) pairs
    n_bytes = 2 * (2 * s * h * d + 2 * s * kv * d)
    b_ms, b_by = bound_ms(n_bytes, 4 * d * pairs * h, "bfloat16")
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in args)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:83",
        "max_abs_err": worst,
        "ms": timer.ms(lambda: flash_attention(*args)),
        "plain_ms": timer.ms(lambda: flash_attention_ref(*args)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(
            lambda: _sdpa(qt, kt, vt, is_causal=True)),
        "shape": "B=1 S=1000 H=32 KV=8 D=64 causal bf16",
    }


# ----------------------------------------------------------------- serve
def build_engine(cfg, rt):
    from repro_torch.models import build_model
    from repro_torch.serving import ServeConfig, ServeEngine
    m = build_model(cfg, rt, device="cuda")
    params = m.init(torch.Generator(device="cuda").manual_seed(SEED))
    return ServeEngine(m, params, config=ServeConfig(n_slots=8, max_ctx=2048),
                       device="cuda")


def run_requests(eng, prompts, max_new):
    """Submit all prompts at once, run to completion. Returns
    ({rid: tokens}, [Request], wall seconds)."""
    reqs = []
    for p in prompts:
        eng.submit(p, max_new=max_new)
        reqs.append(eng.queue[-1])
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {r.rid: done[r.rid] for r in reqs}, reqs, wall


def profile_decode_step(eng, prompts):
    """Device busy time, idle share and the top kernels of one steady
    decode step (8 resident slots, no admission, no page growth), from
    torch.profiler around one ServeEngine.step()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        eng.submit(p, max_new=8)
    done: dict = {}
    eng.step(done)               # admission + prefill + first decode step
    eng.step(done)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step(done)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev = {e.key: e.self_device_time_total / 1e3 for e in kern}
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None,
            "device_launches": sum(e.count for e in kern),
            "top_kernels_ms": {k[:70]: v for k, v in top}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_arch
    from repro_torch.core.counters import COUNTERS
    from repro_torch.kernels import _build
    from repro_torch.models import Runtime

    # 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", file=sys.stderr)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"build: {len(logs)} kernels in {build_s:.1f} s", file=sys.stderr)

    # 2. kernels against their plain versions ----------------------------
    rng = np.random.default_rng(SEED)
    torch.manual_seed(SEED)
    timer = Timer()
    rows = [check_fmmu_translate(timer, rng),
            check_paged_attention(timer, rng),
            check_flash_attention(timer)]
    print("kernels: all match their plain versions", file=sys.stderr)

    # 3. the serving run at full width -----------------------------------
    cfg = get_arch("llama3.2-1b")
    rt = Runtime(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                 page_size=16)
    eng = build_engine(cfg, rt)
    prng = np.random.default_rng(SEED + 1)
    lens = [64, 128, 256, 384, 512, 640, 768, 1024]
    prompts = [[int(t) for t in prng.integers(0, cfg.vocab_size, n)]
               for n in lens]
    run_requests(eng, [prompts[0][:16]], 2)        # warm-up
    eng.metrics = {k: 0 for k in eng.metrics}
    COUNTERS.reset()                     # every count to 0 just before
    torch.cuda.reset_peak_memory_stats()
    out, reqs, wall = run_requests(eng, prompts, 32)
    launches = COUNTERS.launches()       # ... and read just after
    counts = COUNTERS.snapshot()
    for r in reqs:
        toks_r = out[r.rid]
        if len(toks_r) != 32 or not all(0 <= t < cfg.vocab_size
                                        for t in toks_r):
            fail(f"request {r.rid} returned {len(toks_r)} tokens")
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
        if row["launches"] <= 0:
            fail(f"{row['name']} was not launched on the serving path")
    ttft = sorted((r.t_first - r.t_submit) * 1e3 for r in reqs)
    decode_s = max(r.t_done for r in reqs) - max(r.t_first for r in reqs)
    decode_toks = sum(len(out[r.rid]) - 1 for r in reqs)
    steps = eng.metrics["decode_steps"]
    serve_line = {
        "model": cfg.name, "dtype": "bfloat16", "page_size": 16,
        "n_slots": 8, "max_ctx": 2048, "prompt_lens": lens, "max_new": 32,
        "wall_s": wall, "ttft_ms_median": statistics.median(ttft),
        "ttft_ms_max": ttft[-1], "decode_tok_s": decode_toks / decode_s,
        "decode_step_ms": decode_s / max(steps - 1, 1) * 1e3,
        "decode_steps": steps, "prefills": eng.metrics["prefills"],
        "xlate_calls": counts.get("kvm.xlate_calls", 0),
        "host_syncs": counts.get("engine.host_syncs", 0),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "build_s": build_s}
    serve_line["profiled_decode_step"] = profile_decode_step(eng, prompts)
    del eng
    torch.cuda.empty_cache()

    # 4. kernels vs plain versions end to end: 2 layers, f32 -------------
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    short = [p[:n // 4] for p, n in zip(prompts, lens)]
    toks = {}
    for impl in (None, "ref"):
        rt32 = Runtime(compute_dtype=torch.float32,
                       param_dtype=torch.float32, page_size=16,
                       kernel_impl=impl)
        e2 = build_engine(cfg2, rt32)
        toks[impl], _, _ = run_requests(e2, short, 16)
        del e2
        torch.cuda.empty_cache()
    if list(toks[None].values()) != list(toks["ref"].values()):
        fail("2-layer f32 engine: kernel tokens differ from ref tokens")
    serve_line["ref_parity_tokens"] = sum(len(v) for v in toks["ref"].values())

    # report -------------------------------------------------------------
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"serve": serve_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
