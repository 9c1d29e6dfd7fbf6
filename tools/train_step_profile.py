#!/usr/bin/env python3
"""Where one training step's time goes, on the card:

    python3 tools/train_step_profile.py [--arch mamba2-1.3b] [--top 30]
                                        [--runs K] [--layers N] [--steps N]

``--runs K`` first repeats ``chip_smoke.train_run`` (the smoke's whole
30-step run with its gates) K times in this process and prints each
run's step median, the spread of its steps (min, quartiles, max),
tokens/s, mfu, peak memory, first and last loss and the scan and flash
kernels' launches: the spread of the smoke's figure on one tree.

Builds the architecture at published widths and at the depth of
``chip_smoke.py``'s train run for it (gemma2-9b: ``TRAIN_GEMMA``'s cut;
``--layers`` sets another) as those runs do (bf16 compute, f32
parameters and AdamW moments, seeded weights, remat 'dots', one packed
8 x 1024 batch of ``chip_smoke.train_batch``), takes three warm-up
steps, then:

- times the forward (``loss_fn``), the backward (``autograd.grad``) and
  the optimizer (``adamw_update``) of ``--steps`` more steps (2) with
  CUDA events recorded at the phase marks of the step itself (``make_train_step``'s
  ``on_phase``), the step ``chip_smoke.py``'s train runs time;
- profiles one whole step with ``torch.profiler`` and prints one JSON
  line of its device time: the sum of its kernels, that of the kernels
  launched inside the forward and the optimizer phases (the backward's
  run on autograd's own thread, outside the phase's range) and each
  flash kernel's calls and ms; then the ``--top`` rows by self device
  time (ms and calls), then by self host time.

Prints the card's name and power limit first, then one JSON line of the
event times (and their steps' median), then the tables. Run from a
checkout whose ``chip_smoke.py`` has no gemma2 run (an older tree, for
a comparison in turns), ``--arch gemma2-9b`` still builds the cut model
from ``--layers`` (``--runs`` needs the checkout's own run). The
profiler's own cost is in its step (its wall time is printed beside);
its device times are per kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=cs.TRAIN_SSM["arch"])
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--runs", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=2)
    a = ap.parse_args(argv)
    from repro_torch.configs import get_arch
    from repro_torch.models import Runtime, build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    cs._setup()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    specs = [getattr(cs, n) for n in ("TRAIN", "TRAIN_SSM", "TRAIN_GEMMA")
             if hasattr(cs, n)]
    spec = next((s for s in specs if s["arch"] == a.arch), None)
    if spec is None and a.arch == "gemma2-9b":
        spec = dict(cs.TRAIN, arch=a.arch, vocab=256000, n_layers=4)
    if a.layers:
        spec = dict(spec, n_layers=a.layers)
    for i in range(a.runs):
        line = cs.train_run(spec)
        ms = sorted(line["step_ms"])
        q = len(ms) // 4
        print(json.dumps({"run": i, **{k: line[k] for k in (
            "arch", "step_ms_median", "tokens_per_s", "mfu",
            "peak_mem_gib")}, "step_ms_min_q1_q3_max": [
                ms[0], ms[q], ms[-1 - q], ms[-1]],
            "losses_first_last": [line["losses"][0], line["losses"][-1]],
            "launches": {k: v for k, v in line["launches"].items()
                         if k.startswith("mamba") or "flash" in k}}),
              flush=True)
    cfg = get_arch(a.arch)
    if "n_layers" in spec:
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    model = build_model(cfg, Runtime(compute_dtype=torch.bfloat16,
                                     param_dtype=torch.float32,
                                     remat="dots"), device="cuda")
    ocfg = opt.AdamWConfig(lr=spec["lr"], warmup_steps=spec["warmup_steps"],
                           decay_steps=spec["decay_steps"])
    marks = []                      # (phase, event) while timing
    ranges = []                     # the profiled step's open phase range

    def on_phase(name):
        if timing:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        if profiling:
            if ranges:
                ranges.pop().__exit__(None, None, None)
            if name != "end":
                ranges.append(record_function(f"phase:{name}"))
                ranges[-1].__enter__()
    timing = profiling = False
    step, init = make_train_step(model, ocfg, on_phase=on_phase)
    state = init(torch.Generator(device="cuda").manual_seed(cs.SEED))
    batch = cs.train_batch(0, spec)
    for _ in range(3):
        state, met = step(state, batch)
        float(met["loss"])
    times = []
    for _ in range(a.steps):
        marks.clear()
        timing = True
        state, met = step(state, batch)
        timing = False
        float(met["loss"])
        torch.cuda.synchronize()
        times.append({f"{name}_ms": ev.elapsed_time(nxt)
                      for (name, ev), (_, nxt) in zip(marks, marks[1:])})
    print(json.dumps({"arch": a.arch, "layers": cfg.n_layers,
                      "events": times, "step_ms_median": statistics.median(
                          sum(t.values()) for t in times)}), flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiling = True
        state, met = step(state, batch)
        profiling = False
        float(met["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"profiled step: {wall * 1e3:.1f} ms wall", flush=True)
    ka = prof.key_averages()

    def dev(e, kind=""):
        return getattr(e, kind + "device_time_total",
                       getattr(e, kind + "cuda_time_total", 0))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    print(json.dumps({"profiled_device_ms": {
        "kernels": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
        **{e.key[6:]: dev(e) / 1e3 for e in ka
           if e.key.startswith("phase:") and e.key != "phase:backward"},
        "flash": {re.search(r"flash_\w+", e.key)[0]: [
            e.count, dev(e, "self_") / 1e3] for e in ka
            if "flash_" in e.key and e.device_type == DeviceType.CUDA}}}),
          flush=True)
    print("by self device time (ms, calls, name):")
    for e in sorted(ka, key=lambda e: -dev(e, "self_"))[:a.top]:
        print(f"{dev(e, 'self_') / 1e3:10.3f} {e.count:7d}  {e.key[:100]}")
    print("by self host time (ms, calls, name):")
    for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:a.top]:
        print(f"{e.self_cpu_time_total / 1e3:10.3f} {e.count:7d}  "
              f"{e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
