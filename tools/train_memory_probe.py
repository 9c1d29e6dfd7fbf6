#!/usr/bin/env python3
"""A train run's peak memory and loss curve at other depths, on the
card: the measurements behind a memory plan (PERF.md: the largest even
depth whose peak leaves 8 GB of the card free) and behind a train run's
learning rate.

    python3 tools/train_memory_probe.py --run llava [--layers 2,4,12]
        [--set KEY=VALUE ...]

``--run`` names one of ``chip_smoke.py``'s train runs (llama, ssm,
gemma, llava, seamless: TRAIN, TRAIN_SSM, TRAIN_GEMMA, TRAIN_LLAVA,
TRAIN_SEAMLESS); each depth of ``--layers`` (default: the run's own)
runs ``chip_smoke.train_run`` on that spec with its gates and parity
off. ``--set`` overrides a key of the spec, its value read as JSON
(``--set batch=4``, ``--set lr=1e-3``, ``--set 'kernel_impl="ref"'``
for the plain versions, ``--set steps=3``). For each depth it prints
one JSON line: the peak of ``torch.cuda.max_memory_allocated`` (GB and
GiB), the card's memory, the free GB the peak leaves, each step's loss
and gradient norm, the median step ms; a step that runs out of memory
prints its error instead. With two or more depths, a last line fits the
peak's growth a layer and names the largest even depth whose predicted
peak leaves 8 GB free. The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

RUNS = {"llama": "TRAIN", "ssm": "TRAIN_SSM", "gemma": "TRAIN_GEMMA",
        "llava": "TRAIN_LLAVA", "seamless": "TRAIN_SEAMLESS"}
FREE_GB = 8.0


def probe(spec, layers) -> dict:
    """``chip_smoke.train_run`` of ``spec`` at ``layers`` decoder layers,
    gates and parity off: its peak memory and curves, or the error of a
    step that ran out of memory."""
    out = {"arch": spec["arch"], "layers": layers, "batch": spec["batch"],
           "lr": spec["lr"], "kernel_impl": spec.get("kernel_impl"),
           "steps": spec["steps"]}
    total = torch.cuda.mem_get_info()[1]
    try:
        line = cs.train_run(dict(spec, n_layers=layers), gates=False)
        peak = line["peak_mem_gb"] * 1e9
        out.update(loss=line["losses"], grad_norm=line["grad_norm"],
                   step_ms_median=line["step_ms_median"])
    except torch.OutOfMemoryError as e:
        out["error"] = str(e).splitlines()[0]
        peak = torch.cuda.max_memory_allocated()
    cs.free_engine()
    out.update(peak_gb=peak / 1e9, peak_gib=peak / 2 ** 30,
               card_gb=total / 1e9, free_gb=(total - peak) / 1e9)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", required=True, choices=sorted(RUNS))
    ap.add_argument("--layers", default=None)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_memory_probe: no card", file=sys.stderr)
        return 2
    cs._setup()
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    spec = dict(getattr(cs, RUNS[args.run]))
    for kv in args.set:
        key, _, value = kv.partition("=")
        spec[key] = json.loads(value)
    published = get_arch(spec["arch"]).n_layers
    depth = spec.get("n_layers", published)
    layers = [int(x) for x in (args.layers or str(depth)).split(",")]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    peaks = {}
    for n in layers:
        line = probe(spec, n)
        if "error" not in line:
            peaks.setdefault(n, line["peak_gb"])
        print(json.dumps(line), flush=True)
    if len(peaks) >= 2:
        (a, pa), (b, pb) = sorted(peaks.items())[:2]
        slope = (pb - pa) / (b - a)
        base = pa - a * slope
        card = torch.cuda.mem_get_info()[1] / 1e9
        fits = [n for n in range(2, published + 1, 2)
                if base + slope * n <= card - FREE_GB]
        print(json.dumps({"gb_per_layer": slope, "gb_fixed": base,
                          "card_gb": card, "free_gb_asked": FREE_GB,
                          "largest_even_depth": max(fits, default=None),
                          "predicted_peak_gb": {
                              n: base + slope * n for n in fits[-2:]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
