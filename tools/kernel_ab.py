#!/usr/bin/env python3
"""Time hand-written kernels of several checkouts of this repo in turns
on one card, for a before/after comparison inside one call:

    python3 tools/kernel_ab.py OLD NEW NEW OLD
    python3 tools/kernel_ab.py --kernels mamba_chunk_scan OLD NEW NEW OLD

Each positional argument is the root of a checkout (its chip_smoke.py
and src/). ``--kernels`` names the kernels to time, comma-separated
(default: paged_attention,flash_attention). Each run is a process of its
own: it builds those kernels of that checkout into the checkout's
build/ and calls the checkout's ``check_<kernel>`` from chip_smoke.py,
which holds the kernel against its plain version and times it at the
serving shape. Prints the card's name and power limit, then one JSON
line per run; exits nonzero if a run fails.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

CHILD = r"""
import inspect, json, sys
import numpy as np, torch
root, names = sys.argv[1], sys.argv[2].split(",")
sys.path[:0] = [root, root + "/src"]
import chip_smoke as cs
from repro_torch.kernels import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the csrc/ source of each kernel, where its name differs
sources = {"mamba_chunk_scan": "mamba_scan"}
_build.build_all(tuple(sources.get(n, n) for n in names))
torch.manual_seed(cs.SEED)
timer = cs.Timer()
rows = []
for name in names:
    check = getattr(cs, "check_" + name)
    args = [timer, np.random.default_rng(cs.SEED)]
    rows.append(check(*args[:len(inspect.signature(check).parameters)]))
keys = ("name", "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")
print(json.dumps({"root": root,
                  "kernels": [{k: r[k] for k in keys} for r in rows]}))
"""


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="paged_attention,flash_attention")
    ap.add_argument("roots", nargs="+")
    a = ap.parse_args(argv)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    for root in a.roots:
        res = subprocess.run([sys.executable, "-c", CHILD, root, a.kernels],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
