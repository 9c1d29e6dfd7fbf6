#!/usr/bin/env python3
"""Time the two attention kernels of several checkouts of this repo in
turns on one card, for a before/after comparison inside one call:

    python3 tools/attention_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout (its chip_smoke.py and src/).
Each run is a process of its own: it builds that checkout's attention
kernels into the checkout's build/ and calls the checkout's
check_paged_attention and check_flash_attention from chip_smoke.py,
which hold the kernels against their plain versions and time them at
the serving shapes. Prints the card's name and power limit, then one
JSON line per run; exits nonzero if a run fails.
"""
from __future__ import annotations

import subprocess
import sys

CHILD = r"""
import json, sys
import numpy as np, torch
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import chip_smoke as cs
from repro_torch.kernels import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all(("paged_attention", "flash_attention"))
torch.manual_seed(cs.SEED)
timer = cs.Timer()
rows = [cs.check_paged_attention(timer, np.random.default_rng(cs.SEED)),
        cs.check_flash_attention(timer)]
keys = ("name", "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")
print(json.dumps({"root": root,
                  "kernels": [{k: r[k] for k in keys} for r in rows]}))
"""


def main(roots) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    for root in roots:
        res = subprocess.run([sys.executable, "-c", CHILD, root],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
