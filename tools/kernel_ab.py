#!/usr/bin/env python3
"""Time hand-written kernels of several checkouts of this repo in turns
on one card, for a before/after comparison inside one call:

    python3 tools/kernel_ab.py OLD NEW NEW OLD
    python3 tools/kernel_ab.py --kernels mamba_chunk_scan OLD NEW NEW OLD
    python3 tools/kernel_ab.py --kernels flash_attention,attention_served,\
flash_segments,flash_train:1 OLD NEW NEW OLD
    python3 tools/kernel_ab.py --kernels fmmu_fsm OLD NEW NEW OLD
    python3 tools/kernel_ab.py --harness NEW --kernels flash_train,\
attention_d256 OLD NEW NEW OLD
    python3 tools/kernel_ab.py --harness NEW --kernels paged_attention,\
attention_served:1,attention_d256:1 OLD NEW NEW OLD

Each positional argument is the root of a checkout (its chip_smoke.py
and src/). ``--harness DIR`` takes the checks from DIR's chip_smoke.py
for every checkout (the kernels, their wrappers and their build still
come from each checkout's src/): a shape that only the newer checkout's
smoke holds is then timed on the older kernels too, through the same
code. ``--kernels`` names the checks to run, comma-separated
(default: paged_attention,flash_attention): each is chip_smoke.py's
``check_<name>``, which holds the kernel against its plain version and
times it (given, by its parameters' names, the timer, a seeded numpy
generator and nvcc's build logs). A check that returns a tuple (the
attention shapes': the flash row, then the paged row) gives its first
element, or element N when named ``<name>:N`` (``attention_served:1``
is the paged rows, ``flash_train:1`` the flash backward's); a checkout without a check prints it under
``missing``. Each run is a
process of its own: it builds the kernels those checks run from that
checkout's csrc/ into the checkout's build/ and prints one JSON line:
every timing, error and plan key of each row (``ms``, ``plain_ms``,
``library_ms``, ``bound_ms``, ``max_abs_err``, ``plan``, fmmu_fsm's ``steps`` and
``ns_per_step``, the scan backward's ``scratch_bytes_train`` and
``launches_per_call``, and their per-shape ``*_<tag>`` forms) and, from the
checkout's own ``ptxas_resources``,
the registers, spills and static shared memory of every entry function
it built (nvcc's -Xptxas -v; none when the checkout's build/ already
held the libraries). Prints the card's name and power limit first;
exits nonzero if a run fails.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

CHILD = r"""
import inspect, json, re, sys
import numpy as np, torch
root, names, harness = sys.argv[1], sys.argv[2].split(","), sys.argv[3]
sys.path[:0] = [harness, root + "/src"]
import chip_smoke as cs
from repro_torch.kernels import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the csrc/ sources each check runs, where they differ from its name
sources = {"mamba_chunk_scan": ["mamba_scan"],
           "attention_served": ["flash_attention", "paged_attention"],
           "attention_d256": ["flash_attention", "paged_attention"],
           "flash_segments": ["flash_attention"],
           "flash_train": ["flash_attention", "flash_attention_bwd"],
           "mamba_chunk_scan_bwd": ["mamba_scan_bwd"]}
specs = [(n.split(":")[0], int(n.split(":")[1]) if ":" in n else 0, n)
         for n in names]
have = [s for s in specs if hasattr(cs, "check_" + s[0])]
build = sorted({src for n, _, _ in have for src in sources.get(n, [n])})
logs = _build.build_all(tuple(build))
regs = cs.ptxas_resources(logs, tuple(build))
torch.manual_seed(cs.SEED)
timer = cs.Timer()
rng = np.random.default_rng(cs.SEED)
keys = re.compile(r"^(name|(first_version_)?(ms|ns_per_step)|plain_ms|"
                  r"library_ms|bound_ms|max_abs_err|err|lse_err|steps|"
                  r"scratch_bytes|launches_per_call|plan)(_.*)?$")
rows = []
args = {"timer": timer, "rng": rng, "logs": logs}
for name, index, spec in have:
    check = getattr(cs, "check_" + name)
    r = check(*(args[p] for p in inspect.signature(check).parameters))
    if isinstance(r, tuple):
        r = r[index]
    rows.append(dict({k: v for k, v in r.items() if keys.match(k)},
                     check=spec))
print(json.dumps({"root": root, "harness": harness, "kernels": rows,
                  "missing": [s[2] for s in specs if s not in have],
                  "registers": regs}))
"""


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="paged_attention,flash_attention")
    ap.add_argument("--harness", default=None,
                    help="checkout whose chip_smoke.py checks every root")
    ap.add_argument("roots", nargs="+")
    a = ap.parse_args(argv)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    for root in a.roots:
        res = subprocess.run([sys.executable, "-c", CHILD, root, a.kernels,
                              a.harness or root],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
