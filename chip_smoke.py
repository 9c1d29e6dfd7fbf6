#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA
card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and passed over):
  1. build   — nvcc builds every kernel of the ported paths from
               src/repro_torch/csrc (one process per source, all started
               together); prints the card's name and power limit.
  2. kernels — each CUDA kernel against its plain torch version on the
               card, on the shapes its path gives it: the map commit
               (fmmu_commit) against its plain chain bit for bit (every
               state tensor and output, the serving map and the paper
               geometry, 1..4096 lanes, translate / batch / grow modes,
               three commits in a row; and the swap pipeline's commit:
               64 COND_UPDATE lanes of one slot to the host tier and
               back, a quarter with a stale old dppn, the guard refusing
               exactly those), the translate probe and the
               probe-only lookup bit-exact (ids past 1<<24), the two
               attention kernels within the bf16 tolerance 2e-2 (f16
               1e-2, f32 variants 1e-4; paged also at ctx 1024 and a
               ragged mix at 128 pages, its (m, l) within 1e-3 and
               repeated calls bit-identical), the Mamba2 scan within the
               Pallas tests' 8e-2 bf16 / 5e-3 f32 (S 1024, ragged 1000,
               65 and 1, with and without an initial state, repeats
               bit-identical). The commit's channel grid: at C in
               {2, 8, 32} on the paper geometry cut into 1/C shards, a
               64-lane mixed batch, a 1024-lane batch and a grow batch
               with one dry channel, each one launch of C blocks,
               bit-exact against the per-channel plain chain; each C's
               64-lane commit timed beside the one-block launch on the
               whole geometry, with its byte bound. The fault plane's
               commits at the llama serving map, at 1 and 8 channels: a
               retirement (4 COND_UPDATE lanes) and a restore (1024
               UPDATE lanes into a fresh state), one launch each,
               bit-exact, timed with their bounds. Times the kernel,
               the plain version, the bound and the PyTorch library
               call where one exists (for the scan also its blocked
               plain version, the kernel's arithmetic in many calls).
  3. serve   — llama3.2-1b at its published widths (bf16, page 16,
               8 slots x 2048 ctx, random weights from a seed) serves
               8 requests of 64..1020 prompt tokens for 32 new tokens
               each; every kernel of that path must be launched in that
               run. Then a 2-layer full-width f32 engine must emit the
               same greedy tokens with the kernels as with
               kernel_impl="ref".
  3b. serve (macro) — the same requests through the K-step macro path
               (macro_k=8: one CUDA graph replay per 8 tokens; the main
               path). A first pass captures the graphs; the second is
               counted: its tokens must equal the single-step tokens,
               it must capture nothing and make one dispatch and one
               host sync per K tokens with no host-side map work, and
               the replays must count fmmu_commit (one per step) and
               paged_attention (one per layer and step). The 1020-token
               prompt crosses from 64 to 65 pages inside a K-step run,
               so the token check spans a page-bucket change. Prints the
               graphs, capture seconds and pool bytes, one profiled
               steady macro step and one profiled retiring step (each
               hand kernel's counted launches must equal the replayed
               graph's kernel nodes of its name, read through libcuda,
               plus one fmmu_commit per eager map commit; the
               trace gives device time and its own launch counts as
               readings) and the in-graph map commit's cost, kernel
               beside plain chain (at most 4 launches, from the graph's
               nodes). Then the 2-layer f32 kernel-vs-ref parity in
               macro mode.
  3c. serve (swap) — the same requests at macro_k=8 on an undersized
               device pool: 128 device blocks for the 252-page working
               set, 256 host blocks (the pool's rows 128..383, in HBM
               like the device tier), swap_patience 4. Admission
               preempts slots to the host tier, and the boundary swap
               scheduler rotates them while the graphs mask them as
               swap-pending lanes. A first pass captures the graphs;
               the second is counted: its tokens (and the first's) must
               equal the full-pool macro tokens, pages must move both
               ways, each swap must be one map call and one fmmu_commit
               launch, and the pass must capture no graph. Prints the
               fallbacks, preemptions, decode tokens/s and TTFT beside
               the full-pool phase's, the pages and bytes moved, each
               swap's host dispatch ms and device ms (CUDA events)
               beside its byte bound, and the host syncs per K tokens.
  3d. serve (channels) — the same requests at macro_k=8 with the map
               sharded across 8 channels: each run's growth is
               pre-committed at the boundary (one map call, one
               fmmu_commit launch of 8 blocks) and the graphs decode
               against that table. A first pass captures the graphs;
               the second is counted: its tokens (and the first's) must
               equal the one-channel macro tokens, each run must be one
               dispatch and one host sync, each boundary at most one map
               call and one fmmu_commit launch, no graph may hold an
               fmmu_commit node (libcuda), no round may fall back, and
               every channel must service at least 1/(2C) of the lanes.
               Prints decode tokens/s, TTFT, each pre-commit's host
               dispatch ms and device ms (CUDA events behind a spin
               kernel, third pass) and the graphs' launches per K
               tokens beside the one-channel macro phase's. Then a
               2-layer f32 engine at 2 channels on the reference test's
               oversubscribed pool (10 device + 24 host blocks,
               macro_k=4): kernel tokens equal kernel_impl="ref" tokens.
  3e. serve (faults) — the swap phase's requests and pool under a
               seeded fault plan (swap 0.2, program 0.03, alloc 0.05;
               every axis must fire): swaps back off and one request is
               quarantined, bad blocks retire (one map call and one
               fmmu_commit launch each; after a K-step run the rows it
               wrote move too), allocations fail transiently. Three
               passes, each after a reset with a fresh plane (capture,
               counted, timed): the tokens must equal the full-pool
               macro phase's and the counted pass must capture nothing.
               Prints the retirements, quarantines, swap faults,
               fallbacks, decode tokens/s beside serve_swap's and each
               retirement's device ms (events behind a spin kernel)
               beside its byte bound and host dispatch ms. Then a
               2-layer f32 engine at 2 channels, oversubscribed, under
               the plan with a journal: kernel tokens and journal equal
               kernel_impl="ref"'s, frame for frame.
  3f. serve (recover) — the channel phase's configuration (8 channels)
               with program faults, channel 3 browned out and a journal:
               decode tokens/s journaled beside unjournaled, host ms per
               append and snapshot, journal bytes a record; then a power
               cut inside the first growth pre-commit's record (its OOB
               frame whole): the crashed engine recovers (its graphs
               kept: no variant captured twice) and drains, and so does
               a fresh engine from the same journal; both drains give
               the one-channel macro tokens, both recoveries take the
               OOB scan, each restore is one map call and one
               fmmu_commit launch. Prints MTTR (recover_s).
  4. map     — a seeded stream of mixed lookup / update / cond-update
               batches at the paper's CMT geometry goes through the
               fused path (the commit kernel), its plain version (the
               torch chain), the three unfused calls (the fmmu_lookup
               probe) and the 32-channel sharded path (the paper's
               32-channel SSD: 32 shards of the paper's CMT, one launch
               of 32 blocks a batch): final state and every output
               bit-identical, and the sharded path's outputs and
               interleaved table equal to the one-channel path's after
               every batch; the paths' times are printed (the paper's
               FMMU-vs-software comparison, not a claim).
  5. serve (SSM) — mamba2-1.3b at its published widths (48 layers,
               d 2048, bf16, page 16, 8 slots x 2048 ctx) serves 8
               requests of 64..1024 prompt tokens (chunk multiples and
               ragged lengths) for 32 new tokens each; mamba_chunk_scan
               (48 per prefill) and fmmu_commit must be launched.
               Then a 2-layer f32 mamba2 engine must emit the same
               greedy tokens with the kernels as with kernel_impl="ref".
  5b. serve (SSM, macro) — as 3b for mamba2-1.3b (fmmu_commit
               replayed, mamba_chunk_scan at prefill).
Launch counts are zeroed just before each path's run and read just
after it; each kernel reports the count of the path that carries it
(fmmu_lookup: the map phase's; the probe-only fmmu_translate runs on
no path since fmmu_commit does its probe, and reports 0).

Output: the ptxas resource lines on stderr; on stdout, before the last
line, one JSON line {"ptxas": [...]} (registers, spills and static
shared memory of each attention and scan instantiation, with the paged
kernel's launch plan at the serving shape), the card's name and power
limit, one JSON line {"kernels": [...]} (launches from the macro
path's counted pass, launches_single_step from the single-step run,
launches_serve_swap, launches_serve_channels and launches_serve_faults
from the swap, channel and fault phases' counted passes,
launches_serve_recover from the recovered drain of the crashed engine), one {"serve": {...}} (llama), one
{"serve_macro": {...}}, one {"serve_swap": {...}}, one
{"serve_channels": {...}}, one {"serve_faults": {...}}, one
{"serve_recover": {...}}, one {"map": {...}}, one {"serve_ssm": {...}}
and one {"serve_ssm_macro": {...}}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import random
import re
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
F16_TOL = 1e-2
F32_TOL = 1e-4
SCAN_TOL = {torch.float32: 5e-3, torch.bfloat16: 8e-2}   # Pallas tests'

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


def probe_bytes(dlpns, hit, set_idx, n_ways, fallback):
    """Bytes a CMT probe of these lanes must move: the tags and valid
    bits of each distinct set the lanes probe (the `way` output of every
    lane, inactive ones included, is its set's first matching way), one
    data word per hit lane, one backing word per active miss when
    ``fallback``, each lane's dlpn in and its hit/dppn/set/way out."""
    bq = dlpns.numel()
    n_probed = int(torch.unique(set_idx).numel())
    n_hit = int(hit.sum())
    n_miss = int(((dlpns >= 0) & ~hit).sum()) if fallback else 0
    return (n_probed * n_ways * (4 + 1) + 4 * n_hit + 4 * n_miss
            + bq * 4 + bq * (1 + 4 + 4 + 4))


def _demangle(names):
    """C++ names of mangled kernel symbols (cu++filt from the toolkit,
    else c++filt), shortened to the kernel and its template arguments;
    the mangled names where neither tool is found."""
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    tools = [str(cuda / "bin" / "cu++filt"), "c++filt"]
    for tool in tools:
        try:
            res = subprocess.run([tool], input="\n".join(names),
                                 capture_output=True, text=True, check=True)
        except (OSError, subprocess.CalledProcessError):
            continue
        out = []
        for line in res.stdout.splitlines():
            for junk in ("(anonymous namespace)::", "<unnamed>::", "(int)",
                         "void "):
                line = line.replace(junk, "")
            depth, end = 0, len(line)     # cut after the template list
            for i, ch in enumerate(line):
                depth += {"<": 1, ">": -1}.get(ch, 0)
                if ch == ">" and depth == 0:
                    end = i + 1
                    break
            out.append(line[:end])
        if len(out) == len(names):
            return out
    return list(names)


def ptxas_resources(logs, kernels=("fmmu_commit", "paged_attention",
                                   "flash_attention", "mamba_scan")):
    """Registers, spills and static shared memory of every instantiation
    of the named kernels, from nvcc's -Xptxas -v output."""
    entries, cur = [], None
    for kernel in kernels:
        for line in logs.get(kernel, "").splitlines():
            mt = re.search(r"Compiling entry function '(\w+)'", line)
            if mt:
                cur = {"mangled": mt.group(1)}
                entries.append(cur)
                continue
            if cur is None:
                continue
            mt = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                           r"stores, (\d+) bytes spill loads", line)
            if mt:
                cur.update(stack_bytes=int(mt.group(1)),
                           spill_store_bytes=int(mt.group(2)),
                           spill_load_bytes=int(mt.group(3)))
            mt = re.search(r"Used (\d+) registers", line)
            if mt:
                sm = re.search(r"(\d+) bytes smem", line)
                cur.update(registers=int(mt.group(1)),
                           smem_static_bytes=int(sm.group(1)) if sm else 0)
    for e, name in zip(entries, _demangle([e["mangled"] for e in entries])):
        e["kernel"] = name
        del e["mangled"]
    return entries


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
    s, w = 16, 4
    args, e = inputs(s, w, 8, 1024, 8, False)
    hit, _, set_idx, _, _ = fmmu_translate_ref(*args, entries_per_block=e)
    # the probe, each lane's touch flag in, and the ref bits, which the
    # function returns as a new [S, W] array: read once, written once
    n_bytes = (probe_bytes(args[5], hit, set_idx, w, fallback=True)
               + 8 * 1 + 2 * s * w)
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


def _commit_geometry(name):
    from repro_torch.core.fmmu.types import FMMUGeometry
    if name == "serving":    # the serving grid's map: paging._geometry(8, 128)
        return FMMUGeometry(cmt_sets=16, cmt_ways=4, cmt_entries=8,
                            entries_per_tp=128, n_tvpns=8)
    return FMMUGeometry()    # the paper's: 512 x 4 x 8, NP = 1,048,576


def _commit_state(rng, g, n_stack=1024):
    """A map state with history on the card: in-set tags (duplicate-tag
    ways too), random bits and clocks, values past 1<<24, a random
    table, a full stack."""
    from repro_torch.core.fmmu import batch as fb
    from repro_torch.core.fmmu.types import HOST_BASE
    s, w, e = g.cmt_sets, g.cmt_ways, g.cmt_entries
    n_pages = g.n_tvpns * g.entries_per_tp
    tags = rng.integers(0, n_pages // e // s, (s, w)) * s + \
        np.arange(s)[:, None]
    tags[::3, -1] = tags[::3, 0]

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.asarray(a)).to("cuda", dtype)
    vals = (lambda *shape: rng.integers(-1, 2 * HOST_BASE, shape))
    st = fb.BatchFMMUState(
        tags=t(tags), valid=t(rng.random((s, w)) < 0.7, torch.bool),
        ref=t(rng.random((s, w)) < 0.4, torch.bool),
        clock=t(rng.integers(0, w, s)), data=t(vals(s, w, e)),
        backing=t(vals(n_pages)), stats=t(rng.integers(0, 1000, 4)))
    return fb.ServingMapState(
        fmmu=st, table=t(vals(n_pages)),
        free_stack=t(rng.permutation(1 << 20)[:n_stack]),
        free_n=t(np.int32(n_stack)), host_stack=t(np.zeros(0, np.int32)),
        host_n=t(np.int32(0)), oob=t(False, torch.bool),
        swap_pending=t(np.zeros(8, bool), torch.bool),
        commit_seq=t(np.int32(0)))


def _commit_lanes(rng, g, bq, unique=False):
    """A mixed batch of bq lanes: hits and misses (several lanes per
    block, mixed op kinds, many blocks per set), lanes past the map up to
    int32's max, duplicate reads (inactive lanes when ``unique``: a grow
    batch writes every lane), inactive lanes, host-tier dppns; unique
    write dlpns. Returns (opcodes, dlpns, dppns) on the card."""
    from repro_torch.core.fmmu.types import HOST_BASE, NIL
    e, s = g.cmt_entries, g.cmt_sets
    n_pages = g.n_tvpns * g.entries_per_tp
    blocks = int(rng.integers(s)) + s * rng.choice(n_pages // e // s,
                                                   max(1, bq // 6))
    cand = np.concatenate([[n_pages, n_pages + 3, 1 << 30, (1 << 31) - 1],
                           (blocks[:, None] * e + np.arange(e)).reshape(-1),
                           rng.permutation(n_pages)[:bq]])
    _, first = np.unique(cand, return_index=True)
    cand = rng.permutation(cand[np.sort(first)])
    u = min(len(cand), max(1, 3 * bq // 4))
    n_dup = (bq - u) // 2
    dups = np.full(n_dup, -1) if unique else rng.choice(cand[:u], n_dup)
    dl = np.concatenate([cand[:u], dups, np.full(bq - u - n_dup, -1)])
    op = rng.integers(0, 3, bq)
    op[u:u + n_dup] = 0                                  # LOOKUP reads
    dp = rng.choice([NIL, 7, HOST_BASE + 5], bq)
    dp = np.where(dp == NIL, NIL, dp + rng.integers(0, 1 << 20, bq))
    order = rng.permutation(bq)
    return [torch.from_numpy(a[order].astype(np.int32)).cuda()
            for a in (op, dl, dp)]


def commit_bytes(g, ms, lanes, grow, with_lanes=True):
    """Bytes one commit must move, from what these lanes touch (the
    plain chain run on a copy). ``lanes`` = (opcodes, dlpns, dppns[,
    old_dppns]): without old dppns a COND_UPDATE lane's guard compares
    with its new dppn. Each lane's inputs and outputs, the tags
    and valid bits of each probed set, one data or backing word per
    active lane, a ref byte per touching hit, each committed lane's
    backing, table and (on a hit) data word, each fill's tag, valid,
    ref, E data words and the E backing words they come from, the clock
    of each set that filled, each pop's stack word, and the scalars
    (stats, commit_seq, free_n, oob) read and written once. Without
    ``with_lanes`` the lanes' inputs and outputs are left out (a
    channel's share of a sharded commit, whose lanes count once)."""
    from repro_torch.core.fmmu import batch as fb
    from repro_torch.kernels.ref import fmmu_translate_ref
    w, e = g.cmt_ways, g.cmt_entries
    st = ms.fmmu
    op, dl, dp = lanes[:3]
    old = lanes[3] if len(lanes) > 3 else dp
    after = fb.clone_state(ms)
    if grow is not None:
        blocks, ok = fb.serving_grow_(g, after, grow, dl, impl="ref")
        dl = torch.where(ok, dl, -1)
        op = torch.ones_like(dl)
        lane_io = dl.numel() * (4 + 1 + 4 + 1)    # dlpn, grow | blocks, ok
    else:
        fb.translate_serving_(g, after, op, dl, dp, old, impl="ref")
        lane_io = dl.numel() * (4 * 4 + 4 + 1)           # 4 lanes | out, ok
    hit, _, set_idx, _, _ = fmmu_translate_ref(
        st.tags, st.valid, st.ref, st.data, st.backing, dl, dl >= 0,
        entries_per_block=e)
    active = dl >= 0
    probed = torch.unique(set_idx[active]).numel()
    touch = int((hit & ((op == 0) | (op == 2))).sum())
    d_stats = (after.fmmu.stats - st.stats).tolist()
    fills, writes = d_stats[2], d_stats[3]
    write_hits = min(writes, int((hit & (op != 0)).sum()))
    fill_sets = int(((after.fmmu.tags != st.tags).any(1)
                     | (after.fmmu.clock != st.clock)).sum())
    pops = int(ms.free_n - after.free_n)
    if not with_lanes:
        lane_io = 0
    return (lane_io + probed * w * (4 + 1) + 4 * int(active.sum()) + touch
            + writes * (4 + 4) + 4 * write_hits
            + fills * (4 + 1 + 1 + 2 * 4 * e) + fill_sets * 8 + 4 * pops
            + 2 * (16 + 4 + 4 + 1))


def check_fmmu_commit(timer, rng):
    """The whole map commit against its plain chain (impl="ref") on
    clones of one state, bit for bit (every state tensor and output), at
    the serving map and the paper geometry, from 1 to 4096 lanes, in the
    three modes (translate_serving_, translate_batch_, serving_grow_),
    three commits in a row. Times the kernel and the chain at the
    serving commit (8 growing lanes, fresh pages each call; and the
    all-masked commit the K-step graph runs on most steps) and at the
    paper geometry (a map-phase batch of 64 mixed lanes)."""
    from repro_torch.core.fmmu import batch as fb
    for geom in ("serving", "paper"):
        g = _commit_geometry(geom)
        for bq in (1, 8, 64, 1000, 4096):
            for mode in ("serving", "batch", "grow"):
                ms = _commit_state(rng, g, n_stack=max(bq // 3, 1))
                ker, ref = fb.clone_state(ms), fb.clone_state(ms)
                if mode == "batch":
                    ker, ref = ker.fmmu, ref.fmmu
                for it in range(3):
                    op, dl, dp = _commit_lanes(rng, g, bq,
                                               unique=mode == "grow")
                    if mode == "grow":
                        grow = torch.from_numpy(rng.random(bq) < 0.5).cuda()
                        got = fb.serving_grow_(g, ker, grow, dl)
                        want = fb.serving_grow_(g, ref, grow, dl, impl="ref")
                    else:
                        fn = getattr(fb, f"translate_{mode}_")
                        got = fn(g, ker, op, dl, dp, dp)
                        want = fn(g, ref, op, dl, dp, dp, impl="ref")
                    torch.cuda.synchronize()
                    for x, y in zip(list(got) + fb.state_tensors(ker),
                                    list(want) + fb.state_tensors(ref)):
                        if x.dtype != y.dtype or not torch.equal(x, y):
                            fail(f"fmmu_commit differs from its plain chain: "
                                 f"{geom} Bq={bq} {mode} commit {it}")

    def stream(g, bq, grow_mode, impl, n=64):
        """A commit per call on one state, fresh lanes each call (a grow
        commit: bq distinct pages, every lane growing)."""
        ms = _commit_state(np.random.default_rng(SEED), g, n_stack=1 << 12)
        lrng = np.random.default_rng(SEED + 1)
        n_pages = g.n_tvpns * g.entries_per_tp
        batches = [[None, torch.from_numpy(lrng.permutation(n_pages)[:bq]
                                           .astype(np.int32)).cuda(), None]
                   if grow_mode else _commit_lanes(lrng, g, bq)
                   for _ in range(n)]
        grow = torch.ones(bq, dtype=torch.bool, device="cuda")
        calls = iter(range(1 << 30))

        def call():
            op, dl, dp = batches[next(calls) % n]
            if grow_mode:
                fb.serving_grow_(g, ms, grow, dl, impl=impl)
            else:
                fb.translate_serving_(g, ms, op, dl, dp, dp, impl=impl)
        return call, ms, batches[0]

    g = _commit_geometry("serving")
    out = {}
    for name, bq, grow_mode, gg in (("", 8, True, g),
                                    ("_paper", 64, False,
                                     _commit_geometry("paper"))):
        call, ms, lanes = stream(gg, bq, grow_mode, None)
        out["ms" + name] = timer.ms(call)
        call, _, _ = stream(gg, bq, grow_mode, "ref")
        out["plain_ms" + name] = timer.ms(call)
        grow = torch.ones(bq, dtype=torch.bool, device="cuda") \
            if grow_mode else None
        b_ms, b_by = bound_ms(commit_bytes(gg, _commit_state(
            np.random.default_rng(SEED), gg), lanes, grow), 0, "int32")
        out["bound_ms" + name], out["bound_by" + name] = b_ms, b_by
    ms = _commit_state(np.random.default_rng(SEED), g)
    grow = torch.zeros(8, dtype=torch.bool, device="cuda")
    dl = torch.arange(8, dtype=torch.int32, device="cuda")
    out["ms_masked"] = timer.ms(lambda: fb.serving_grow_(g, ms, grow, dl))
    out["plain_ms_masked"] = timer.ms(
        lambda: fb.serving_grow_(g, ms, grow, dl, impl="ref"))
    out.update(check_swap_commits(timer, rng, g))
    return dict({
        "name": "fmmu_commit", "route": "cuda",
        "source": "src/repro_torch/csrc/fmmu_commit.cu",
        "replaces": "src/repro/kernels/fmmu_translate.py:115",
        "max_abs_err": 0.0, "library_ms": None,
        "shape": "S=16 W=4 E=8 NP=1024, 8 growing lanes (serving_grow_); "
                 "_masked: the same, no lane growing; _paper: S=512 W=4 "
                 "E=8 NP=1048576, 64 mixed lanes (translate_serving_); "
                 f"_swap_out / _swap_in: S=16 W=4 E=8 NP=1024, "
                 f"{SWAP_LANES} COND_UPDATE lanes of one slot, "
                 f"{SWAP_STALE} with a stale old dppn (translate_serving_)"},
        **out)


SWAP_LANES, SWAP_STALE = 64, 16


def _swap_commits(rng, g):
    """A serving map state in which one slot's 64 pages are mapped at
    device blocks, the swap-out commit of those pages to host blocks and
    the swap-in commit that brings them back to other device blocks: 64
    lanes each, every one a COND_UPDATE, a quarter of them with a stale
    old dppn (the guard refuses them; a different quarter each way).
    Returns [(name, state, lanes (op, dl, new, old), stale mask)], the
    swap-in's state being the swap-out's result (plain chain)."""
    from repro_torch.core.fmmu import batch as fb
    from repro_torch.core.fmmu.types import COND_UPDATE, HOST_BASE, UPDATE

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32)).cuda()

    def stale():
        m = np.zeros(SWAP_LANES, bool)
        m[rng.permutation(SWAP_LANES)[:SWAP_STALE]] = True
        return m
    ms = _commit_state(rng, g)
    n_pages = g.n_tvpns * g.entries_per_tp
    dl = int(rng.integers(0, 8)) * (n_pages // 8) + np.arange(SWAP_LANES)
    dev = rng.permutation(128)[:SWAP_LANES]
    back = rng.permutation(128)[:SWAP_LANES]
    host = HOST_BASE + rng.permutation(256)[:SWAP_LANES]
    op = t(np.full(SWAP_LANES, COND_UPDATE))
    fb.translate_serving_(g, ms, t(np.full(SWAP_LANES, UPDATE)), t(dl),
                          t(dev), t(dev), impl="ref")
    s_out, s_in = stale(), stale()
    out_lanes = (op, t(dl), t(host), t(np.where(s_out, dev + 1, dev)))
    after = fb.clone_state(ms)
    fb.translate_serving_(g, after, *out_lanes, impl="ref")
    in_lanes = (op, t(dl), t(back), t(np.where(s_in, host + 1, host)))
    # a swap-in lane commits where its own guard holds and the swap-out
    # of that page committed (else the page never left its device block)
    return [("swap_out", ms, out_lanes, s_out),
            ("swap_in", after, in_lanes, s_in | s_out)]


def check_swap_commits(timer, rng, g):
    """The swap pipeline's map commit at the serving geometry (one
    slot's 64 pages, all COND_UPDATE, host-tagged new or old dppns, a
    quarter stale) through the kernel and its plain chain on clones of
    one state, bit for bit on every state tensor and output; the guard
    must refuse exactly the stale lanes. Times both and bounds the
    commit (``commit_bytes``)."""
    from repro_torch.core.fmmu import batch as fb
    out = {}
    for name, ms, lanes, stale in _swap_commits(rng, g):
        ker, ref = fb.clone_state(ms), fb.clone_state(ms)
        got = fb.translate_serving_(g, ker, *lanes)
        want = fb.translate_serving_(g, ref, *lanes, impl="ref")
        torch.cuda.synchronize()
        for x, y in zip(list(got) + fb.state_tensors(ker),
                        list(want) + fb.state_tensors(ref)):
            if x.dtype != y.dtype or not torch.equal(x, y):
                fail(f"fmmu_commit differs from its plain chain on the "
                     f"{name} commit")
        if not np.array_equal(got[1].cpu().numpy(), ~stale):
            fail(f"the {name} commit's guard: ok {got[1].tolist()}, "
                 f"stale lanes {np.nonzero(stale)[0].tolist()}")
        for impl, key in ((None, "ms"), ("ref", "plain_ms")):
            clones = iter([fb.clone_state(ms) for _ in range(23)])
            out[f"{key}_{name}"] = timer.ms(
                lambda: fb.translate_serving_(g, next(clones), *lanes,
                                              impl=impl))
        out[f"bound_ms_{name}"], out[f"bound_by_{name}"] = bound_ms(
            commit_bytes(g, ms, lanes, None), 0, "int32")
    return out


GRID_CHANNELS = (2, 8, 32)


def _sharded_commit_state(rng, c_n, dry=None):
    """The paper geometry cut into ``c_n`` 1/C shards, as the page
    manager's ``_geometry`` cuts the serving map (512 x 4 x 8 CMT each,
    backing 1,048,576 / C), each shard with its own history
    (``_commit_state``), stacked on the channel axis; channel ``dry``'s
    free stack is empty. Returns (shard geometry, state)."""
    from repro_torch.core.fmmu import batch as fb
    from repro_torch.core.fmmu.types import FMMUGeometry
    g = FMMUGeometry(n_tvpns=256 // c_n)
    ms = _stack_shards([_commit_state(rng, g) for _ in range(c_n)])
    if dry is not None:
        ms.free_n[dry] = 0
    return g, ms


def _stack_shards(shards):
    """Unstacked serving states stacked on a leading channel axis."""
    from repro_torch.core.fmmu import batch as fb
    st = fb.BatchFMMUState(*(torch.stack(ts) for ts in zip(
        *(sh.fmmu for sh in shards))))
    return fb.ServingMapState(st, *(torch.stack(ts) for ts in zip(
        *(sh[1:9] for sh in shards))))


def _sharded_lanes(rng, g, ms, bq, unique=False):
    """``_commit_lanes`` over a stacked state's global dlpn space: hits
    in every channel's CMT (local page * C + channel), misses anywhere,
    lanes past the space up to int32's max, duplicate reads (inactive
    lanes when ``unique``), inactive lanes, unique write dlpns.
    Returns (opcodes, dlpns, dppns) on the card."""
    from repro_torch.core.fmmu.types import HOST_BASE, NIL
    c_n, e = ms.table.shape[0], g.cmt_entries
    n_pages = c_n * g.n_tvpns * g.entries_per_tp
    tags, valid = ms.fmmu.tags.cpu().numpy(), ms.fmmu.valid.cpu().numpy()
    hits = np.concatenate([
        ((tags[c][valid[c]][:, None] * e + np.arange(e)) * c_n + c)
        .reshape(-1) for c in range(c_n)])
    cand = np.concatenate([[n_pages, n_pages + 3, 1 << 30, (1 << 31) - 1],
                           rng.permutation(hits)[:max(1, bq // 3)],
                           rng.permutation(n_pages)[:bq]])
    _, first = np.unique(cand, return_index=True)
    cand = rng.permutation(cand[np.sort(first)])
    u = min(len(cand), max(1, 3 * bq // 4))
    n_dup = (bq - u) // 2
    dups = np.full(n_dup, -1) if unique else rng.choice(cand[:u], n_dup)
    dl = np.concatenate([cand[:u], dups, np.full(bq - u - n_dup, -1)])
    op = rng.integers(0, 3, bq)
    op[u:u + n_dup] = 0                                  # LOOKUP reads
    dp = rng.choice([NIL, 7, HOST_BASE + 5], bq)
    dp = np.where(dp == NIL, NIL, dp + rng.integers(0, 1 << 20, bq))
    order = rng.permutation(bq)
    return [torch.from_numpy(a[order].astype(np.int32)).cuda()
            for a in (op, dl, dp)]


def sharded_commit_bytes(g, ms, lanes, grow):
    """Bytes one sharded commit must move: each channel's share
    (``commit_bytes`` of its own lanes on its shard) and every lane's
    inputs and outputs once."""
    from repro_torch.core.fmmu import batch as fb
    c_n = ms.table.shape[0]
    op, dl, dp = lanes[:3]
    owner, local = fb.channel_of(dl, c_n), fb.local_dlpn(dl, c_n)
    total = dl.numel() * ((4 + 1 + 4 + 1) if grow is not None
                          else (4 * 4 + 4 + 1))
    for c in range(c_n):
        own = (owner == c) & ((grow if grow is not None else dl >= 0))
        dl_c = torch.where(own, local, -1).to(torch.int32)
        total += commit_bytes(
            g, fb.clone_state(fb.shard(ms, c)), (op, dl_c, dp, *lanes[3:]),
            own if grow is not None else None, with_lanes=False)
    return total


def check_fmmu_commit_grid(timer, rng):
    """The channel grid of the commit kernel: at C in {2, 8, 32} on the
    paper geometry cut into 1/C shards, a 64-lane mixed batch, a
    1024-lane batch and a grow batch with one dry channel, each one
    launch of C blocks, bit-exact against the plain per-channel chain
    on every state tensor and output (three commits in a row). Times
    each C's 64-lane commit (kernel, plain chain, byte bound) beside the
    one-block launch on the whole geometry (C = 1) over the same global
    lanes."""
    from repro_torch.core.fmmu import batch as fb
    from repro_torch.kernels import fmmu_commit as fc
    out = {}
    for c_n in GRID_CHANNELS:
        for bq, grow_mode in ((64, False), (1024, False), (64, True)):
            g, ms = _sharded_commit_state(rng, c_n,
                                          dry=1 if grow_mode else None)
            ker, ref = fb.clone_state(ms), fb.clone_state(ms)
            for it in range(3):
                op, dl, dp = _sharded_lanes(rng, g, ms, bq,
                                            unique=grow_mode)
                n0 = fc.LAUNCHES[0]
                if grow_mode:
                    grow = torch.from_numpy(rng.random(bq) < 0.5).cuda()
                    # one growing lane in the dry channel 1 at least
                    used, page = set(dl.tolist()), 1
                    while page in used:
                        page += c_n
                    dl[0] = page
                    grow[0] = True
                    got = fb.grow_sharded_(g, c_n, ker, grow, dl)
                    want = fb.grow_sharded_(g, c_n, ref, grow, dl,
                                            impl="ref")
                else:
                    got = fb.translate_sharded_(g, c_n, ker, op, dl, dp, dp)
                    want = fb.translate_sharded_(g, c_n, ref, op, dl, dp,
                                                 dp, impl="ref")
                torch.cuda.synchronize()
                if fc.LAUNCHES[0] - n0 != 1:
                    fail(f"fmmu_commit at C={c_n}: "
                         f"{fc.LAUNCHES[0] - n0} launches for one commit")
                for x, y in zip(list(got) + fb.state_tensors(ker),
                                list(want) + fb.state_tensors(ref)):
                    if x is None and y is None:
                        continue
                    if x.dtype != y.dtype or not torch.equal(x, y):
                        fail(f"fmmu_commit grid differs from its plain "
                             f"chain: C={c_n} Bq={bq} grow={grow_mode} "
                             f"commit {it}")
            oob = fb.oob_vec(ker).tolist()
            if grow_mode and (not oob[1] or any(oob[:1] + oob[2:])):
                fail(f"fmmu_commit grid at C={c_n}: oob flags {oob}, "
                     "expected the dry channel 1's alone")

    def stream(c_n, impl, n=64):
        """A 64-lane mixed commit per call on one state, fresh lanes
        each call; c_n = 1: the unstacked whole geometry."""
        lrng = np.random.default_rng(SEED + 2)
        g, ms = _sharded_commit_state(np.random.default_rng(SEED),
                                      max(c_n, 2))
        batches = [_sharded_lanes(lrng, g, ms, 64) for _ in range(n)]
        if c_n == 1:
            g = _commit_geometry("paper")
            ms = _commit_state(np.random.default_rng(SEED), g)
        calls = iter(range(1 << 30))

        def call():
            op, dl, dp = batches[next(calls) % n]
            if c_n == 1:
                fb.translate_serving_(g, ms, op, dl, dp, dp, impl=impl)
            else:
                fb.translate_sharded_(g, c_n, ms, op, dl, dp, dp,
                                      impl=impl)
        return call, g, ms, batches[0]
    for c_n in (1,) + GRID_CHANNELS:
        call, g, ms, lanes = stream(c_n, None)
        key = f"c{c_n}"
        out[f"ms_grid_{key}"] = timer.ms(call)
        call, _, _, _ = stream(c_n, "ref")
        out[f"plain_ms_grid_{key}"] = timer.ms(call, iters=5, warmup=1)
        n_bytes = commit_bytes(g, fb.clone_state(ms), lanes, None) \
            if c_n == 1 else sharded_commit_bytes(g, ms, lanes, None)
        out[f"bound_ms_grid_{key}"], out[f"bound_by_grid_{key}"] = \
            bound_ms(n_bytes, 0, "int32")
    out.update(check_serving_grid_commits(timer, rng))
    return out


def _serving_grid_commits(rng):
    """The commits ``serve_channels`` launches, at its map: 8 channel
    shards of ``_geometry(8, 128, 8)`` (8 slots x 128 pages, 8 x 4 x 8
    CMT and 128 pages each, 1024 device blocks striped over the
    channels), each shard with its own history (``_commit_state``). The
    boundary's growth pre-commit (one UPDATE lane per growing slot, to
    a fresh block of the page's owner channel, old dppn 0 as
    ``KVPageManager._xlate`` sends it), and a slot's swap-out and
    swap-in (``SWAP_LANES`` COND_UPDATE lanes each, to blocks of the
    owner channel of the other tier, ``SWAP_STALE`` with a stale old
    dppn). Returns (shard geometry, [(name, state, lanes (op, dl, new,
    old), stale mask)]), each state the previous one's result (plain
    chain)."""
    from repro_torch.core.fmmu import batch as fb
    from repro_torch.core.fmmu.types import COND_UPDATE, HOST_BASE, UPDATE
    from repro_torch.paging.kv_manager import _geometry
    c_n, n_slots, max_pages = SERVE_CHANNELS, 8, 128
    g = _geometry(n_slots, max_pages, c_n)
    ms = _stack_shards([_commit_state(rng, g) for _ in range(c_n)])

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32)).cuda()

    def owned(dl, n_blocks, base=0):
        """Distinct blocks of each lane's owner channel (b mod C ==
        dl mod C), as ``BlockPool.alloc_for`` gives them."""
        out = np.empty_like(dl)
        for c in range(c_n):
            m = dl % c_n == c
            out[m] = base + c + c_n * rng.permutation(
                n_blocks // c_n)[:m.sum()]
        return out

    def stale():
        m = np.zeros(SWAP_LANES, bool)
        m[rng.permutation(SWAP_LANES)[:SWAP_STALE]] = True
        return m
    n_dev = n_slots * max_pages
    grow = np.arange(n_slots) * max_pages + rng.integers(4, max_pages,
                                                         n_slots)
    pre = (t(np.full(n_slots, UPDATE)), t(grow),
           t(owned(grow, n_dev)), t(np.zeros(n_slots)))
    after_pre = fb.clone_state(ms)
    fb.translate_sharded_(g, c_n, after_pre, *pre, impl="ref")
    dl = int(rng.integers(0, n_slots)) * max_pages + np.arange(SWAP_LANES)
    dev, back = owned(dl, n_dev), owned(dl, n_dev)
    host = owned(dl, 2 * n_dev, HOST_BASE)
    op = t(np.full(SWAP_LANES, COND_UPDATE))
    fb.translate_sharded_(g, c_n, after_pre, t(np.full(SWAP_LANES, UPDATE)),
                          t(dl), t(dev), t(dev), impl="ref")
    s_out, s_in = stale(), stale()
    out_lanes = (op, t(dl), t(host), t(np.where(s_out, dev + c_n, dev)))
    after_out = fb.clone_state(after_pre)
    fb.translate_sharded_(g, c_n, after_out, *out_lanes, impl="ref")
    in_lanes = (op, t(dl), t(back), t(np.where(s_in, host + c_n, host)))
    return g, [("precommit", ms, pre, np.zeros(n_slots, bool)),
               ("swap_out", after_pre, out_lanes, s_out),
               ("swap_in", after_out, in_lanes, s_in | s_out)]


def check_serving_grid_commits(timer, rng):
    """The grid commit at ``serve_channels``' shape (C = 8 shards of
    ``_geometry(8, 128, 8)``): the growth pre-commit and a swap each
    way (``_serving_grid_commits``), one launch of 8 blocks each,
    through the kernel and its plain per-channel chain on clones of one
    state, bit for bit on every state tensor and output; the swaps'
    guards must refuse exactly the stale lanes. Times both and bounds
    each commit (``sharded_commit_bytes``), beside the one-channel
    serving commits of ``check_fmmu_commit``."""
    from repro_torch.core.fmmu import batch as fb
    from repro_torch.kernels import fmmu_commit as fc
    c_n = SERVE_CHANNELS
    g, commits = _serving_grid_commits(rng)
    out = {}
    for name, ms, lanes, stale in commits:
        ker, ref = fb.clone_state(ms), fb.clone_state(ms)
        n0 = fc.LAUNCHES[0]
        got = fb.translate_sharded_(g, c_n, ker, *lanes)
        want = fb.translate_sharded_(g, c_n, ref, *lanes, impl="ref")
        torch.cuda.synchronize()
        if fc.LAUNCHES[0] - n0 != 1:
            fail(f"the serving grid's {name} commit: "
                 f"{fc.LAUNCHES[0] - n0} launches")
        for x, y in zip(list(got) + fb.state_tensors(ker),
                        list(want) + fb.state_tensors(ref)):
            if x.dtype != y.dtype or not torch.equal(x, y):
                fail(f"fmmu_commit grid differs from its plain chain on "
                     f"the serving grid's {name} commit (C={c_n})")
        if not np.array_equal(got[1].cpu().numpy(), ~stale):
            fail(f"the serving grid's {name} commit's guard: ok "
                 f"{got[1].tolist()}, stale lanes "
                 f"{np.nonzero(stale)[0].tolist()}")
        key = f"serve_c{c_n}_{name}"
        for impl, k in ((None, "ms"), ("ref", "plain_ms")):
            clones = iter([fb.clone_state(ms) for _ in range(23)])
            out[f"{k}_{key}"] = timer.ms(
                lambda: fb.translate_sharded_(g, c_n, next(clones), *lanes,
                                              impl=impl))
        out[f"bound_ms_{key}"], out[f"bound_by_{key}"] = bound_ms(
            sharded_commit_bytes(g, ms, lanes, None), 0, "int32")
    return out


RETIRE_LANES = 4


def _fault_commits(rng):
    """The commits of the fault plane and recovery at the llama serving
    map (8 slots x 128 pages, ``_geometry(8, 128, C)``), at one channel
    and at ``SERVE_CHANNELS``: a retirement (``RETIRE_LANES`` COND_UPDATE
    lanes moving mapped pages from their bad blocks to replacements of
    the page's owner channel, old dppn the bad block, on a map with
    history) and a restore (``KVPageManager.restore_mapping``: one UPDATE
    lane per page of every slot, 1024, to blocks of the owner channel,
    old dppn 0, into a fresh state). Returns [(key, shard geometry,
    channels, state, lanes (op, dl, new, old))]."""
    from repro_torch.core.fmmu import batch as fb
    from repro_torch.core.fmmu.types import COND_UPDATE, UPDATE
    from repro_torch.paging.kv_manager import _geometry
    n_slots, max_pages = 8, 128
    n_dev = n_slots * max_pages

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32)).cuda()
    out = []
    for c_n in (1, SERVE_CHANNELS):
        g = _geometry(n_slots, max_pages, c_n)
        commit = (fb.translate_serving_ if c_n == 1 else
                  lambda g_, ms_, *a, **k: fb.translate_sharded_(
                      g_, c_n, ms_, *a, **k))

        def owned(dl):
            """Distinct device blocks of each lane's owner channel."""
            blk = np.empty_like(dl)
            for c in range(c_n):
                m = dl % c_n == c
                blk[m] = c + c_n * rng.permutation(n_dev // c_n)[:m.sum()]
            return blk
        ms = _commit_state(rng, g) if c_n == 1 else \
            _stack_shards([_commit_state(rng, g) for _ in range(c_n)])
        dl = rng.permutation(n_dev)[:RETIRE_LANES]
        both = owned(np.concatenate([dl, dl]))
        bad, new = both[:RETIRE_LANES], both[RETIRE_LANES:]
        commit(g, ms, t(np.full(RETIRE_LANES, UPDATE)), t(dl), t(bad),
               t(np.zeros(RETIRE_LANES)), impl="ref")
        out.append((f"retire_c{c_n}", g, c_n, ms,
                    (t(np.full(RETIRE_LANES, COND_UPDATE)), t(dl), t(new),
                     t(bad))))
        fresh = (fb.init_serving_state(g, n_dev, n_lanes=n_slots,
                                       n_host_blocks=2 * n_dev,
                                       device="cuda") if c_n == 1 else
                 fb.init_sharded_state(g, c_n, n_dev, 2 * n_dev,
                                       n_lanes=n_slots, device="cuda"))
        dl = np.arange(n_dev)
        out.append((f"restore_c{c_n}", g, c_n, fresh,
                    (t(np.full(n_dev, UPDATE)), t(dl), t(owned(dl)),
                     t(np.zeros(n_dev)))))
    return out


def check_fault_commits(timer, rng):
    """The retirement and the restore commit (``_fault_commits``), one
    launch each (of C blocks at C channels), through the kernel and its
    plain chain on clones of one state, bit for bit on every state
    tensor and output, every lane's guard holding. Times both and
    bounds each commit (``commit_bytes`` / ``sharded_commit_bytes``)."""
    from repro_torch.core.fmmu import batch as fb
    from repro_torch.kernels import fmmu_commit as fc
    out = {}
    for key, g, c_n, ms, lanes in _fault_commits(rng):
        def commit(state, impl=None):
            if c_n == 1:
                return fb.translate_serving_(g, state, *lanes, impl=impl)
            return fb.translate_sharded_(g, c_n, state, *lanes, impl=impl)
        ker, ref = fb.clone_state(ms), fb.clone_state(ms)
        n0 = fc.LAUNCHES[0]
        got = commit(ker)
        want = commit(ref, "ref")
        torch.cuda.synchronize()
        if fc.LAUNCHES[0] - n0 != 1:
            fail(f"the {key} commit: {fc.LAUNCHES[0] - n0} launches")
        for x, y in zip(list(got) + fb.state_tensors(ker),
                        list(want) + fb.state_tensors(ref)):
            if x.dtype != y.dtype or not torch.equal(x, y):
                fail(f"fmmu_commit differs from its plain chain on the "
                     f"{key} commit")
        if not bool(got[1].all()):
            fail(f"the {key} commit refused lanes: {got[1].tolist()}")
        for impl, k in ((None, "ms"), ("ref", "plain_ms")):
            clones = iter([fb.clone_state(ms) for _ in range(23)])
            out[f"{k}_{key}"] = timer.ms(lambda: commit(next(clones), impl))
        n_bytes = commit_bytes(g, ms, lanes, None) if c_n == 1 else \
            sharded_commit_bytes(g, ms, lanes, None)
        out[f"bound_ms_{key}"], out[f"bound_by_{key}"] = bound_ms(
            n_bytes, 0, "int32")
    return out


def _sdpa(q, k, v, **kw):
    import torch.nn.functional as F
    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:          # older torch: expand the KV heads
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), **kw)


def check_paged_attention(timer, rng):
    from repro_torch.kernels import paged_attention as pa
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

    def held(name, args, tol, **kw):
        """Kernel vs plain version (out, m, l), then two more calls that
        must repeat the first bit for bit (the split-order combine)."""
        got, (m, l) = paged_attention(*args, return_stats=True, **kw)
        want, (wm, wl) = paged_attention_ref(*args, return_stats=True, **kw)
        err = _max_err(got, want)
        if err > tol or _max_err(m, wm) > 1e-3 or \
                float(((l - wl).abs() / wl.clamp_min(1e-6)).max()) > 1e-3:
            fail(f"paged_attention {name}: max err {err}")
        for _ in range(2):
            again, (m2, l2) = paged_attention(*args, return_stats=True, **kw)
            if not (torch.equal(got, again) and torch.equal(m, m2)
                    and torch.equal(l, l2)):
                fail(f"paged_attention {name}: repeated call differs")
        return err

    worst = 0.0
    for maxp in (4, 8, 16, 32, 64, 128):
        worst = max(worst, held(f"bucket {maxp}",
                                inputs(maxp, torch.bfloat16), BF16_TOL))
    # the serving shape (8 slots at ctx 1024) and a ragged mix at maxp 128
    # whose contexts sit on, just past and far from the split edges
    ragged = [0, 1, 239, 240, 241, 1000, 1500, 2048]
    for name, maxp, ctx in (("ctx 1024", 64, [1024] * b),
                            ("ragged maxp 128", 128, ragged)):
        worst = max(worst, held(f"bf16 {name}",
                                inputs(maxp, torch.bfloat16, ctx), BF16_TOL))
        held(f"f16 {name}", inputs(maxp, torch.float16, ctx), F16_TOL)
    for kw in (dict(softcap=30.0), dict(window=100),
               dict(window=40, softcap=20.0)):
        held(f"f32 {kw}", inputs(32, torch.float32), F32_TOL, **kw)
    held("f32 window over splits", inputs(128, torch.float32, ragged),
         F32_TOL, window=300, softcap=30.0)
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
    plan = pa.plan(b, h, kv, 64, page, pa._sm_count(q.device.index))
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
        "plan": plan._asdict(),
    }


def check_flash_attention(timer):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    h, kv, d = 32, 8, 64

    def inputs(s, dtype):
        return [torch.randn((1, s, n, d), device="cuda").to(dtype)
                for n in (h, kv, kv)]

    def held(name, args, tol, **kw):
        err = _max_err(flash_attention(*args, **kw),
                       flash_attention_ref(*args, **kw))
        if err > tol:
            fail(f"flash_attention {name} {kw}: max err {err}")
        return err

    worst = 0.0
    for s in (100, 512, 1000):          # the tensor-core body (bf16, f16)
        worst = max(worst, held(f"bf16 S={s}", inputs(s, torch.bfloat16),
                                BF16_TOL))
        held(f"f16 S={s}", inputs(s, torch.float16), F16_TOL)
    for kw in (dict(window=256), dict(softcap=30.0),
               dict(window=200, softcap=20.0),
               dict(causal=False, bidirectional=True)):
        worst = max(worst, held("bf16 S=1000", inputs(1000, torch.bfloat16),
                                BF16_TOL, **kw))
    for kw in (dict(window=64), dict(softcap=30.0),
               dict(causal=False, bidirectional=True)):
        held("f32 S=300", inputs(300, torch.float32), F32_TOL, **kw)
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
        "shape": "B=1 S=1000 H=32 KV=8 D=64 causal bf16 (tensor-core body)",
    }


def check_mamba_chunk_scan(timer):
    from repro_torch.kernels.mamba_scan import (mamba_chunk_scan,
                                                mamba_chunk_scan_ref)
    from repro_torch.kernels.ref import mamba_chunk_scan_blocked
    h, p, n, chunk = 64, 64, 128, 256       # mamba2-1.3b's scan widths

    def inputs(s, dtype, init):
        """Values in the model's ranges (models/ssm.py init_ssm): dt =
        softplus(projection + dt_bias) around a per-head rate drawn
        log-uniform in [0.001, 0.1], A = -[1, 16] per head, D per head."""
        def u(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, device="cuda")
        dt0 = torch.exp(u((h,), math.log(1e-3), math.log(0.1)))
        bias = dt0 + torch.log(-torch.expm1(-dt0))      # softplus^-1(dt0)
        dt = torch.nn.functional.softplus(
            0.5 * torch.randn((1, s, h), device="cuda") + bias)
        a = -u((h,), 1.0, 16.0)
        d = 1.0 + 0.1 * torch.randn((h,), device="cuda")
        x = torch.randn((1, s, h, p), device="cuda").to(dtype)
        b = torch.randn((1, s, n), device="cuda").to(dtype)
        c = torch.randn((1, s, n), device="cuda").to(dtype)
        s0 = torch.randn((1, h, p, n), device="cuda") if init else None
        return (x, dt, a, b, c, d), s0

    worst = 0.0
    for s in (1024, 1000, 65, 1):
        for dtype in (torch.bfloat16, torch.float32):
            for init in (False, True):
                args, s0 = inputs(s, dtype, init)
                y, fin = mamba_chunk_scan(*args, chunk=chunk,
                                          initial_state=s0)
                yw, fw = mamba_chunk_scan_ref(*args, chunk=chunk,
                                              initial_state=s0)
                tol = SCAN_TOL[dtype]
                for got, want in ((y, yw), (fin, fw)):
                    if not torch.allclose(got.float(), want.float(),
                                          atol=tol, rtol=tol):
                        fail(f"mamba_chunk_scan S={s} {dtype} init={init}: "
                             f"max err {_max_err(got, want)}")
                worst = max(worst, _max_err(y, yw), _max_err(fin, fw))
                for _ in range(2):          # repeats are bit-identical
                    y2, fin2 = mamba_chunk_scan(*args, chunk=chunk,
                                                initial_state=s0)
                    if not (torch.equal(y, y2) and torch.equal(fin, fin2)):
                        fail(f"mamba_chunk_scan S={s} {dtype} init={init}: "
                             "repeated call differs")
    # the serving path's shape: one prefill of a 1024-token prompt
    s = 1024
    args, _ = inputs(s, torch.bfloat16, False)
    n_bytes = 2 * (2 * s * h * p) + 2 * (2 * s * n) + 4 * s * h \
        + 2 * 4 * h + 4 * h * p * n
    b_ms, b_by = bound_ms(n_bytes, 5 * s * h * p * n, "bfloat16")
    return {
        "name": "mamba_chunk_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:73",
        "max_abs_err": worst,
        "ms": timer.ms(lambda: mamba_chunk_scan(*args, chunk=chunk)),
        "plain_ms": timer.ms(lambda: mamba_chunk_scan_ref(*args,
                                                          chunk=chunk),
                             iters=5, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        # the kernel's own arithmetic in plain torch (many calls), printed
        # beside the kernel as a comparison
        "plain_blocked_ms": timer.ms(
            lambda: mamba_chunk_scan_blocked(*args, chunk=64), iters=5,
            warmup=1),
        "shape": "Bt=1 S=1024 H=64 P=64 N=128 bf16 (tensor-core body)",
    }


def _paper_cmt(rng, e=8):
    """A CMT at the paper geometry (512 sets x 4 ways x 8 entries) whose
    block ids and values lie past 1<<24, and query dlpns: hits, misses
    in a valid set, random lanes and inactive lanes."""
    s, w = 512, 4
    tags = (rng.integers(0, 64, (s, w)) + (1 << 24) // s + 1) * s \
        + np.arange(s)[:, None]
    tags[:, -1] = tags[:, 0]                       # duplicate-tag ways
    valid = rng.random((s, w)) < 0.7
    valid[:, 0] = True
    data = rng.integers(-1, 1 << 30, (s, w, e))

    def dlpns(bq):
        dl = rng.integers(-2, 1 << 30, (bq,))
        k = min(bq // 3, s)
        dl[:k] = tags[:k, 0] * e + np.arange(k) % e
        dl[k:2 * k] = (tags[:k].max(axis=1) + s) * e + 1
        dl[-3:] = [-1, -2, -e - 1]
        return torch.from_numpy(dl.astype(np.int32)).cuda()
    cmt = [torch.from_numpy(a).cuda() for a in
           (tags.astype(np.int32), valid, data.astype(np.int32))]
    return cmt, dlpns, (s, w, e)


def check_fmmu_lookup(timer, rng):
    from repro_torch.kernels.fmmu_lookup import fmmu_lookup, fmmu_lookup_ref
    cmt, dlpns, (s, w, e) = _paper_cmt(rng)
    for bq in (4096, 128, 33):
        dl = dlpns(bq)
        got = fmmu_lookup(*cmt, dl, entries_per_block=e)
        want = fmmu_lookup_ref(*cmt, dl, entries_per_block=e)
        torch.cuda.synchronize()
        for name, g, x in zip(("hit", "dppn", "set", "way"), got, want):
            if g.dtype != x.dtype or not torch.equal(g, x):
                fail(f"fmmu_lookup {name} differs at Bq={bq}")
        if not bool(got[0].any()) or bool(got[0].all()):
            fail(f"fmmu_lookup Bq={bq}: expected hits and misses")
    bq = 128                                # one call of the map phase
    dl = dlpns(bq)
    hit, _, set_idx, _ = fmmu_lookup_ref(*cmt, dl, entries_per_block=e)
    n_bytes = probe_bytes(dl, hit, set_idx, w, fallback=False)
    b_ms, b_by = bound_ms(n_bytes, bq * (w + 4), "int32")
    return {
        "name": "fmmu_lookup", "route": "cuda",
        "source": "src/repro_torch/csrc/fmmu_lookup.cu",
        "replaces": "src/repro/kernels/fmmu_lookup.py:82",
        "max_abs_err": 0.0,
        "ms": timer.ms(lambda: fmmu_lookup(*cmt, dl, entries_per_block=e)),
        "plain_ms": timer.ms(
            lambda: fmmu_lookup_ref(*cmt, dl, entries_per_block=e)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": "S=512 W=4 E=8, 128 lanes, ids >= 1<<24",
    }


# ------------------------------------------------------------------- map
def _split_order_sensitive(g, tags, valid, batch):
    """True where splitting a mixed batch into the three unfused calls
    may legally differ from the fused pass (tests/fmmu_lockstep.py):
    more than W new blocks in one set, or a cached block probed by a
    later call in a set that an earlier call inserts into."""
    from repro_torch.core.fmmu.types import COND_UPDATE, LOOKUP, UPDATE
    e, s_cnt = g.cmt_entries, g.cmt_sets
    cached = set(tags[valid].tolist())
    new = {LOOKUP: set(), UPDATE: set(), COND_UPDATE: set()}
    for k, d in batch:
        if d // e not in cached:
            new[k].add(d // e)
    per_set = {}
    for b in set().union(*new.values()):
        per_set.setdefault(b % s_cnt, set()).add(b)
    if any(len(v) > g.cmt_ways for v in per_set.values()):
        return True
    ins_l = {b % s_cnt for b in new[LOOKUP]}
    ins_all = ins_l | {b % s_cnt for b in new[UPDATE] | new[COND_UPDATE]}
    for k, d in batch:
        b = d // e
        if b in cached and ((k == UPDATE and b % s_cnt in ins_l) or
                            (k == COND_UPDATE and b % s_cnt in ins_all)):
            return True
    return False


MAP_CHANNELS = 32


def map_phase(n_batches=64, max_blocks=16):
    """The fused map path (the commit kernel, in place), its plain
    version (the torch chain, impl="ref"), the unfused path
    (fmmu_lookup and its chain) and the 32-channel sharded path (one
    launch of 32 blocks a batch) on the card, in turns.
    Returns the map line; fails unless the final states and every output
    are bit-identical (the sharded path: its outputs and interleaved
    table equal the one-channel path's after every batch)."""
    from repro_torch.core.counters import COUNTERS
    from repro_torch.core.fmmu import batch as fb
    from repro_torch.core.fmmu.types import (COND_UPDATE, LOOKUP, NIL,
                                             UPDATE, FMMUGeometry)
    g = FMMUGeometry()                     # 512 x 4 x 8, 1M-entry backing
    dev = torch.device("cuda")
    rng, nprng = random.Random(SEED), np.random.RandomState(SEED)
    n_blocks = g.n_tvpns * g.entries_per_tp // g.cmt_entries
    lo = np.arange(0, 2 * n_blocks // 3)
    hi = np.arange(2 * n_blocks // 3, n_blocks)

    def lanes(pool, kind):
        blks = nprng.choice(pool, rng.randint(1, max_blocks), replace=False)
        dl = [int(b) * g.cmt_entries + rng.randrange(g.cmt_entries)
              for b in blks for _ in range(rng.randint(1, 3))]
        return [(kind, d) for d in dict.fromkeys(dl)]

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    # generation pass (fused, untimed): draw order-insensitive batches
    st = fb.init_batch_state(g, dev)
    shadow, batches = {}, []
    while len(batches) < n_batches:
        batch = (lanes(lo, LOOKUP) + lanes(lo, UPDATE)
                 + lanes(hi, COND_UPDATE))
        rng.shuffle(batch)
        if _split_order_sensitive(g, st.tags.cpu().numpy(),
                                  st.valid.cpu().numpy(), batch):
            continue
        k = np.array([x for x, _ in batch], np.int32)
        d = np.array([x for _, x in batch], np.int32)
        p = nprng.randint(0, 10 ** 6, len(batch)).astype(np.int32)
        o = np.array([shadow.get(int(x), NIL) if rng.random() < .6
                      else rng.randrange(10 ** 6) for x in d], np.int32)
        st, out, ok = fb.translate_batch(g, st, t(k), t(d), t(p), t(o))
        ok_h = ok.cpu().numpy()
        for i, (kind, x) in enumerate(batch):
            if kind == UPDATE or (kind == COND_UPDATE and ok_h[i]):
                shadow[x] = int(p[i])
        ml, mu, mc = k == LOOKUP, k == UPDATE, k == COND_UPDATE
        batches.append({
            "fused": (t(k), t(d), t(p), t(o)),
            "lookup": t(d[ml]), "update": (t(d[mu]), t(p[mu])),
            "cond": (t(d[mc]), t(p[mc]), t(o[mc])),
            "masks": (ml, mc)})

    def run_fused():             # the commit kernel: one launch a batch
        s_, outs = fb.init_batch_state(g, dev), []
        for b in batches:
            outs.append(fb.translate_batch_(g, s_, *b["fused"]))
        return s_, outs

    def run_plain():             # the fused commit as the torch chain
        s_, outs = fb.init_batch_state(g, dev), []
        for b in batches:
            outs.append(fb.translate_batch_(g, s_, *b["fused"], impl="ref"))
        return s_, outs

    def run_unfused():
        s_, outs = fb.init_batch_state(g, dev), []
        for b in batches:
            s_, ou = fb.lookup_batch_unfused(g, s_, b["lookup"])
            s_ = fb.update_batch_unfused(g, s_, *b["update"])
            s_, oku = fb.cond_update_batch_unfused(g, s_, *b["cond"])
            outs.append((ou, oku))
        return s_, outs

    # the paper's 32-channel SSD: the map cut into 32 shards of the
    # paper's CMT (512 x 4 x 8) and 1/32 of the backing, one launch of 32
    # blocks a batch
    c_n = MAP_CHANNELS
    g_c = FMMUGeometry(n_tvpns=g.n_tvpns // c_n)

    def run_sharded():
        s_, outs = fb.init_sharded_state(g_c, c_n, device=dev), []
        for b in batches:
            outs.append(fb.translate_sharded_(g_c, c_n, s_, *b["fused"]))
        return s_, outs

    # the sharded path against the one-channel fused path (serving
    # state: its table) after every batch: outputs, ok masks and the
    # interleaved table (the reference's sharded_lockstep contract)
    n_pages = g.n_tvpns * g.entries_per_tp
    s1 = fb.init_serving_state(g, device=dev)
    s_c = fb.init_sharded_state(g_c, c_n, device=dev)
    for i, b in enumerate(batches):
        out1, ok1 = fb.translate_serving_(g, s1, *b["fused"])
        out_c, ok_c = fb.translate_sharded_(g_c, c_n, s_c, *b["fused"])
        if not (torch.equal(out1, out_c) and torch.equal(ok1, ok_c)
                and torch.equal(fb.dense_table(s_c, n_pages), s1.table)):
            fail(f"map phase: batch {i}: the {c_n}-channel path differs "
                 "from the one-channel fused path")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    paths = {"fused": run_fused, "plain": run_plain, "unfused": run_unfused,
             f"sharded_c{c_n}": run_sharded}
    for fn in paths.values():                     # warm-up
        fn()
    COUNTERS.reset()                     # every count to 0 just before
    times = {name: [] for name in paths}
    res = {}
    order = list(paths)
    for name in order + order[::-1]:
        res[name], ms_ = timed(paths[name])
        times[name].append(ms_)
    launches = COUNTERS.launches()       # ... and read just after
    st_u, outs_u = res["unfused"]
    for name in ("fused", "plain"):
        st_f, outs_f = res[name]
        for f in st_f._fields:
            if not torch.equal(getattr(st_f, f), getattr(st_u, f)):
                fail(f"map phase: state field {f} {name} != unfused")
        for i, (b, (out, ok), (ou, oku)) in enumerate(
                zip(batches, outs_f, outs_u)):
            ml, mc = (torch.from_numpy(m).to(dev) for m in b["masks"])
            if not (torch.equal(out[ml], ou) and torch.equal(ok[mc], oku)):
                fail(f"map phase: batch {i} outputs {name} != unfused")
    st_f, outs_f = res["fused"]
    for i, ((out, ok), (out_c, ok_c)) in enumerate(
            zip(outs_f, res[f"sharded_c{c_n}"][1])):
        if not (torch.equal(out, out_c) and torch.equal(ok, ok_c)):
            fail(f"map phase: batch {i} outputs sharded != fused")
    if not torch.equal(fb.dense_table(res[f"sharded_c{c_n}"][0], n_pages),
                       st_f.backing):
        fail("map phase: the sharded table differs from the fused map")
    n_lanes = sum(int(b["fused"][0].numel()) for b in batches)
    line = {"geometry": "S=512 W=4 E=8, backing 1048576",
            "geometry_sharded": f"{c_n} shards of S=512 W=4 E=8, backing "
                                f"{n_pages // c_n}",
            "batches": n_batches, "lanes": n_lanes,
            "launches": launches, "bit_identical": True}
    for name in paths:
        line[f"{name}_ms"] = times[name]
        line[f"{name}_ms_per_batch"] = statistics.median(times[name]) \
            / n_batches
    return line


# ----------------------------------------------------------------- serve
def build_engine(cfg, rt, macro_k=0, **config):
    from repro_torch.models import build_model
    from repro_torch.serving import ServeConfig, ServeEngine
    m = build_model(cfg, rt, device="cuda")
    params = m.init(torch.Generator(device="cuda").manual_seed(SEED))
    return ServeEngine(m, params, config=ServeConfig(
        n_slots=8, max_ctx=2048, macro_k=macro_k, **config), device="cuda")


def serve_prompts(cfg, lens):
    """The serving phases' prompts: seeded token ids of ``lens``."""
    prng = np.random.default_rng(SEED + 1)
    return [[int(t) for t in prng.integers(0, cfg.vocab_size, n)]
            for n in lens]


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
            "trace_launches": sum(e.count for e in kern),
            "top_kernels_ms": {k[:70]: v for k, v in top}}


def serve_phase(cfg, lens, kernels):
    """Serve 8 requests of ``lens`` prompt tokens x 32 new tokens at the
    config's published widths (bf16, page 16, 8 slots x 2048 ctx), with
    every launch count zeroed just before and read just after; fails
    unless each request returns 32 tokens and each of ``kernels`` was
    launched. Then a 2-layer f32 engine must give the same greedy
    tokens with the kernels as with kernel_impl="ref". Returns the
    serve line (with the run's launch counts)."""
    from repro_torch.core.counters import COUNTERS
    from repro_torch.models import Runtime
    rt = Runtime(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                 page_size=16)
    eng = build_engine(cfg, rt)
    prompts = serve_prompts(cfg, lens)
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
            fail(f"{cfg.name}: request {r.rid} returned {len(toks_r)} "
                 "tokens")
    for name in kernels:
        if launches.get(name, 0) <= 0:
            fail(f"{name} was not launched on the {cfg.name} serving path")
    ttft = sorted((r.t_first - r.t_submit) * 1e3 for r in reqs)
    decode_s = max(r.t_done for r in reqs) - max(r.t_first for r in reqs)
    decode_toks = sum(len(out[r.rid]) - 1 for r in reqs)
    steps = eng.metrics["decode_steps"]
    line = {
        "model": cfg.name, "dtype": "bfloat16", "page_size": 16,
        "n_slots": 8, "max_ctx": 2048, "prompt_lens": lens, "max_new": 32,
        "wall_s": wall, "ttft_ms_median": statistics.median(ttft),
        "ttft_ms_max": ttft[-1], "decode_tok_s": decode_toks / decode_s,
        "decode_step_ms": decode_s / max(steps - 1, 1) * 1e3,
        "decode_steps": steps, "prefills": eng.metrics["prefills"],
        "xlate_calls": counts.get("kvm.xlate_calls", 0),
        "host_syncs": counts.get("engine.host_syncs", 0),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches}
    line["profiled_decode_step"] = profile_decode_step(eng, prompts)
    del eng
    torch.cuda.empty_cache()

    # the kernels against their plain versions end to end: 2 layers, f32
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
        fail(f"2-layer f32 {cfg.name}: kernel tokens differ from ref tokens")
    line["ref_parity_tokens"] = sum(len(v) for v in toks["ref"].values())
    return line, [out[r.rid] for r in reqs]


# ----------------------------------------------------------- serve macro
MACRO_K = 8


def events_ms(fn, iters: int) -> float:
    """Median time of ``fn()`` by CUDA events around it (no flush)."""
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class _KernelNodeParams(ctypes.Structure):     # CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = [("func", ctypes.c_void_p),
                ("dims", ctypes.c_uint * 7),     # grid, block, shared bytes
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


def graph_nodes(graph, names=()):
    """What one replay of a captured CUDA graph launches, read through
    libcuda's graph calls, independent of any profiler: ({node type: count}
    over kernel, memcpy, memset and other nodes, {name: kernel nodes
    whose function name holds it} for each of ``names``). The graph
    must be kept after instantiation (``macro.capture`` keeps it)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        fail("cuGraphGetNodes failed")
    kinds = {0: "kernel", 1: "memcpy", 2: "memset"}
    types: dict = {}
    named = {name: 0 for name in names}
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(node, ctypes.byref(kind)):
            fail("cuGraphNodeGetType failed")
        key = kinds.get(kind.value, "other")
        types[key] = types.get(key, 0) + 1
        if key != "kernel" or not names:
            continue
        p = _KernelNodeParams()
        if cuda.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)):
            fail("cuGraphKernelNodeGetParams failed")
        fname = ctypes.c_char_p()
        err = (cuda.cuFuncGetName(ctypes.byref(fname),
                                  ctypes.c_void_p(p.func)) if p.func else
               cuda.cuKernelGetName(ctypes.byref(fname),
                                    ctypes.c_void_p(p.kern)))
        if err or not fname.value:
            fail(f"no name for a kernel node of a graph (CUresult {err})")
        for name in names:
            named[name] += name in fname.value.decode()
    return types, named


def trace_kernels(fn):
    """The device kernels of one ``fn()`` under torch.profiler, as
    key_averages entries: a reading, not a count (on that card the
    profiler loses records now and then, PERF.md §7). A profile that
    recorded no device event at all is taken once more; [] if that
    one is empty too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if kern:
            return kern
    return []


def _profile_step(eng, done, replayed):
    """One ServeEngine.step() under torch.profiler. Fails unless it made
    one macro dispatch and each hand kernel of ``replayed`` was counted
    as many times as the replayed graph has kernel nodes of that name
    (libcuda), plus one fmmu_commit for each eager map commit of the
    step (admissions, frees). Returns (trace kernels, the step's
    counter delta, wall ms, the replayed graph)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.counters import COUNTERS
    keys = []
    run = eng._graphs.run

    def spy(ms, buf, *key):
        keys.append(key)
        return run(ms, buf, *key)
    eng._graphs.run = spy
    base = COUNTERS.snapshot()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step(done)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    delta = COUNTERS.delta(base)
    eng._graphs.run = run
    if len(keys) != 1 or delta.get("engine.macro_dispatches") != 1:
        fail(f"the profiled step made {len(keys)} macro dispatches")
    graph = eng._graphs.graphs[keys[0]]
    _, named = graph_nodes(graph, replayed)
    for name in replayed:
        want = named[name] + (delta.get("kvm.xlate_calls", 0)
                              if name == "fmmu_commit" else 0)
        if delta.get(f"kernel.{name}", 0) != want:
            fail(f"{name}: {delta.get(f'kernel.{name}', 0)} launches "
                 f"counted in a macro step, {want} in its graph's kernel "
                 "nodes and eager map commits")
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return kern, delta, wall_ms, graph


def _step_reading(kern, delta, graph, replayed):
    """What one profiled step launched: the replayed graph's nodes, the
    eager map commits, and the trace's launches beside them."""
    nodes, _ = graph_nodes(graph)
    traced = {name: sum(e.count for e in kern if name in e.key)
              for name in replayed}
    return {"graph_launches": sum(nodes.values()), "graph_nodes": nodes,
            "eager_commits": delta.get("kvm.xlate_calls", 0),
            "trace_launches": sum(e.count for e in kern),
            "trace_kernel_launches": traced,
            "trace_agrees": all(traced[n] == delta.get(f"kernel.{n}", 0)
                                for n in replayed)}


def profile_macro_step(eng, prompts, replayed):
    """One steady K-step macro step (8 resident slots, no admission, no
    retirement, graphs already captured), then the next, which retires
    all 8 requests (8 frees, each one eager map commit), each under
    torch.profiler and held against its graph by ``_profile_step``.
    What a step launches comes from its graph's nodes; the trace gives
    the readings: device busy, idle share (against the profiled step and
    against an unprofiled one of the same kind just before), its own
    launch counts (``trace_agrees``: its hand-kernel launches equal the
    counted ones), the top kernels and fmmu_commit's share. Then the
    steady step's graph replayed alone, timed by CUDA events."""
    for p in prompts:
        eng.submit(p, max_new=1 + 4 * MACRO_K)   # simple runs only
    done: dict = {}
    eng.step(done)               # admission + prefill + first macro step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step(done)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_graphs = len(eng._graphs.graphs)
    kern, delta, wall_ms, graph = _profile_step(eng, done, replayed)
    if len(eng._graphs.graphs) != n_graphs or done or \
            delta.get("kvm.xlate_calls"):
        fail("the profiled steady macro step captured a new graph, "
             "committed the map eagerly or retired a request")
    kern_ret, delta_ret, _, graph_ret = _profile_step(eng, done, replayed)
    if len(done) != len(prompts):
        fail("the last profiled macro step did not retire every request")
    dev = {e.key: e.self_device_time_total / 1e3 for e in kern}
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    fc_ms = sum(e.self_device_time_total for e in kern
                if "fmmu_commit" in e.key) / 1e3
    line = {"step_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None,
            "unprofiled_step_wall_ms": plain_ms,
            "device_idle_share_unprofiled":
            1.0 - busy / plain_ms if busy else None,
            **_step_reading(kern, delta, graph, replayed),
            "fmmu_commit_ms": fc_ms,
            "fmmu_commit_share": fc_ms / busy if busy else None,
            "retiring_step": _step_reading(kern_ret, delta_ret, graph_ret,
                                           replayed),
            "top_kernels_ms": {k[:70]: v for k, v in top}}
    # the steady step's graph replayed alone; the engine is discarded
    # after this, so its state may drift
    line["replay_ms_events"] = events_ms(graph.replay, 5)
    return line


def commit_in_graph(eng):
    """The per-step map commit the K-step graph runs on every step: one
    masked ``serving_grow_`` (no lane grows) on a copy of the engine's
    map state, captured alone into a graph, through the kernel and
    through its plain chain (impl="ref"); for each, the graph's nodes
    (what a replay launches), its device busy time by torch.profiler
    (None if the trace came back empty) and its replay time by CUDA
    events. Fails unless the kernel's commit is at most 4 launches, one
    of them fmmu_commit, and the chain's launches no fmmu_commit."""
    from repro_torch.core.fmmu import batch as fb
    from repro_torch.serving import macro
    grow = torch.zeros(eng.n_slots, dtype=torch.bool, device="cuda")
    dl = torch.arange(eng.n_slots, dtype=torch.int32, device="cuda")
    line = {}
    for name, impl in (("kernel", None), ("plain", "ref")):
        ms = fb.clone_state(eng.kvm.state)

        def commit():
            fb.serving_grow_(eng.kvm.geom, ms, grow, dl, impl=impl)
        macro.uncounted(commit)                             # warm-up
        graph, _ = macro.capture(commit)
        graph.replay()
        nodes, named = graph_nodes(graph, ("fmmu_commit",))
        kern = trace_kernels(graph.replay)
        line[name] = {"launches": sum(nodes.values()), "graph_nodes": nodes,
                      "fmmu_commit_nodes": named["fmmu_commit"],
                      "device_busy_ms": sum(e.self_device_time_total
                                            for e in kern) / 1e3
                      if kern else None,
                      "replay_ms_events": events_ms(graph.replay, 20)}
    k = line["kernel"]
    if not 1 <= k["launches"] <= 4 or k["fmmu_commit_nodes"] != 1 \
            or line["plain"]["fmmu_commit_nodes"]:
        fail(f"the in-graph map commit: {line}, expected at most 4 "
             "launches, one of them fmmu_commit (none in the chain)")
    return line


def macro_phase(cfg, lens, single_tokens, replayed, eager):
    """Serve the single-step phase's requests through the K-step macro
    path (macro_k=8: one CUDA graph replay per K tokens). A first pass
    captures every graph the run needs; the counts are zeroed just
    before the second pass and read just after it. Fails unless every
    request returns its 32 tokens, equal to the single-step tokens;
    the timed pass captures nothing and makes one dispatch and one host
    sync per K tokens (plus one sync per prefill); each kernel of
    ``replayed`` shows its launches from the replays (fmmu_commit: one
    per step, plus one per admission and free) and each of
    ``eager`` (prefill) was launched. Then a 2-layer f32 macro engine
    must give the same greedy tokens with the kernels as with
    kernel_impl="ref". Returns the phase's line and its launch
    counts."""
    from repro_torch.core.counters import COUNTERS
    from repro_torch.models import Runtime
    rt = Runtime(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                 page_size=16)
    eng = build_engine(cfg, rt, macro_k=MACRO_K)
    prompts = serve_prompts(cfg, lens)
    t0 = time.perf_counter()
    first, _, _ = run_requests(eng, prompts, 32)     # captures the graphs
    first_s = time.perf_counter() - t0
    graphs = eng._graphs.stats()
    eng.metrics = {k: 0 for k in eng.metrics}
    COUNTERS.reset()                     # every count to 0 just before
    torch.cuda.reset_peak_memory_stats()
    out, reqs, wall = run_requests(eng, prompts, 32)
    launches = COUNTERS.launches()       # ... and read just after
    counts = COUNTERS.snapshot()
    toks = [out[r.rid] for r in reqs]
    for r, t in zip(reqs, toks):
        if len(t) != 32:
            fail(f"{cfg.name} macro: request {r.rid} returned {len(t)} "
                 "tokens")
    if toks != single_tokens or list(first.values()) != single_tokens:
        fail(f"{cfg.name}: macro tokens differ from single-step tokens")
    m = eng.metrics
    n_req = len(prompts)
    dispatches = counts.get("engine.macro_dispatches", 0)
    want_dispatches = -(-31 // MACRO_K)        # 31 decode tokens a slot
    if (m["macro_fallbacks"] or m["macro_steps"] != want_dispatches
            or dispatches != want_dispatches
            or counts.get("engine.host_syncs", 0) != n_req + dispatches
            or counts.get("engine.macro_captures", 0)
            or counts.get("kvm.full_table_calls", 0)
            or counts.get("kvm.alloc_syncs", 0) > 1
            or counts.get("kvm.xlate_calls", 0) != 2 * n_req):
        fail(f"{cfg.name} macro: more than one dispatch / host sync per "
             f"K tokens, or host-side map work in steady state: {counts}, "
             f"{m}")
    want = {"fmmu_commit": MACRO_K * dispatches + 2 * n_req}
    if "paged_attention" in replayed:
        n_attn = sum(cfg.layer_kind(j) == "attn"
                     for j in range(cfg.n_layers))
        want["paged_attention"] = MACRO_K * dispatches * n_attn
    for name in replayed:
        if launches.get(name, 0) != want[name]:
            fail(f"{name}: {launches.get(name, 0)} launches counted on the "
                 f"{cfg.name} macro path, expected {want[name]} (replays)")
    for name in eager:
        if launches.get(name, 0) <= 0:
            fail(f"{name} was not launched on the {cfg.name} macro path")
    ttft = sorted((r.t_first - r.t_submit) * 1e3 for r in reqs)
    decode_s = max(r.t_done for r in reqs) - max(r.t_first for r in reqs)
    decode_toks = sum(len(t) - 1 for t in toks)
    line = {
        "model": cfg.name, "dtype": "bfloat16", "page_size": 16,
        "n_slots": 8, "max_ctx": 2048, "prompt_lens": lens, "max_new": 32,
        "macro_k": MACRO_K, "wall_s": wall,
        "ttft_ms_median": statistics.median(ttft), "ttft_ms_max": ttft[-1],
        "decode_tok_s": decode_toks / decode_s,
        "decode_step_ms": decode_s / max(m["decode_steps"] - 1, 1) * 1e3,
        "decode_steps": m["decode_steps"], "macro_steps": m["macro_steps"],
        "dispatches": dispatches,
        "host_syncs": counts.get("engine.host_syncs", 0),
        "xlate_calls": counts.get("kvm.xlate_calls", 0),
        "alloc_syncs": counts.get("kvm.alloc_syncs", 0),
        "graphs_captured": graphs["graphs"],
        "capture_s": graphs["capture_s"],
        "graph_pool_bytes": graphs["pool_bytes"],
        "first_pass_s": first_s,
        # hand-kernel launches each graph counts per replay (K tokens)
        "replay_launches": {str(k): d for k, d in
                            eng._graphs.deltas.items()},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches}
    line["commit_in_graph"] = commit_in_graph(eng)
    line["profiled_macro_step"] = profile_macro_step(eng, prompts, replayed)
    del eng
    torch.cuda.empty_cache()

    # the kernels against their plain versions in macro mode: 2 layers
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    short = [p[:n // 4] for p, n in zip(prompts, lens)]
    toks2 = {}
    for impl in (None, "ref"):
        rt32 = Runtime(compute_dtype=torch.float32,
                       param_dtype=torch.float32, page_size=16,
                       kernel_impl=impl)
        e2 = build_engine(cfg2, rt32, macro_k=MACRO_K)
        toks2[impl], _, _ = run_requests(e2, short, 16)
        if e2.metrics["macro_steps"] <= 0:
            fail(f"2-layer f32 {cfg.name}: no macro step ran")
        del e2
        torch.cuda.empty_cache()
    if list(toks2[None].values()) != list(toks2["ref"].values()):
        fail(f"2-layer f32 {cfg.name} macro: kernel tokens differ from ref "
             "tokens")
    line["ref_parity_tokens"] = sum(len(v) for v in toks2["ref"].values())
    return line


# ------------------------------------------------------------ serve swap
SWAP_CONFIG = dict(n_device_blocks=128, n_host_blocks=256, swap_patience=4)


class CallLog:
    """Wraps ``obj.<name>``: every call records its host dispatch ms
    (host clock around the call), map calls, fmmu_commit launches and
    the fields ``fields(args, kwargs, result)`` gives. With ``spin``
    set, a spin kernel of that many cycles runs before each call, so
    that CUDA events around it time the device's work and not the
    host's enqueue (``events``)."""

    def __init__(self, obj, name, fields):
        from repro_torch.core.counters import COUNTERS
        self.records, self.spin = [], 0
        fn = getattr(obj, name)

        def spy(*args, **kwargs):
            base = COUNTERS.snapshot()
            ev = None
            if self.spin:
                torch.cuda._sleep(self.spin)
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            host_ms = (time.perf_counter() - t0) * 1e3
            if ev:
                ev[1].record()
            d = COUNTERS.delta(base)
            self.records.append(dict(
                fields(args, kwargs, out), host_ms=host_ms, events=ev,
                xlate_calls=d.get("kvm.xlate_calls", 0),
                fmmu_commit=d.get("kernel.fmmu_commit", 0)))
            return out
        setattr(obj, name, spy)


def swap_phase(cfg, lens, macro_line, macro_tokens):
    """The llama macro phase's requests (8 slots x 2048 ctx, macro_k=8)
    on an undersized device pool: 128 device blocks for a 252-page
    working set, 256 host blocks, swap_patience 4. A first pass captures
    the graphs; the counts are zeroed just before the second and read
    just after. A third pass runs a spin kernel before each swap, so
    that CUDA events around it time the device's work. Fails unless every
    request returns its 32 tokens, equal to the full-pool macro phase's
    (every pass), pages were swapped out and back in, each swap was one
    map call and one fmmu_commit launch, and the counted pass captured
    no graph while it rotated slots through the host tier. Returns the
    phase's line: fallbacks, preemptions, decode tokens/s and TTFT
    beside the full-pool phase's, pages and bytes moved, each swap's
    host dispatch ms (counted pass) and device ms (timed pass) beside
    its byte bound, host syncs per K tokens."""
    from repro_torch.core.counters import COUNTERS
    from repro_torch.models import Runtime
    rt = Runtime(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                 page_size=16)
    eng = build_engine(cfg, rt, macro_k=MACRO_K, **SWAP_CONFIG)
    prompts = serve_prompts(cfg, lens)
    # each swap: direction, pages, guard read (``CallLog``)
    spy = CallLog(eng.kvm, "_swap", lambda a, k, n: {
        "out": a[0], "pages": n, "check": a[4]})
    first, _, _ = run_requests(eng, prompts, 32)     # captures the graphs
    graphs_first = eng._graphs.stats()["graphs"]
    spy.records = log = []
    eng.metrics = {k: 0 for k in eng.metrics}
    COUNTERS.reset()                     # every count to 0 just before
    torch.cuda.reset_peak_memory_stats()
    out, reqs, wall = run_requests(eng, prompts, 32)
    launches = COUNTERS.launches()       # ... and read just after
    counts = COUNTERS.snapshot()
    toks = [out[r.rid] for r in reqs]
    m = eng.metrics
    for r, t in zip(reqs, toks):
        if len(t) != 32:
            fail(f"serve_swap: request {r.rid} returned {len(t)} tokens")
    if toks != macro_tokens or list(first.values()) != macro_tokens:
        fail("serve_swap: tokens differ from the full-pool macro phase's")
    if not (m["swaps_out"] > 0 and m["swaps_in"] > 0):
        fail(f"serve_swap: no swap in both directions: {m}")
    if len(log) != m["swaps_out"] + m["swaps_in"] or any(
            e["xlate_calls"] != 1 or e["fmmu_commit"] != 1 for e in log):
        fail("serve_swap: a swap was not one map call and one fmmu_commit "
             f"launch: {[(e['xlate_calls'], e['fmmu_commit']) for e in log]}")
    if counts.get("engine.macro_captures", 0) or \
            eng._graphs.stats()["graphs"] != graphs_first:
        fail("serve_swap: the counted pass captured a graph")
    m = dict(m)                          # the counted pass's metrics
    timed = []
    spy.records, spy.spin = timed, Timer.SPIN_CYCLES // 5
    again, _, _ = run_requests(eng, prompts, 32)     # the timed pass
    torch.cuda.synchronize()
    if list(again.values()) != macro_tokens or \
            [(e["out"], e["pages"]) for e in timed] != \
            [(e["out"], e["pages"]) for e in log]:
        fail("serve_swap: the timed pass differs from the counted one")
    pools = [eng.caches["pool_k"], eng.caches["pool_v"]]
    row_bytes = sum(p[:, :, 0].numel() * p.element_size() for p in pools)
    swaps = []
    for e, t in zip(log, timed):
        # each moved page: its rows read once and written once
        b_ms, _ = bound_ms(2 * e["pages"] * row_bytes, 0, "bfloat16")
        swaps.append({"dir": "out" if e["out"] else "in",
                      "pages": e["pages"], "check": e["check"],
                      "host_ms": e["host_ms"],
                      "device_ms": t["events"][0].elapsed_time(
                          t["events"][1]), "bound_ms": b_ms})
    ttft = sorted((r.t_first - r.t_submit) * 1e3 for r in reqs)
    decode_s = max(r.t_done for r in reqs) - max(r.t_first for r in reqs)
    decode_toks = sum(len(t) - 1 for t in toks)
    n_pre = m["prefills"]
    syncs = counts.get("engine.host_syncs", 0)
    pages = sum(e["pages"] for e in log)
    line = {
        "model": cfg.name, "dtype": "bfloat16", "page_size": 16,
        "n_slots": 8, "max_ctx": 2048, "prompt_lens": lens, "max_new": 32,
        "macro_k": MACRO_K, **SWAP_CONFIG,
        "pool_rows": eng.scratch_block + 1, "row_bytes": row_bytes,
        "wall_s": wall,
        "ttft_ms_median": statistics.median(ttft), "ttft_ms_max": ttft[-1],
        "decode_tok_s": decode_toks / decode_s,
        "decode_step_ms": decode_s / max(m["decode_steps"] - 1, 1) * 1e3,
        "full_pool": {k: macro_line[k] for k in (
            "ttft_ms_median", "ttft_ms_max", "decode_tok_s",
            "decode_step_ms", "macro_steps", "graphs_captured")},
        "decode_steps": m["decode_steps"], "macro_steps": m["macro_steps"],
        "macro_fallbacks": m["macro_fallbacks"],
        "preemptions": m["preemptions"],
        "swaps_out": m["swaps_out"], "swaps_in": m["swaps_in"],
        "pages_moved": pages, "bytes_moved": 2 * pages * row_bytes,
        "guard_reads": sum(e["check"] for e in log),
        "host_syncs": syncs, "prefill_syncs": n_pre,
        "host_syncs_per_run": (syncs - n_pre)
            / (m["macro_steps"] + m["macro_fallbacks"]),
        # blocking reads a K-token stretch of decode makes: each run's
        # token read (a fallback step's too) and each preemption's guard
        "host_syncs_per_k_tokens":
            (syncs - n_pre + sum(e["check"] for e in log)) * MACRO_K
            / m["decode_steps"],
        "xlate_calls": counts.get("kvm.xlate_calls", 0),
        "alloc_syncs": counts.get("kvm.alloc_syncs", 0),
        "graphs_captured": eng._graphs.stats()["graphs"],
        "captures_counted_pass": counts.get("engine.macro_captures", 0),
        "swap_host_ms_median": statistics.median(s["host_ms"]
                                                 for s in swaps),
        "swap_device_ms_median": statistics.median(s["device_ms"]
                                                   for s in swaps),
        "swaps": swaps,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches}
    del eng
    torch.cuda.empty_cache()
    return line


# ------------------------------------------------------- serve channels
SERVE_CHANNELS = 8


class BoundaryLog:
    """Wraps a channel-sharded engine's K-step boundary: for each
    boundary, the map calls and fmmu_commit launches made before its
    graph replay (the growth pre-commit), the replayed graph's key, and
    each pre-commit's host dispatch ms (host clock around the call).
    With ``spin`` set, a spin kernel of that many cycles runs before
    each pre-commit, so that CUDA events around it time the device's
    work and not the host's enqueue (``events``)."""

    def __init__(self, eng):
        from repro_torch.core.counters import COUNTERS
        self.boundaries, self.commits, self.spin = [], [], 0
        step, replay = eng._macro_decode_step_sharded, eng._graphs.run
        precommit = eng.kvm.precommit_growth
        base = {}

        def spy_step(done):
            base["at"] = COUNTERS.snapshot()
            self.boundaries.append({"key": None})
            return step(done)

        def spy_replay(ms, buf, *key):
            d = COUNTERS.delta(base["at"])
            self.boundaries[-1].update(
                key=key, xlate_calls=d.get("kvm.xlate_calls", 0),
                fmmu_commit=d.get("kernel.fmmu_commit", 0))
            return replay(ms, buf, *key)

        def spy_precommit(grow_seq, dlpns=None):
            ev = None
            if self.spin:
                torch.cuda._sleep(self.spin)
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record()
            t0 = time.perf_counter()
            got = precommit(grow_seq, dlpns=dlpns)
            host_ms = (time.perf_counter() - t0) * 1e3
            if ev:
                ev[1].record()
            if grow_seq:
                self.commits.append({"lanes": len(grow_seq),
                                     "host_ms": host_ms, "events": ev})
            return got
        eng._macro_decode_step_sharded = spy_step
        eng._graphs.run = spy_replay
        eng.kvm.precommit_growth = spy_precommit
        self.eng = eng

    def remove(self):
        """Uninstall the spies: the engine's own bound methods again."""
        del self.eng._macro_decode_step_sharded, self.eng._graphs.run, \
            self.eng.kvm.precommit_growth


def _oversub_parity(cfg, channels):
    """A 2-layer f32 engine at ``channels`` with the reference test's
    oversubscribed pool (4 slots x 64 ctx, page 8, 10 device + 24 host
    blocks, macro_k 4, swap_patience 2; four 8-token prompts x 24 new
    tokens), with the kernels and with kernel_impl="ref": the tokens
    must be equal, with no fallback and swaps both ways. kernel_impl
    reaches the model's kernels only: both arms commit the map through
    ``fmmu_commit`` (``check_serving_grid_commits`` holds it against its
    plain chain at the served shape). Returns the tokens' count."""
    from repro_torch.models import Runtime, build_model
    from repro_torch.serving import ServeConfig, ServeEngine
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    prompts = [list(range(1 + 20 * i, 9 + 20 * i)) for i in range(4)]
    toks = {}
    for impl in (None, "ref"):
        rt32 = Runtime(compute_dtype=torch.float32,
                       param_dtype=torch.float32, page_size=8,
                       kernel_impl=impl)
        m = build_model(cfg2, rt32, device="cuda")
        params = m.init(torch.Generator(device="cuda").manual_seed(SEED))
        eng = ServeEngine(m, params, config=ServeConfig(
            n_slots=4, max_ctx=64, n_device_blocks=10, n_host_blocks=24,
            macro_k=4, swap_patience=2, channels=channels), device="cuda")
        toks[impl], _, _ = run_requests(eng, prompts, 24)
        met = eng.metrics
        if met["macro_fallbacks"] or not (met["swaps_out"] and
                                          met["swaps_in"]):
            fail(f"2-layer f32 at {channels} channels, oversubscribed: "
                 f"{met}")
        del eng, m, params
        torch.cuda.empty_cache()
    if list(toks[None].values()) != list(toks["ref"].values()):
        fail(f"2-layer f32 at {channels} channels, oversubscribed: kernel "
             "tokens differ from ref tokens")
    return sum(len(v) for v in toks["ref"].values())


def _decode_in_turns(cfg, rt, prompts, eng_c, tokens, order="1CC11C"):
    """Decode tokens/s and TTFT of the sharded engine ``eng_c`` and a
    new one-channel macro engine of the same weights, pass by pass in
    turns (one-channel, C, C, one-channel, ...), the graphs of both
    captured first; then each engine's steady graph replayed alone (CUDA
    events). Fails unless every pass gives ``tokens``. Returns
    {"1": {...}, "C": {...}} with the passes' readings and medians."""
    eng_1 = build_engine(cfg, rt, macro_k=MACRO_K)
    run_requests(eng_1, prompts, 32)                 # captures the graphs
    engines = {"1": eng_1, "C": eng_c}
    out = {k: {"decode_tok_s": [], "ttft_ms_median": []} for k in engines}
    for k in order:
        got, reqs, _ = run_requests(engines[k], prompts, 32)
        if list(got.values()) != tokens:
            fail(f"serve_channels: a pass in turns ({k}) changed the tokens")
        decode_s = max(r.t_done for r in reqs) - max(r.t_first for r in reqs)
        out[k]["decode_tok_s"].append(
            sum(len(t) - 1 for t in got.values()) / decode_s)
        out[k]["ttft_ms_median"].append(statistics.median(
            (r.t_first - r.t_submit) * 1e3 for r in reqs))
    for k, eng in engines.items():
        for name in ("decode_tok_s", "ttft_ms_median"):
            out[k][name + "_median"] = statistics.median(out[k][name])
        # the engines are discarded after this, so their state may drift
        keys = list(eng._graphs.graphs)
        out[k]["replay_ms_events"] = {
            str(key): events_ms(eng._graphs.graphs[key].replay, 5)
            for key in keys}
    del eng_1, engines
    torch.cuda.empty_cache()
    return out


def channels_phase(cfg, lens, macro_line, macro_tokens):
    """The llama macro phase's requests (8 slots x 2048 ctx, page 16,
    bf16, macro_k=8) with the map sharded across 8 channels: each
    K-step run's growth is pre-committed at the boundary (one map call,
    one fmmu_commit launch of 8 blocks) and the graphs decode against
    that table. A first pass captures the graphs; the counts are zeroed
    just before the second and read just after. A third pass runs a
    spin kernel before each pre-commit, so that CUDA events time its
    device work. Fails unless the tokens equal the one-channel macro
    phase's (every pass), each run is one dispatch and one host sync,
    each boundary makes at most one map call and one fmmu_commit launch,
    no graph holds an fmmu_commit node, no round falls back, and every
    channel serviced at least 1/(2C) of the lanes. Then the sharded and
    a one-channel engine in turns (``_decode_in_turns``), and the
    2-layer f32 kernel-vs-ref parity at two channels, oversubscribed.
    Returns the phase's line."""
    from repro_torch.core.counters import COUNTERS
    from repro_torch.models import Runtime
    c_n = SERVE_CHANNELS
    rt = Runtime(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                 page_size=16)
    eng = build_engine(cfg, rt, macro_k=MACRO_K, channels=c_n)
    prompts = serve_prompts(cfg, lens)
    log = BoundaryLog(eng)
    first, _, _ = run_requests(eng, prompts, 32)     # captures the graphs
    graphs_first = eng._graphs.stats()["graphs"]
    log.boundaries, log.commits = [], []
    eng.metrics = {k: 0 for k in eng.metrics}
    eng.kvm.channel_lanes[:] = 0
    COUNTERS.reset()                     # every count to 0 just before
    torch.cuda.reset_peak_memory_stats()
    out, reqs, wall = run_requests(eng, prompts, 32)
    launches = COUNTERS.launches()       # ... and read just after
    counts = COUNTERS.snapshot()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    toks = [out[r.rid] for r in reqs]
    m = dict(eng.metrics)
    lanes = eng.kvm.channel_lanes.copy()
    boundaries, commits = log.boundaries, log.commits
    if toks != macro_tokens or list(first.values()) != macro_tokens:
        fail("serve_channels: tokens differ from the one-channel macro "
             "phase's")
    n_req = len(prompts)
    dispatches = counts.get("engine.macro_dispatches", 0)
    if (m["macro_fallbacks"] or dispatches != m["macro_steps"]
            or dispatches != len(boundaries)
            or counts.get("engine.host_syncs", 0) != n_req + dispatches
            or counts.get("engine.macro_captures", 0)
            or counts.get("kvm.full_table_calls", 0)
            or counts.get("kvm.alloc_syncs", 0)):
        fail(f"serve_channels: more than one dispatch / host sync per K "
             f"tokens, a fallback or a capture: {counts}, {m}")
    if any(b["key"] is None or b["xlate_calls"] > 1 or b["fmmu_commit"] > 1
           for b in boundaries) or not commits:
        fail(f"serve_channels: a boundary made more than one map call or "
             f"fmmu_commit launch: {boundaries}")
    nodes = {}
    for key, graph in eng._graphs.graphs.items():
        types, named = graph_nodes(graph, ("fmmu_commit", "paged_attention"))
        if named["fmmu_commit"]:
            fail(f"serve_channels: graph {key} holds "
                 f"{named['fmmu_commit']} fmmu_commit nodes")
        nodes[key] = (sum(types.values()), named["paged_attention"])
    if lanes.min() * 2 * c_n < lanes.sum():
        fail(f"serve_channels: channel lanes {lanes.tolist()}, a channel "
             f"under 1/(2C) of {lanes.sum()}")
    timed = []
    log.commits, log.spin = timed, Timer.SPIN_CYCLES // 5
    again, _, _ = run_requests(eng, prompts, 32)     # the timed pass
    torch.cuda.synchronize()
    if list(again.values()) != macro_tokens or \
            [c["lanes"] for c in timed] != [c["lanes"] for c in commits]:
        fail("serve_channels: the timed pass differs from the counted one")
    device_ms = [c["events"][0].elapsed_time(c["events"][1]) for c in timed]
    steady = max(set(b["key"] for b in boundaries),
                 key=[b["key"] for b in boundaries].count)
    log.remove()         # the passes in turns run both engines bare
    turns = _decode_in_turns(cfg, rt, prompts, eng, macro_tokens)
    ttft = sorted((r.t_first - r.t_submit) * 1e3 for r in reqs)
    decode_s = max(r.t_done for r in reqs) - max(r.t_first for r in reqs)
    decode_toks = sum(len(t) - 1 for t in toks)
    line = {
        "model": cfg.name, "dtype": "bfloat16", "page_size": 16,
        "n_slots": 8, "max_ctx": 2048, "prompt_lens": lens, "max_new": 32,
        "macro_k": MACRO_K, "channels": c_n,
        "geometry_per_channel": str(eng.kvm.geom), "wall_s": wall,
        "ttft_ms_median": statistics.median(ttft), "ttft_ms_max": ttft[-1],
        "decode_tok_s": decode_toks / decode_s,
        "decode_step_ms": decode_s / max(m["decode_steps"] - 1, 1) * 1e3,
        "one_channel": {k: macro_line[k] for k in (
            "ttft_ms_median", "ttft_ms_max", "decode_tok_s",
            "decode_step_ms", "macro_steps", "graphs_captured")},
        "one_channel_graph_launches_per_k_tokens":
            macro_line["profiled_macro_step"]["graph_launches"],
        "decode_steps": m["decode_steps"], "macro_steps": m["macro_steps"],
        "macro_fallbacks": m["macro_fallbacks"], "dispatches": dispatches,
        "host_syncs": counts.get("engine.host_syncs", 0),
        "xlate_calls": counts.get("kvm.xlate_calls", 0),
        "alloc_syncs": counts.get("kvm.alloc_syncs", 0),
        "boundary_map_calls": [b["xlate_calls"] for b in boundaries],
        "boundary_fmmu_commit": [b["fmmu_commit"] for b in boundaries],
        "precommits": len(commits),
        "precommit_lanes": [c["lanes"] for c in commits],
        "precommit_host_ms": [c["host_ms"] for c in commits],
        "precommit_host_ms_median": statistics.median(
            c["host_ms"] for c in commits),
        "precommit_device_ms": device_ms,
        "precommit_device_ms_median": statistics.median(device_ms),
        "channel_lanes": lanes.tolist(),
        "graphs_captured": eng._graphs.stats()["graphs"],
        "graphs_first_pass": graphs_first,
        "graph_launches_per_k_tokens": nodes[steady][0],
        "graph_paged_attention_nodes": nodes[steady][1],
        "graph_fmmu_commit_nodes": 0,
        "in_turns": turns, "peak_mem_gib": peak_gib,
        "launches": launches}
    del eng, log
    torch.cuda.empty_cache()
    line["oversub_ref_parity_tokens"] = _oversub_parity(cfg, 2)
    return line


# --------------------------------------------------------- serve faults
# the fault plan of serve_faults and of its 2-layer parity engine: on
# the swap phase's schedule every axis fires (swaps fail, one request is
# quarantined, blocks retire at admission, growth and after K-step runs,
# allocations fail transiently), found by replaying that schedule on the
# CPU with a 1-layer model (the schedule does not depend on the weights:
# no EOS)
FAULT_SEED = 2
FAULT_PLAN = dict(swap_fail_p=0.2, program_fail_p=0.03, alloc_fail_p=0.05)


def _fault_parity(cfg):
    """A 2-layer f32 engine at 2 channels on the reference test's
    oversubscribed pool (``_oversub_parity``'s shape) under the fault
    plan, journaled, with the kernels and with kernel_impl="ref": the
    tokens must be equal, every axis must fire, and the two journals
    must be equal frame for frame. Returns (tokens, frames) counted."""
    import tempfile
    from repro_torch.core import journal as jl
    from repro_torch.core.faults import FaultPlane, make_plan
    from repro_torch.models import Runtime, build_model
    from repro_torch.serving import ServeConfig, ServeEngine
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    prompts = [list(range(1 + 20 * i, 9 + 20 * i)) for i in range(4)]
    toks, frames = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for impl in (None, "ref"):
            rt32 = Runtime(compute_dtype=torch.float32,
                           param_dtype=torch.float32, page_size=8,
                           kernel_impl=impl)
            m = build_model(cfg2, rt32, device="cuda")
            params = m.init(torch.Generator(device="cuda").manual_seed(SEED))
            d = os.path.join(tmp, str(impl))
            plane = FaultPlane(make_plan(FAULT_SEED, channels=2,
                                         **FAULT_PLAN))
            eng = ServeEngine(m, params, config=ServeConfig(
                n_slots=4, max_ctx=64, n_device_blocks=10, n_host_blocks=24,
                macro_k=4, swap_patience=2, channels=2, journal_path=d),
                device="cuda", fault_plane=plane)
            toks[impl], _, _ = run_requests(eng, prompts, 24)
            if not all(plane.counts()[a] for a in ("swap", "program",
                                                   "alloc")):
                fail(f"2-layer f32 fault parity: an axis never fired: "
                     f"{plane.counts()}")
            eng.journal.close()
            frames[impl] = [jl.read_frames(os.path.join(d, n))[0]
                            for n in ("journal.log", "oob.log")]
            del eng, m, params
            torch.cuda.empty_cache()
    if list(toks[None].values()) != list(toks["ref"].values()):
        fail("2-layer f32 under faults: kernel tokens differ from ref tokens")
    if frames[None] != frames["ref"]:
        fail("2-layer f32 under faults: the kernel engine's journal differs "
             "from the ref engine's")
    return (sum(len(v) for v in toks["ref"].values()),
            sum(len(f) for f in frames["ref"]))


def faults_phase(cfg, lens, swap_line, macro_tokens):
    """The swap phase's requests and pool (8 slots x 2048 ctx, macro_k=8,
    128 device + 256 host blocks) under ``FAULT_PLAN``: swaps fail
    (backoff, one quarantine), blocks fail their programs (retired and
    relocated, after a K-step run with the rows it wrote), allocations
    fail transiently. Each pass resets the engine with a fresh plane of
    the same plan (the graphs and caches stay): a first pass captures
    the graphs; the counts are zeroed just before the second and read
    just after; a third runs a spin kernel before each retirement, so
    that CUDA events time its device work. Fails unless every request
    returns the full-pool macro phase's tokens (every pass), every axis
    fired, each retirement was one map call and one fmmu_commit launch,
    and the counted pass captured no graph. Then the 2-layer f32
    kernel-vs-ref parity under the plan with a journal
    (``_fault_parity``). Returns the phase's line."""
    from repro_torch.core.counters import COUNTERS
    from repro_torch.core.faults import FaultPlane, make_plan
    from repro_torch.models import Runtime
    rt = Runtime(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                 page_size=16)
    eng = build_engine(cfg, rt, macro_k=MACRO_K, **SWAP_CONFIG)
    prompts = serve_prompts(cfg, lens)
    # each retirement: pages relocated, rows moved or not (``CallLog``)
    log = CallLog(eng.kvm, "retire_bad_blocks", lambda a, k, n: {
        "pages": n, "rows": bool(k.get("pools"))})

    def one_pass():
        plane = FaultPlane(make_plan(FAULT_SEED, **FAULT_PLAN))
        eng.reset(plane)
        out, reqs, wall = run_requests(eng, prompts, 32)
        if [out[r.rid] for r in reqs] != macro_tokens:
            fail("serve_faults: tokens differ from the full-pool macro "
                 "phase's")
        return plane, reqs, wall
    one_pass()                                       # captures the graphs
    graphs_first = eng._graphs.stats()["graphs"]
    log.records = recs = []
    COUNTERS.reset()                     # every count to 0 just before
    plane, reqs, wall = one_pass()
    launches = COUNTERS.launches()       # ... and read just after
    counts = COUNTERS.snapshot()
    m, fired = dict(eng.metrics), plane.counts()
    st = eng.kvm.hit_stats()
    if not all(fired[a] for a in ("swap", "program", "alloc")):
        fail(f"serve_faults: an axis never fired: {fired}")
    done = [r for r in recs if r["pages"]]
    if not done or any((r["xlate_calls"], r["fmmu_commit"]) !=
                       ((1, 1) if r["pages"] else (0, 0)) for r in recs):
        fail("serve_faults: a retirement was not one map call and one "
             f"fmmu_commit launch: {recs}")
    if counts.get("engine.macro_captures", 0) or \
            eng._graphs.stats()["graphs"] != graphs_first:
        fail("serve_faults: the counted pass captured a graph")
    timed = []
    log.records, log.spin = timed, Timer.SPIN_CYCLES // 5
    one_pass()                                       # the timed pass
    torch.cuda.synchronize()
    if [(r["pages"], r["rows"]) for r in timed] != \
            [(r["pages"], r["rows"]) for r in recs]:
        fail("serve_faults: the timed pass retired otherwise")
    pools = [eng.caches["pool_k"], eng.caches["pool_v"]]
    row_bytes = sum(p[:, :, 0].numel() * p.element_size() for p in pools)
    retirements = []
    for r, t in zip(recs, timed):
        if not r["pages"]:
            continue
        # each page: its 4 lane inputs, 2 outputs, and the backing, table
        # and data words it writes; with rows, its KV rows read and
        # written once
        b_ms, b_by = bound_ms(r["pages"] * (4 * 4 + 4 + 1 + 3 * 4)
                              + (2 * r["pages"] * row_bytes if r["rows"]
                                 else 0), 0, "bfloat16")
        retirements.append({
            "pages": r["pages"], "rows_moved": r["rows"],
            "host_ms": r["host_ms"],
            "device_ms": t["events"][0].elapsed_time(t["events"][1]),
            "bound_ms": b_ms, "bound_by": b_by})
    decode_s = max(r.t_done for r in reqs) - max(r.t_first for r in reqs)
    line = {
        "model": cfg.name, "dtype": "bfloat16", "page_size": 16,
        "n_slots": 8, "max_ctx": 2048, "prompt_lens": lens, "max_new": 32,
        "macro_k": MACRO_K, **SWAP_CONFIG, "fault_seed": FAULT_SEED,
        **FAULT_PLAN, "fired": fired, "wall_s": wall,
        "decode_tok_s": sum(len(r.out[:r.max_new]) - 1 for r in reqs)
        / decode_s,
        "decode_tok_s_serve_swap": swap_line["decode_tok_s"],
        "wall_s_serve_swap": swap_line["wall_s"],
        "macro_steps": m["macro_steps"],
        "macro_fallbacks": m["macro_fallbacks"],
        "swap_faults": m["swap_faults"], "quarantines": m["quarantines"],
        "requeues": m["requeues"], "preemptions": m["preemptions"],
        "swaps_out": m["swaps_out"], "swaps_in": m["swaps_in"],
        "retire_calls": len(recs), "retirements": len(done),
        "retired_blocks": st["retired_blocks"],
        "retired_ch": st["retired_ch"],
        "pages_relocated": sum(r["pages"] for r in done),
        "retirements_with_rows": sum(r["rows"] for r in done),
        "retire_host_ms_median": statistics.median(
            r["host_ms"] for r in retirements),
        "retire_device_ms_median": statistics.median(
            r["device_ms"] for r in retirements),
        "retire_bound_ms_median": statistics.median(
            r["bound_ms"] for r in retirements),
        "retire": retirements, "row_bytes": row_bytes,
        "xlate_calls": counts.get("kvm.xlate_calls", 0),
        "graphs_captured": eng._graphs.stats()["graphs"],
        "captures_counted_pass": counts.get("engine.macro_captures", 0),
        "launches": launches}
    del eng, log
    torch.cuda.empty_cache()
    line["parity_tokens"], line["parity_journal_frames"] = \
        _fault_parity(cfg)
    return line


# -------------------------------------------------------- serve recover
RECOVER_STALL = 2.0        # channel 3 browned out


def recover_phase(cfg, lens, channels_line, macro_tokens):
    """The channel phase's configuration (8 slots x 2048 ctx, macro_k=8,
    8 channels) under a plan with program faults and channel 3 browned
    out (stall ``RECOVER_STALL``), with the journal in a temporary
    directory. Passes, each after ``reset`` with a fresh plane of the
    plan: one to capture the graphs, one without a journal and one with
    it (decode tokens/s of both, host ms of each append and snapshot,
    journal bytes a record; its first PRECOMMIT record locates the
    crash), then one that cuts power while that record is written
    (``crash_at`` there, tear 0.9: its OOB frame lands whole, its record
    does not). The engine that crashed recovers (``recover``: its graphs
    kept) and drains; a fresh engine recovers from the same journal
    state and drains. Fails unless each drain gives the one-channel
    macro phase's tokens, ``last_recovery`` reports the OOB scan, the
    restore is one map call and one fmmu_commit launch, and the crashed
    engine captures no graph for a variant it had captured. Returns the
    phase's line."""
    import shutil
    import tempfile
    from repro_torch.core import journal as jl
    from repro_torch.core.counters import COUNTERS
    from repro_torch.core.faults import Crash, FaultPlane, make_plan
    from repro_torch.models import Runtime
    from repro_torch.serving import ServeEngine
    c_n = SERVE_CHANNELS
    stall = [1.0] * c_n
    stall[3] = RECOVER_STALL
    kw = dict(channels=c_n, program_fail_p=0.02, stall=stall)
    rt = Runtime(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                 page_size=16)
    eng = build_engine(cfg, rt, macro_k=MACRO_K, channels=c_n)
    prompts = serve_prompts(cfg, lens)
    tmp = tempfile.mkdtemp()

    def one_pass(journal=None, crash_at=None):
        plan = make_plan(FAULT_SEED, crash_at=crash_at, **kw)
        eng.reset(FaultPlane(plan._replace(
            crash_tear=np.full_like(plan.crash_tear, 0.9))))
        if journal:
            eng.attach_journal(journal, snapshot_every=4)
        out, reqs, wall = run_requests(eng, prompts, 32)
        if [out[r.rid] for r in reqs] != macro_tokens:
            fail("serve_recover: tokens differ from the one-channel macro "
                 "phase's")
        decode_s = max(r.t_done for r in reqs) - max(r.t_first for r in reqs)
        return sum(len(out[r.rid]) - 1 for r in reqs) / decode_s
    one_pass()                                       # captures the graphs
    tok_s_plain = one_pass()
    times = {"append": [], "snapshot": []}
    spied = {}
    for name in times:
        orig = getattr(jl.Journal, name)

        def timed(self, *a, _orig=orig, _name=name, **k):
            t0 = time.perf_counter()
            try:
                return _orig(self, *a, **k)
            finally:
                times[_name].append((time.perf_counter() - t0) * 1e3)
        spied[name] = orig
        setattr(jl.Journal, name, timed)
    try:
        d_ok = os.path.join(tmp, "journaled")
        tok_s_journal = one_pass(d_ok)
    finally:
        for name, orig in spied.items():
            setattr(jl.Journal, name, orig)
    n_records = eng.journal.records
    eng.journal.close()
    frames, _, _ = jl.read_frames(os.path.join(d_ok, "journal.log"))
    j_bytes = os.path.getsize(os.path.join(d_ok, "journal.log"))
    o_bytes = os.path.getsize(os.path.join(d_ok, "oob.log"))
    seq = next(s for s, k, _ in frames if k == jl.PRECOMMIT)
    d = os.path.join(tmp, "crash")
    try:
        one_pass(d, crash_at=seq - 1)
        fail("serve_recover: the scheduled power cut never fired")
    except Crash as e:
        crash = {"seq": e.seq, "kind": e.kind, "torn": e.torn}
    d_fresh = os.path.join(tmp, "fresh")
    shutil.copytree(d, d_fresh)

    def drain(e, path):
        """Recover ``e`` from ``path`` (restore counted) and drain, every
        count zeroed just before and read just after; the tokens of
        every prompt. Returns (last_recovery, restore counts, captures
        during the drain, launches)."""
        restore = e.kvm.restore_mapping
        rc = {}

        def spy(rec):
            base = COUNTERS.snapshot()
            n = restore(rec)
            dd = COUNTERS.delta(base)
            rc.update(pages=n, xlate_calls=dd.get("kvm.xlate_calls", 0),
                      fmmu_commit=dd.get("kernel.fmmu_commit", 0))
            return n
        e.kvm.restore_mapping = spy
        COUNTERS.reset()
        try:
            durable = e.recover(path)
        finally:
            del e.kvm.restore_mapping
        c0 = COUNTERS.snapshot().get("engine.macro_captures", 0)
        present = set(durable) | {r.rid for r in e.queue}
        if present != set(range(len(prompts))):
            fail(f"serve_recover: requests lost in the crash: {present}")
        done = e.run()
        torch.cuda.synchronize()
        launches = COUNTERS.launches()
        got = {**durable, **done}
        if [got[r] for r in range(len(prompts))] != macro_tokens:
            fail("serve_recover: the recovered drain's tokens differ from "
                 "the one-channel macro phase's")
        e.journal.close()
        return dict(e.last_recovery), rc, \
            COUNTERS.snapshot().get("engine.macro_captures", 0) - c0, \
            launches
    keys_before = set(eng._graphs.graphs)
    info, restore, captured, launches = drain(eng, d)
    for name in MODELS["llama3.2-1b"]["single"]:
        if launches.get(name, 0) <= 0:
            fail(f"serve_recover: {name} was not launched in the recovered "
                 "drain")
    new_keys = set(eng._graphs.graphs) - keys_before
    if captured != len(new_keys):
        fail(f"serve_recover: {captured} captures for {len(new_keys)} new "
             "variants: a variant captured twice")
    fresh = ServeEngine(eng.m, eng.params, config=eng.config, device="cuda")
    info_fresh, restore_fresh, captured_fresh, _ = drain(fresh, d_fresh)
    for i, rc in ((info, restore), (info_fresh, restore_fresh)):
        if not i["oob_scan"] or (rc["xlate_calls"], rc["fmmu_commit"]) \
                != (1, 1):
            fail(f"serve_recover: recovery {i}, restore {rc}: expected the "
                 "OOB scan and one map call and one fmmu_commit launch")
    line = {
        "model": cfg.name, "dtype": "bfloat16", "page_size": 16,
        "n_slots": 8, "max_ctx": 2048, "prompt_lens": lens, "max_new": 32,
        "macro_k": MACRO_K, "channels": c_n, "fault_seed": FAULT_SEED,
        "program_fail_p": kw["program_fail_p"], "stall": stall,
        "crash": crash, "crash_tear": 0.9,
        "recover_s": info["recover_s"],
        "recover_s_fresh_engine": info_fresh["recover_s"],
        "last_recovery": info, "restore": restore,
        "restore_fresh_engine": restore_fresh,
        "captures_after_recovery": captured,
        "new_variants_after_recovery": len(new_keys),
        "captures_fresh_engine": captured_fresh,
        "records": n_records, "journal_bytes": j_bytes,
        "oob_bytes": o_bytes, "journal_bytes_per_record": j_bytes / n_records,
        "append_host_ms_median": statistics.median(times["append"]),
        "append_host_ms_max": max(times["append"]),
        "snapshots": len(times["snapshot"]),
        "snapshot_host_ms_median": statistics.median(times["snapshot"]),
        "decode_tok_s_journaled": tok_s_journal,
        "decode_tok_s_unjournaled": tok_s_plain,
        "decode_tok_s_serve_channels": channels_line["decode_tok_s"],
        "launches": launches}
    del eng, fresh
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return line


# the two served models: prompt lengths, and the kernels each path must
# launch (single-step; replayed by the macro graphs; eager in macro mode)
MODELS = {
    # the 1020-token prompt reaches 1024 tokens (65 pages) at step 4 of
    # its first K-step run, so the macro-vs-single-step check spans a
    # page-bucket change (64 -> 128 pages) inside a run
    "llama3.2-1b": dict(
        lens=[64, 128, 256, 384, 512, 640, 768, 1020],
        single=("fmmu_commit", "paged_attention", "flash_attention"),
        replayed=("fmmu_commit", "paged_attention"),
        eager=("flash_attention",)),
    "mamba2-1.3b": dict(
        lens=[64, 200, 256, 384, 512, 700, 768, 1024],
        single=("mamba_chunk_scan", "fmmu_commit"),
        replayed=("fmmu_commit",), eager=("mamba_chunk_scan",)),
}


def model_phases(name: str) -> dict:
    """Both serving phases of one model: single-step, then the K-step
    macro path (the main path). Returns their lines."""
    from repro_torch.configs import get_arch
    cfg, spec = get_arch(name), MODELS[name]
    t0 = time.perf_counter()
    serve, single = serve_phase(cfg, spec["lens"], spec["single"])
    print(f"serve {name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    serve_macro = macro_phase(cfg, spec["lens"], single, spec["replayed"],
                              spec["eager"])
    print(f"serve macro {name}: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    if cfg.ssm is not None:
        for line, n_pre in ((serve, serve["prefills"]),
                            (serve_macro, len(spec["lens"]))):
            n_scan = line["launches"]["mamba_chunk_scan"]
            if n_scan != cfg.n_layers * n_pre:
                fail(f"mamba_chunk_scan launched {n_scan} times, expected "
                     f"{cfg.n_layers} per prefill")
    return {"serve": serve, "serve_macro": serve_macro, "tokens": single}


def _setup() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    _setup()
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

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
    rows = {r["name"]: r for r in (
        check_fmmu_translate(timer, rng), check_fmmu_commit(timer, rng),
        check_paged_attention(timer, rng), check_flash_attention(timer),
        check_fmmu_lookup(timer, rng), check_mamba_chunk_scan(timer))}
    # the probe kernel's time, beside the commit kernel that redesigned it
    rows["fmmu_commit"]["first_version_ms"] = rows["fmmu_translate"]["ms"]
    # the channel grid: one launch of C blocks, C in {2, 8, 32}
    rows["fmmu_commit"].update(check_fmmu_commit_grid(timer, rng))
    rows["fmmu_commit"]["shape"] += (
        "; _grid_cN: S=512 W=4 E=8 NP=1048576 cut into N shards of "
        "NP/N, 64 mixed lanes (translate_sharded_; c1: the unstacked "
        f"whole map); _serve_c{SERVE_CHANNELS}_*: {SERVE_CHANNELS} shards "
        "of S=8 W=4 E=8 NP=128 (serve_channels' map): the growth "
        "pre-commit (8 UPDATE lanes) and a slot's swap-out / swap-in "
        f"({SWAP_LANES} COND_UPDATE lanes, {SWAP_STALE} stale)")
    # the fault plane's commits: a retirement and a restore, C = 1 and 8
    rows["fmmu_commit"].update(check_fault_commits(timer, rng))
    rows["fmmu_commit"]["shape"] += (
        f"; _retire_cN / _restore_cN: the llama serving map at N channels "
        f"(_geometry(8, 128, N)): {RETIRE_LANES} COND_UPDATE lanes moving "
        "pages off bad blocks; 1024 UPDATE lanes, every page of 8 slots, "
        "into a fresh state")
    print("kernels: all match their plain versions", file=sys.stderr)

    # 3. llama3.2-1b serving, single-step then macro (fmmu_commit, paged
    # and flash attention)
    llama = model_phases("llama3.2-1b")
    serve, serve_macro = llama["serve"], llama["serve_macro"]
    serve["build_s"] = build_s

    # 3c. the same requests on an undersized device pool with a host
    # tier: swaps, preemption and swap-pending lanes in the K-step graphs
    t0 = time.perf_counter()
    serve_swap = swap_phase(get_arch("llama3.2-1b"),
                            MODELS["llama3.2-1b"]["lens"], serve_macro,
                            llama["tokens"])
    print(f"serve swap: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    # 3d. the same requests with the map sharded across 8 channels: the
    # growth pre-committed at each boundary in one launch of 8 blocks
    t0 = time.perf_counter()
    serve_channels = channels_phase(get_arch("llama3.2-1b"),
                                    MODELS["llama3.2-1b"]["lens"],
                                    serve_macro, llama["tokens"])
    print(f"serve channels: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    # 3e. the swap phase's requests and pool under the fault plan; 3f.
    # the channel phase's configuration crashed and recovered
    t0 = time.perf_counter()
    serve_faults = faults_phase(get_arch("llama3.2-1b"),
                                MODELS["llama3.2-1b"]["lens"], serve_swap,
                                llama["tokens"])
    print(f"serve faults: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    serve_recover = recover_phase(get_arch("llama3.2-1b"),
                                  MODELS["llama3.2-1b"]["lens"],
                                  serve_channels, llama["tokens"])
    print(f"serve recover: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    for name in MODELS["llama3.2-1b"]["single"]:
        rows[name]["launches_serve_faults"] = \
            serve_faults["launches"].get(name, 0)
        rows[name]["launches_serve_recover"] = \
            serve_recover["launches"].get(name, 0)
        rows[name]["launches_single_step"] = serve["launches"][name]
        rows[name]["launches"] = serve_macro["launches"][name]
        rows[name]["launches_serve_swap"] = serve_swap["launches"][name]
        rows[name]["launches_serve_channels"] = \
            serve_channels["launches"].get(name, 0)

    # 4. the map phase: the fused path (fmmu_commit), its plain chain and
    # the unfused path (fmmu_lookup, whose launches are this path's). The
    # probe-only fmmu_translate runs on no path since fmmu_commit does
    # its probe: it is held and timed in the kernels phase alone.
    t0 = time.perf_counter()
    map_line = map_phase()
    for name in ("fmmu_commit", "fmmu_lookup"):
        if map_line["launches"].get(name, 0) <= 0:
            fail(f"{name} was not launched in the map phase")
    rows["fmmu_lookup"]["launches"] = map_line["launches"]["fmmu_lookup"]
    rows["fmmu_lookup"]["launches_path"] = "map phase"
    rows["fmmu_translate"].update(
        launches=serve_macro["launches"].get("fmmu_translate", 0),
        launches_single_step=serve["launches"].get("fmmu_translate", 0),
        launches_path="none: the probe runs inside fmmu_commit")
    print(f"map: {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    # 5. mamba2-1.3b serving, single-step then macro (mamba_chunk_scan at
    # prefill, fmmu_commit)
    mamba = model_phases("mamba2-1.3b")
    serve_ssm, serve_ssm_macro = mamba["serve"], mamba["serve_macro"]
    rows["mamba_chunk_scan"]["launches_single_step"] = \
        serve_ssm["launches"]["mamba_chunk_scan"]
    rows["mamba_chunk_scan"]["launches"] = \
        serve_ssm_macro["launches"]["mamba_chunk_scan"]

    # report -------------------------------------------------------------
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_path", "launches_single_step", "launches_serve_swap",
            "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"ptxas": ptxas_resources(logs),
                      "paged_attention_plan_at_serving_shape":
                      rows["paged_attention"]["plan"]}))
    print(smi)
    # comparisons some rows carry
    extra = ("plain_blocked_ms", "first_version_ms", "ms_masked",
             "plain_ms_masked", "ms_paper", "plain_ms_paper",
             "bound_ms_paper", "bound_by_paper") + tuple(
                 f"{k}_{d}" for d in ("swap_out", "swap_in")
                 for k in ("ms", "plain_ms", "bound_ms", "bound_by")) + \
        tuple(f"{k}_grid_c{c}" for c in (1,) + GRID_CHANNELS
              for k in ("ms", "plain_ms", "bound_ms", "bound_by")) + \
        tuple(f"{k}_serve_c{SERVE_CHANNELS}_{d}"
              for d in ("precommit", "swap_out", "swap_in")
              for k in ("ms", "plain_ms", "bound_ms", "bound_by")) + \
        tuple(f"{k}_{d}_c{c}" for d in ("retire", "restore")
              for c in (1, SERVE_CHANNELS)
              for k in ("ms", "plain_ms", "bound_ms", "bound_by")) + \
        ("launches_serve_channels", "launches_serve_faults",
         "launches_serve_recover")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + extra if k in r} for r in rows.values()]}))
    print(json.dumps({"serve": serve}))
    print(json.dumps({"serve_macro": serve_macro}))
    print(json.dumps({"serve_swap": serve_swap}))
    print(json.dumps({"serve_channels": serve_channels}))
    print(json.dumps({"serve_faults": serve_faults}))
    print(json.dumps({"serve_recover": serve_recover}))
    print(json.dumps({"map": map_line}))
    print(json.dumps({"serve_ssm": serve_ssm}))
    print(json.dumps({"serve_ssm_macro": serve_ssm_macro}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
