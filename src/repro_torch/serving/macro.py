"""K-step macro decode: port of ``ServeEngine._macro_fn`` in
``repro/serving/engine.py`` (the ``jax.jit(lax.scan(...))`` of K decode
steps) and its counterpart on the card, one CUDA graph per variant.

``macro_fn`` is the K-step program. Per step: page-boundary detection,
one device-side block pop per growing lane plus the fused map commit
(``fb.serving_grow_``, in place on the map state: one ``fmmu_commit``
launch on the card), the masked decode step, greedy sampling and, in
full mode, retirement with pause semantics (EOS, budget; forced prompt
steps never emit). It takes the reference's inputs and returns
``(state, toks [K,S], oob)``; the map state and the caches update in
place. It reads nothing back to the host, so it can be captured.

The reference commits growth under a ``lax.cond``, which has no
counterpart inside a CUDA graph. Here the commit runs on every step
under that step's grow mask; a commit with every lane masked leaves
every tensor of the map state bit-identical (``fb.serving_grow``), so
the program computes what the reference computes, at the price of one
commit launch on every step.

On a channel-stacked map state the same program is the port of
``ServeEngine._macro_sharded_fn``: the boundary has already
pre-committed every page the run can need
(``KVPageManager.precommit_growth``), so the steps skip the growth
commit and decode against a read-only table, the [C, L] shard stack
interleaved to global order once per run.

On a CPU tensor the engine runs the program eagerly. On the card it
replays ``MacroGraphs``: the program captured once per (simple | full,
forced | none, per-step page buckets), all graphs in one memory pool.
One replay is one dispatch per K tokens; its inputs go in as one
host->device copy and its tokens and ``oob`` flag come back as one
transfer (the one host sync per K tokens). A capture or replay failure raises: there is no
eager fallback on the card.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.core.fmmu import batch as fb
from repro_torch.core.fmmu.types import NIL

I = torch.int32

# one bump per CUDA graph captured (a new variant or page buckets);
# steady-state decode captures nothing
MACRO_CAPTURES = COUNTERS.cell("engine.macro_captures")


def macro_fn(eng, params, ms, caches, cur_tok, ctx_lens, n_pages, alive,
             budget, forced, pages: Tuple[int, ...], simple: bool = False):
    """K fused decode steps of engine ``eng``'s slot grid, each through
    ``ServeEngine.decode_fn`` (the single-step path's decode: scratch
    block, zeroed ctx), with a zeroed token on masked lanes.

    cur_tok, ctx_lens, alive, budget, n_pages [S]; ``pages`` (static)
    holds each step's live-page bucket, the width its tables are cut
    to: the bucket a single step would use there. Up to 256 splits
    (2048 pages at 8 slots of the llama serving shape) paged
    attention's result does not depend on that width (its split plan
    does not), so there the buckets only spare it the empty splits of a
    wider table; past that its splits lengthen in steps, and the same
    bucket as the single step keeps the tokens equal. ``simple`` (static):
    no lane can finish mid-scan (no EOS, every budget covers the
    tokens the run emits), so the live set is ``alive`` throughout and
    ``n_pages`` is the host's precomputed growth schedule
    (grow [K,S] bool, dl [K,S] int32). ``forced`` = (fmask, ftok, emit)
    [K,S] or None: where fmask, a step consumes ftok (a known prompt
    token of a chunk-prefilled request) instead of the carried sample,
    and only steps with emit spend budget or can retire.

    On a channel-stacked map state (the port of ``_macro_sharded_fn``)
    the boundary has pre-committed every page the run can need
    (``KVPageManager.precommit_growth``): the steps skip the growth
    commit, ``n_pages`` is unused, and the [C, L] shard stack is
    interleaved to global order once here. Pages mapped ahead of a
    lane's context are invisible to attention (it reads ctx_lens
    positions only), so a step equals a single step.

    Returns (state, toks [K,S] int32, oob: ``ms.oob``, [] or [C] bool).
    In full mode toks is NIL on lanes that emitted nothing; in simple
    mode dead-lane columns are garbage and the host masks them."""
    g = eng.kvm.geom
    page, max_pages = eng.page, eng.max_pages
    dev = cur_tok.device
    slots = torch.arange(eng.n_slots, dtype=I, device=dev)
    pre = fb.n_channels(ms) > 1             # growth pre-committed
    # a view of the one-channel table (its commits land in it); one
    # relayout of the sharded stack per run
    table = fb.interleave_table(ms.table, eng.n_slots * max_pages)
    # swap-pending slots are paused lanes for the whole run: the host
    # leaves them out of ``alive`` too, and every swap flips the lane in
    # place on this (static) state before the next run. The one-channel
    # program intersects with the lane, as the reference's does (the
    # boundary re-syncs it first); the sharded one reads ``alive`` only,
    # as ``_macro_sharded_fn`` does: nothing re-syncs a stacked state's
    # lane, so after a host-side free of a swapped-out slot (a
    # quarantine, a recovery) it stays set for the slot's next occupant
    if not pre:
        alive = alive & ~ms.swap_pending

    def decode(tok, ctx, live, k):
        return eng.decode_fn(params, caches, tok, ctx, table, live,
                             pages[k])

    toks: List[torch.Tensor] = []
    if simple:
        grow_sched, dl_sched = n_pages
        tok = torch.where(alive, cur_tok, 0)
        ctx = ctx_lens
        for k in range(eng.macro_k):
            if forced is not None:
                tok = torch.where(forced[0][k] & alive, forced[1][k], tok)
            # no lane can fail here (the host's worst-case eligibility
            # check covers the run); if one does, oob is raised
            if not pre:
                fb.serving_grow_(g, ms, grow_sched[k], dl_sched[k])
            nxt = decode(tok, ctx, alive, k)
            toks.append(nxt)
            tok = torch.where(alive, nxt, 0)
            ctx = ctx + alive.to(I)
        return ms, torch.stack(toks), ms.oob

    tok, ctx, npg, bud = cur_tok, ctx_lens, n_pages, budget
    for k in range(eng.macro_k):
        if forced is None:
            em = True
        else:
            fm, ft, em = (f[k] for f in forced)
            tok = torch.where(fm & alive, ft, tok)
        if pre:
            live = alive
        else:
            need = torch.div(ctx + page, page, rounding_mode="floor")
            grow = alive & (need > npg) & (npg < max_pages)
            _, ok = fb.serving_grow_(g, ms, grow, slots * max_pages + npg)
            # a lane that wanted a block and failed PAUSES (it must not
            # decode into the scratch block); oob sends the host to the
            # single-step path
            live = alive & ~(grow & ~ok)
            npg = npg + ok.to(I)
        nxt = decode(torch.where(live, tok, 0), ctx, live, k)
        # advance, then retire finished lanes with pause semantics:
        # frozen ctx, no growth, no tokens
        tok = torch.where(live, nxt, tok)
        ctx = ctx + live.to(I)
        emitted = live & em
        bud = bud - emitted.to(I)
        fin = emitted & ((nxt == eng.eos_id) | (bud <= 0))
        alive = alive & ~fin
        toks.append(torch.where(live, nxt, NIL).to(I))
    return ms, torch.stack(toks), ms.oob


# ------------------------------------------------------ packed inputs
_LANES = ("tokens", "ctx", "alive", "budget", "npages")
_STEPS = ("grow", "dl", "fmask", "ftok", "emit")


def pack_inputs(k: int, s: int, **arrays) -> np.ndarray:
    """The per-call inputs of one K-step run in one int32 vector (one
    host->device copy): the [S] lanes ``tokens, ctx, alive, budget,
    npages``, then the [K,S] schedules ``grow, dl, fmask, ftok, emit``
    (zeros where not given)."""
    buf = np.zeros(len(_LANES) * s + len(_STEPS) * k * s, np.int32)
    off = 0
    for name, n in [(n, s) for n in _LANES] + [(n, k * s) for n in _STEPS]:
        if name in arrays:
            buf[off:off + n] = np.asarray(arrays[name]).reshape(-1)
        off += n
    return buf


def unpack_inputs(buf: torch.Tensor, k: int, s: int, simple: bool,
                  forced: bool) -> Tuple:
    """``macro_fn``'s (cur_tok, ctx_lens, n_pages, alive, budget,
    forced) as views of a ``pack_inputs`` buffer on the device."""
    lanes = buf[:len(_LANES) * s].view(len(_LANES), s)
    steps = buf[len(_LANES) * s:].view(len(_STEPS), k, s)
    tok, ctx, alive, budget, npages = lanes
    grow, dl, fmask, ftok, emit = steps
    n_pages = (grow != 0, dl) if simple else npages
    fc = (fmask != 0, ftok, emit != 0) if forced else None
    return tok, ctx, n_pages, alive != 0, budget, fc


def _program(eng, ms, caches, buf: torch.Tensor, key):
    """The engine's K-step program (``macro_fn``) on a packed input
    buffer; key = (simple, forced, per-step page buckets). Returns
    (state, out int32): the [K*S] tokens, then at one channel the
    in-graph allocator's oob flag (a channel-sharded run pops nothing,
    so it packs the tokens alone)."""
    simple, forced, pages = key
    cur_tok, ctx, n_pages, alive, budget, fc = unpack_inputs(
        buf, eng.macro_k, eng.n_slots, simple, forced)
    ms, toks, oob = macro_fn(eng, eng.params, ms, caches, cur_tok, ctx,
                             n_pages, alive, budget, fc, pages,
                             simple=simple)
    if oob.dim():
        return ms, toks.reshape(-1)
    return ms, torch.cat([toks.reshape(-1), oob.to(I).reshape(1)])


def run_eager(eng, buf: np.ndarray, simple: bool, forced: bool,
              pages: Tuple[int, ...]):
    """One K-step run outside any graph (the CPU path): (state, out)."""
    return _program(eng, eng.kvm.state, eng.caches,
                    torch.from_numpy(buf).to(eng.device),
                    (simple, forced, pages))


# ------------------------------------------------------ the card's path
def uncounted(fn):
    """Run ``fn()`` and take the counter bumps it made back out (work
    that did not run: a capture, or a warm-up on scratch copies).
    Returns them, {cell: delta}."""
    base = COUNTERS.snapshot()
    fn()
    delta = {n: d for n, d in COUNTERS.delta(base).items() if d}
    for name, d in delta.items():
        COUNTERS.cell(name)[0] -= d
    return delta


def capture(fn, pool=None, stream=None):
    """Capture ``fn()`` into a new CUDA graph. The counters bump while
    it is captured, when no work runs: that delta is taken back out and
    returned for the caller to add on each replay. The graph is kept
    after instantiation, so its nodes (what a replay launches) stay
    readable through ``raw_cuda_graph()``. Returns (graph, delta)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)

    def record():
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            fn()
    delta = uncounted(record)
    graph.instantiate()
    return graph, delta


class MacroGraphs:
    """The K-step program of one engine as CUDA graphs, captured lazily
    per (simple, forced, per-step page buckets) into one shared memory
    pool. Runs whose buckets do not change inside them share one graph
    per bucket; a run that crosses a bucket boundary takes a graph of
    its own crossing step.

    Static addresses: every graph reads one packed input buffer and one
    static copy of the map state, and writes one output buffer; the
    caches and parameters are the engine's own tensors (the caches
    update in place), and so is an encoder-decoder's ``src_valid``
    mask, written in place at prefill between runs, never inside one.
    Before a replay the inputs are copied in, and so is every map-state
    tensor that an eager op replaced since the last replay (an
    allocator re-sync; eager map commits, a swap's among them, and its
    residency flip update the static tensors in place).
    So no key holds residency: a swap or a rotation captures nothing.
    The one-channel program commits the map in place on the static
    state too, so ``kvm.state`` keeps one storage across replays; its
    optional ``live`` / ``refcnt`` lanes are static tensors like the
    rest, kept by the captured commits, and a GC walk, a copy-on-write
    or a CTP prefetch between runs is one more eager commit on them. The
    channel-sharded program only reads the static table: its graphs hold
    no ``fmmu_commit`` node, and the boundary's pre-commit (one eager
    launch) writes the static state in place before the replay.

    Host-side effects are not replayed: the kernel wrappers' launch
    counts and the map's probe/insert counts bump while a graph is
    captured, when no work runs. Each graph's count delta is taken back
    out after its capture and added on every replay, so the counters
    stay the number of launches the device ran."""

    def __init__(self, eng):
        self.eng = eng
        self.dev = eng.device
        k, s = eng.macro_k, eng.n_slots
        n = len(pack_inputs(k, s))
        self.buf = torch.zeros(n, dtype=I, device=self.dev)
        # pinned staging for the one host->device copy a run makes (the
        # previous run's token read has finished with it)
        self.host_buf = torch.zeros(n, dtype=I, pin_memory=True)
        self.out = torch.zeros(k * s + 1, dtype=I, device=self.dev)
        self.ms = None                      # static map state
        self.graphs: Dict[tuple, torch.cuda.CUDAGraph] = {}
        self.deltas: Dict[tuple, Dict[str, int]] = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.dev)
        self.capture_s = 0.0
        self.pool_bytes = 0

    def run(self, ms, buf: np.ndarray, simple: bool, forced: bool,
            pages: Tuple[int, ...]):
        """Replay the variant's graph (capturing it first if new) on
        ``ms`` and the packed inputs. Returns (static state, out
        [K*S+1] int32 on the device: the tokens, then oob; the
        channel-sharded program writes only the tokens)."""
        self._bind(ms)
        self.host_buf.numpy()[:] = buf
        self.buf.copy_(self.host_buf, non_blocking=True)
        key = (simple, forced, pages)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self._capture(key)
        graph.replay()
        for name, d in self.deltas[key].items():
            COUNTERS.cell(name)[0] += d
        return self.ms, self.out

    def _bind(self, ms):
        if self.ms is None:
            self.ms = fb.clone_state(ms)
            return
        for static, live in zip(fb.state_tensors(self.ms),
                                fb.state_tensors(ms)):
            if live is not static:
                static.copy_(live)

    def _warm_up(self, key):
        """One eager run of the variant on the capture stream, on
        scratch copies of the map state, caches and inputs, before its
        capture: it loads every kernel the graph launches, sizes paged
        attention's ticket buffer for these page buckets' split plans and
        gives cuBLAS its workspace on that stream, none of which may
        happen inside a capture. The live caches, map state and
        allocator are not touched, and nothing is counted."""
        def run():
            with torch.cuda.stream(self.stream):
                ms = fb.clone_state(self.ms)
                caches = {n: torch.zeros_like(c)
                          for n, c in self.eng.caches.items()}
                _program(self.eng, ms, caches, self.buf.clone(), key)
            torch.cuda.synchronize(self.dev)
        self.stream.wait_stream(torch.cuda.current_stream(self.dev))
        uncounted(run)
        torch.cuda.empty_cache()

    def _capture(self, key) -> torch.cuda.CUDAGraph:
        # destroying a CUDA graph during a capture invalidates it: free
        # unreachable engines' graphs (a cycle through MacroGraphs.eng)
        # now, not when the collector happens to run mid-capture
        gc.collect()
        self._warm_up(key)
        torch.cuda.synchronize(self.dev)
        reserved = torch.cuda.memory_reserved(self.dev)
        t0 = time.perf_counter()

        def program():
            ms, out = _program(self.eng, self.ms, self.eng.caches,
                               self.buf, key)
            # the one-channel program commits the map in place on the
            # static state; the sharded one only reads its table
            if any(t is not static for static, t in zip(
                    fb.state_tensors(self.ms), fb.state_tensors(ms))):
                raise RuntimeError("the K-step program must leave the map "
                                   "on the static state")
            self.out[:out.numel()].copy_(out)
        graph, self.deltas[key] = capture(program, self.pool, self.stream)
        torch.cuda.synchronize(self.dev)
        self.capture_s += time.perf_counter() - t0
        self.pool_bytes += torch.cuda.memory_reserved(self.dev) - reserved
        self.graphs[key] = graph
        MACRO_CAPTURES[0] += 1
        return graph

    def stats(self) -> dict:
        """Graphs captured, capture seconds and the bytes the captures
        added to the device's reserved memory (the graph pool)."""
        return {"graphs": len(self.graphs), "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes}


__all__ = ["macro_fn", "pack_inputs", "unpack_inputs", "run_eager",
           "uncounted", "capture", "MacroGraphs", "MACRO_CAPTURES"]
