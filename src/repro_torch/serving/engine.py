"""Serving engine: continuous batching over a fixed slot grid, with the
FMMU page manager owning logical->physical KV translation. Port of the
single-step and K-step macro paths of ``repro/serving/engine.py``, its
host tier with the non-blocking swap pipeline and its channel-sharded
map, for dense and pure-SSM models.

Prefill (the flash-attention kernel, or the mamba_chunk_scan kernel
for an SSM layer) writes each request's KV into the pool blocks named
by the FMMU block table and its conv/SSM states into its slot; decode
steps run the whole slot batch through ``Model.decode_step`` (the
paged-attention kernel, or the one-token SSD recurrence) against the
device-resident incremental block table. An attention-free model still
grows its pages through the map, as in the reference. Page growth for
every slot crossing a page boundary is one allocation + ONE fused map
commit (the fmmu_translate kernel), and dead-lane masking happens on
the device, so the only per-step host sync is the next-token readback
(``HOST_SYNCS``).

With ``macro_k >= 2`` a scheduling round runs K decode steps in one
dispatch (``serving/macro.py``; on the card one CUDA graph replay):
page-boundary detection, device-side block pops from the map state's
free stack, the fused map commit, attention, greedy sampling and
retirement all happen on the device, and the host makes one sync per K
tokens. The host pool stays authoritative at the boundaries between
macro steps: admission, frees and the replay of the device's pops
(``KVPageManager.reconcile_macro``) happen there. A round falls back to
one single step (counted in ``macro_fallbacks``) when the free pool
cannot cover the decoding lanes' worst-case K-step growth.

Host tier (``n_host_blocks > 0``): pool rows ``[n_dev, n_dev + n_host)``
hold swapped-out pages, and the scratch block moves to row
``n_dev + n_host``. Each swap is one CondUpdate-guarded map commit plus
in-place row moves (``KVPageManager.swap_out`` / ``swap_in``). Under
``nonblocking_swap`` (with ``macro_k >= 2``) a boundary scheduler
(``_swap_schedule``) runs before every round: it swaps victims out
until the residents' worst-case K-step growth fits the device pool,
resumes waiting slots FIFO while they fit, and lets a slot pending for
``swap_patience`` boundaries evict the longest-resident ones. A
swapped-out slot is a masked lane of the K-step run while the others
decode; these swaps read nothing back. Admission and single-step growth
that run out of blocks preempt a victim to the host tier (a swap with
its guard read back), and a single step first swaps its slots back in
(``_ensure_resident``).

Channels (``channels=C > 1``): the page manager shards the map across
C channels by the static hash dlpn mod C (``KVPageManager``). A K-step
run's worst-case growth is pre-committed at the boundary
(``KVPageManager.precommit_growth``: one channel-aware pool allocation
in the run's pop order and one map commit, one ``fmmu_commit`` launch
of C blocks on the card), and the run decodes against that table
(``macro.macro_fn`` on the stacked state: no allocator and no commit
inside it; the [C, L] shard stack interleaves to global order once per
run). The
reserve and eligibility checks compare per channel. A lane that
retires mid-run keeps its pre-committed pages until its slot frees, so
the pool order can differ from single steps' (the reference's
documented divergence); the tokens never do.

Fault plane (``fault_plane``, ``core/faults.py``): a swap that fails
(``SwapFault``, before any change) backs its slot off for min(2^fails,
``swap_backoff_cap``) rounds and quarantines it after
``max_swap_retries`` failures in a row: its pages are freed and its
request goes back to the front of the queue with its output reset
(greedy decode restarts to the same tokens). A watchdog quarantines any
lane that neither decodes nor moves for ``watchdog_rounds`` rounds. A
transient allocation fault pauses growth for a round instead of
tripping the livelock guard. A failed block program is retired: at
admission, growth and a pre-commit by the page manager (map only), and
after a one-channel K-step run by ``_retire_macro_programs``, which
also moves the rows the run already wrote. A browned-out channel
(``stall``) advertises 1/stall of its free blocks to the boundary
planners (``_free_eff``).

Journal (``journal_path``, ``core/journal.py``): every host commit
point appends a record (the page manager's, and SUBMIT / ADMIT / FINISH
/ QUAR here), every ``snapshot_every``-th round writes a snapshot, and
``recover`` rebuilds the engine from disk after a power cut (``Crash``)
and requeues what was in flight. ``reset`` and ``recover`` keep the
engine's tensors (caches zeroed in place) and its CUDA graphs.

Not ported yet (later slices; ``ServeConfig`` rejects them): the
channel mesh, GC and the CTP prefetch, prefix sharing. Without a host
tier there is no preemption victim, so a slot whose page growth fails PAUSES
until blocks free up, as in the reference. As in the reference, every
slot runs through each decode step (token 0 on a paused or dead lane):
its KV write is masked to the scratch block, but a mamba layer's state
of a paused slot advances all the same (ROADMAP, reference
divergences); so a model with mamba layers does not swap.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import journal as jl
from repro_torch.core.counters import COUNTERS
from repro_torch.core.faults import FaultPlane, SwapFault
from repro_torch.core.fmmu import batch as fb
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.paging.kv_manager import KVPageManager
from repro_torch.paging.pool import OutOfBlocks
from repro_torch.serving import macro
from repro_torch.serving.config import ServeConfig

# one bump per blocking device->host readback (prefill's first token,
# each decode step's next tokens, each macro step's tokens + oob flag)
# and one per K-step macro dispatch (a graph replay on the card)
HOST_SYNCS = COUNTERS.cell("engine.host_syncs")
MACRO_DISPATCHES = COUNTERS.cell("engine.macro_dispatches")


@dataclasses.dataclass
class Request:
    rid: int
    tokens: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    # chunked admission: prompt tokens not yet fed to the model — they
    # stream through the decode path as forced lanes
    pending_prompt: List[int] = dataclasses.field(default_factory=list)
    # host clock (perf_counter) at submit, first token and completion
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class ServeEngine:
    def __init__(self, model: Model, params, *, config: ServeConfig,
                 device: Union[str, torch.device] = "cuda",
                 fault_plane: Optional[FaultPlane] = None):
        if fault_plane is not None and not isinstance(fault_plane,
                                                      FaultPlane):
            raise TypeError(f"fault_plane: a FaultPlane, not "
                            f"{type(fault_plane).__name__}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.config = config
        self.m = model
        self.cfg = model.cfg
        self.rt = model.rt
        self.params = params
        self.n_slots = config.n_slots
        self.page = self.rt.page_size
        self.max_pages = -(-config.max_ctx // self.page)
        n_dev = config.n_device_blocks or (self.n_slots * self.max_pages)
        n_host = config.n_host_blocks
        self.channels = config.channels
        self.kvm = KVPageManager(self.n_slots, self.max_pages, n_dev,
                                 n_host, channels=self.channels,
                                 faults=fault_plane, device=self.device)
        # +1 scratch block past both tiers: unmapped table entries (dead
        # and swap-pending lanes) write their garbage KV there instead of
        # corrupting block 0
        self.scratch_block = n_dev + n_host
        # prefix sharing only applies to pure paged-attention state: a
        # mamba layer's recurrent state is per-slot and
        # position-dependent, so a skipped prefill cannot be rebuilt
        # from shared KV pages (ServeConfig rejects sharing for now)
        self._share_model_ok = not any(
            self.cfg.layer_kind(j) == "mamba"
            for j in range(self.cfg.period))
        self.caches = transformer.init_decode_caches(
            self.cfg, self.rt, self.n_slots, self.scratch_block + 1,
            self.rt.compute_dtype, device=self.device)
        self.ctx_lens = np.zeros(self.n_slots, np.int32)
        self.active: Dict[int, Request] = {}
        self.eos_id = config.eos_id
        self.admit_tokens = config.admit_tokens
        self.queue: Deque[Request] = deque()
        self._rid = 0
        self.min_page_bucket = 4
        self.macro_k = config.macro_k
        self._macro_on = self.macro_k >= 2
        self._graphs = (macro.MacroGraphs(self) if self._macro_on
                        and self.device.type == "cuda" else None)
        self.nonblocking_swap = config.nonblocking_swap
        self.swap_patience = config.swap_patience
        # the scheduling-round clock, and per slot the round it was
        # swapped out / last became resident (the scheduler's FIFO and
        # aging order)
        self._boundary = 0
        self._pending_since: Dict[int, int] = {}
        self._resident_since: Dict[int, int] = {}
        # the fault policy: per slot, consecutive swap failures, the
        # round its backoff ends and its last progress stamp
        # (len(out), len(pending_prompt), round)
        self.faults = fault_plane
        self.max_swap_retries = config.faults.max_swap_retries
        self.swap_backoff_cap = config.faults.swap_backoff_cap
        watchdog = config.faults.watchdog_rounds
        if watchdog is None:
            watchdog = (8 * max(1, self.swap_patience)
                        if fault_plane is not None else 0)
        self.watchdog_rounds = int(watchdog)
        self._swap_fails: Dict[int, int] = {}
        self._retry_at: Dict[int, int] = {}
        self._progress: Dict[int, tuple] = {}
        self.metrics = {"prefills": 0, "prefill_tokens": 0,
                        "decode_steps": 0, "preemptions": 0,
                        "generated": 0, "chunked_prefills": 0,
                        "macro_steps": 0, "macro_fallbacks": 0,
                        "swaps_out": 0, "swaps_in": 0, "swap_faults": 0,
                        "quarantines": 0, "watchdog_quarantines": 0,
                        "requeues": 0, "recoveries": 0}
        # the crash-consistency journal: durably finished outputs, the
        # rids ever admitted, and the device's committed lanes at attach
        self.journal: Optional[jl.Journal] = None
        self.snapshot_every = config.durability.snapshot_every
        self._finished: Dict[int, List[int]] = {}
        self._ever_admitted: set = set()
        self._lane_base = 0
        self.last_recovery: Optional[dict] = None
        if config.durability.journal_path:
            self.attach_journal(config.durability.journal_path)

    # ------------------------------------------------------------- API
    def submit(self, tokens: List[int], max_new: int = 16) -> int:
        rid = self._rid
        self._rid += 1
        self.queue.append(Request(rid, list(tokens), max_new,
                                  t_submit=time.perf_counter()))
        if self.journal is not None:
            self.journal.append(jl.SUBMIT,
                                {"rid": rid,
                                 "tokens": [int(t) for t in tokens],
                                 "max_new": int(max_new), "lanes": 0})
        return rid

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        done: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            if not self.step(done):
                break
        return done

    def reset(self, fault_plane: Optional[FaultPlane] = None):
        """Fresh serving state with ``fault_plane`` installed, on the
        same tensors: the caches are zeroed in place (the CUDA graphs
        hold their addresses, and their static map state takes the
        fresh map at the next replay), and the page manager resets.
        Detaches and closes the journal."""
        self.kvm.reset(faults=fault_plane)
        self.faults = fault_plane
        for c in self.caches.values():
            c.zero_()
        self.ctx_lens[:] = 0
        self.active = {}
        self.queue = deque()
        self._rid = 0
        self._boundary = 0
        for d in (self._pending_since, self._resident_since,
                  self._swap_fails, self._retry_at, self._progress,
                  self._finished):
            d.clear()
        self._ever_admitted = set()
        if self.journal is not None:
            self.journal.close()
        self.journal = None
        for k in self.metrics:
            self.metrics[k] = 0

    # ----------------------------------------------------- crash consistency
    def attach_journal(self, path: str,
                       snapshot_every: Optional[int] = None,
                       resume: bool = False) -> jl.Journal:
        """Arm journaling at ``path``: every host commit point appends a
        record, every ``snapshot_every``-th round writes a snapshot, and
        the fault plane's crash axis is consumed per append. Writes the
        base snapshot now, so recovery always has one."""
        if snapshot_every is not None:
            self.snapshot_every = int(snapshot_every)
        self.journal = jl.Journal(path, faults=self.faults, resume=resume)
        self.kvm.journal = self.journal
        # the device's committed lanes and the journal's advance in
        # lockstep from here (journal_lane_check)
        self._lane_base = self._device_lanes()
        self.journal.lanes_base = self.journal.commit_lanes
        self._write_snapshot()
        return self.journal

    def _journal_finish(self, r: Request):
        """FINISH precedes the slot's FREE: a crash between the two
        leaves an orphan mapping that replay frees."""
        if self.journal is None:
            return
        out = [int(t) for t in r.out[:r.max_new]]
        self._finished[r.rid] = out
        self.journal.append(jl.FINISH,
                            {"rid": r.rid, "out": out, "lanes": 0})

    def journal_lane_check(self) -> bool:
        """At a quiet boundary (after ``step`` returns): the device's
        committed lanes and the journal's have advanced alike since
        attach. A device read: diagnostics and tests only."""
        if self.journal is None:
            return True
        return (self._device_lanes() - self._lane_base
                == self.journal.commit_lanes - self.journal.lanes_base)

    def _write_snapshot(self) -> str:
        """One snapshot: the page manager's host truth plus the
        engine's request and admission state (host data only: in-flight
        requests restart on recovery)."""
        st = self.kvm.snapshot_state()
        st["queue"] = [r.rid for r in self.queue]
        st["ever_admitted"] = sorted(self._ever_admitted)
        st["active"] = [[r.rid, r.slot] for r in self.active.values()]
        st["done"] = {int(r): o for r, o in self._finished.items()}
        st["submits"] = {
            r.rid: [[int(t) for t in r.tokens], int(r.max_new)]
            for r in list(self.queue) + list(self.active.values())}
        st["rid"] = self._rid
        st["boundary"] = self._boundary
        return self.journal.snapshot(st)

    def recover(self, path: str, fault_plane: Optional[FaultPlane] = None,
                snapshot_every: Optional[int] = None
                ) -> Dict[int, List[int]]:
        """Sudden-power-off recovery: rebuild this engine from the
        journal at ``path`` (snapshot + record replay + the OOB scan of a
        torn tail, ``core.journal.replay``), restore the map in one
        batched commit, restart every in-flight request from its prompt
        (pages freed, output reset) and re-arm the journal with a fresh
        snapshot. The queue becomes: the requests quarantined before the
        crash (they were already at the front), then the in-flight ones
        in admission order, then the never-admitted ones in arrival
        order. Returns the durably finished outputs {rid: tokens};
        ``last_recovery`` holds the replay's diagnostics and the wall
        time (MTTR)."""
        t0 = time.perf_counter()
        rec = jl.replay(path)
        n_recov = self.metrics["recoveries"]
        self.reset(fault_plane)
        self.kvm.restore_mapping(rec)
        # the KV was volatile: free what survives (journal detached, so
        # the fresh snapshot below carries these frees)
        requeued: List[Request] = []
        now = time.perf_counter()
        for rid, slot in rec.active.items():
            if slot in self.kvm.seq_pages:
                self.kvm.free_seq(slot)
            toks, mx = rec.submits[rid]
            requeued.append(Request(rid, list(toks), int(mx), t_submit=now))
        qreqs = [Request(rid, list(rec.submits[rid][0]),
                         int(rec.submits[rid][1]), t_submit=now)
                 for rid in rec.queue]
        k = 0
        while k < len(qreqs) and qreqs[k].rid in rec.ever_admitted:
            k += 1
        self.queue = deque(qreqs[:k] + requeued + qreqs[k:])
        self._rid = int(rec.rid)
        self._boundary = int(rec.boundary)
        self._finished = {int(r): list(o) for r, o in rec.done.items()}
        self._ever_admitted = set(rec.ever_admitted) | set(rec.active)
        self.metrics["requeues"] += len(requeued)
        self.metrics["recoveries"] = n_recov + 1
        self.attach_journal(path, snapshot_every=snapshot_every,
                            resume=True)
        self.last_recovery = {
            "snap_seq": int(rec.snap_seq), "last_seq": int(rec.last_seq),
            "replayed": int(rec.replayed), "torn": bool(rec.torn),
            "oob_scan": bool(rec.oob_scan), "requeued": len(requeued),
            "recover_s": time.perf_counter() - t0}
        return {int(r): list(o) for r, o in rec.done.items()}

    # ------------------------------------------------------------- steps
    def step(self, done: Dict[int, List[int]]) -> bool:
        """One scheduling round: admissions, the watchdog, the boundary
        swap plan, then either one K-step macro step (swap-pending slots
        masked) or one single decode step; every ``snapshot_every``-th
        round ends with a journal snapshot."""
        self._admit()
        if not self.active:
            return bool(self.queue)
        self._boundary += 1      # fallback rounds age the pending too
        if self.watchdog_rounds:
            self._watchdog()
            if not self.active:
                return bool(self.queue)
        if self._macro_on and self.nonblocking_swap:
            self._swap_schedule()
        if self._macro_eligible():
            self._macro_decode_step(done)
        else:
            if self._macro_on:
                self.metrics["macro_fallbacks"] += 1
            self._decode_step(done)
        if self.journal is not None and self.snapshot_every \
                and self._boundary % self.snapshot_every == 0:
            self._write_snapshot()
        return bool(self.active or self.queue)

    def _free_slots(self) -> List[int]:
        used = {r.slot for r in self.active.values()}
        return [s for s in range(self.n_slots) if s not in used]

    def _admit(self):
        """Admit + prefill queued requests under a per-round token
        budget (``admit_tokens``). A prompt longer than the remaining
        budget is CHUNK-prefilled: its first chunk goes through prefill
        now and the rest streams through decode as forced lanes."""
        if not self.queue:
            return
        budget = self.admit_tokens
        free = self._free_slots()
        while self.queue and free:
            req = self.queue[0]
            slot = free[0]
            chunk = len(req.tokens)
            if budget is not None:
                if budget <= 0:
                    return                  # token budget spent this round
                chunk = min(chunk, budget)
            # on-demand allocation: admission maps only the pages that
            # prefill writes; decode grows the mapping page by page
            n_pages = max(1, min(-(-chunk // self.page), self.max_pages))
            try:
                self.kvm.new_seq(slot, n_pages)
            except OutOfBlocks:
                if not self._preempt(exclude=slot):
                    return
                continue
            self.queue.popleft()
            free.pop(0)
            req.slot = slot
            self.active[req.rid] = req
            self._ever_admitted.add(req.rid)
            self._resident_since[slot] = self._boundary
            if self.journal is not None:
                self.journal.append(
                    jl.ADMIT, {"rid": req.rid, "slot": int(slot),
                               "lanes": 0})
            self._do_prefill(req, chunk)
            if budget is not None:
                budget -= chunk

    def _preempt(self, exclude: int) -> bool:
        """Swap the longest active sequence that still holds device
        pages out to the host tier, reading its guard back. False when
        there is no host tier, no such victim, or the host tier cannot
        take its blocks: the caller pauses or stops instead."""
        if self.kvm.pool.n_host == 0:
            return False
        victims = [r for r in self.active.values() if r.slot != exclude]
        for victim in sorted(victims, key=lambda r: self.ctx_lens[r.slot],
                             reverse=True):
            if self._swap_out_slot(victim.slot, check=True):
                self.metrics["preemptions"] += 1
                return True
            if victim.rid not in self.active:
                # its failed swap quarantined it: its pages are free now,
                # which is all the caller needed
                return True
        return False

    def _ensure_resident(self):
        """Swap in the host-tier pages of active sequences before a
        single decode step, fewest pages first. A sequence that cannot
        come back yet stays swapped out and PAUSES until device blocks
        free up."""
        if self.kvm.pool.n_host == 0:
            return
        for r in sorted(self.active.values(),
                        key=lambda r: len(self.kvm.seq_pages.get(r.slot,
                                                                 []))):
            if not self.kvm.is_resident(r.slot) \
                    and not self._backed_off(r.slot):
                self._swap_in_slot(r.slot, check=True)

    # --------------------------------------------- boundary swap planner
    def _pools(self) -> List[torch.Tensor]:
        """The KV pool tensors a swap moves rows of (block axis 2)."""
        if "conv" in self.caches or "pool_k" not in self.caches:
            raise NotImplementedError(
                "swapping a slot of a model with mamba layers: a swap "
                "moves its KV pages, not its conv/SSM state, which the "
                "decode steps advance while the slot is paused (ROADMAP, "
                "reference divergences); the reference cannot swap an "
                "attention-free model either")
        return [self.caches["pool_k"], self.caches["pool_v"]]

    def _swap_out_slot(self, slot: int, check: bool = False) -> bool:
        """Move one slot's device pages to the host tier, in place: the
        one home of the engine's swap-out, shared by the boundary
        scheduler (``check=False``: nothing read back) and preemption
        (``check=True``). The slot is a swap-pending lane, masked in
        the K-step runs, until it is swapped back in. False when
        nothing moved (no device page, or the host tier is full)."""
        if self.kvm.n_device_pages(slot) == 0:
            return False
        try:
            moved = self.kvm.swap_out(slot, self._pools(), block_axis=2,
                                      check=check)
        except SwapFault:
            self._note_swap_fault(slot)   # backoff, maybe quarantine
            return False
        except OutOfBlocks:
            return False               # host tier full: nothing moved
        if not moved:
            return False
        self._clear_fault_stamps(slot)
        self.metrics["swaps_out"] += 1
        self._pending_since[slot] = self._boundary
        return True

    def _swap_in_slot(self, slot: int, check: bool = False) -> bool:
        """Swap-out's dual (the same single home and check modes)."""
        try:
            moved = self.kvm.swap_in(slot, self._pools(), block_axis=2,
                                     check=check)
        except SwapFault:
            self._note_swap_fault(slot)
            return False
        except OutOfBlocks:
            return False
        if not moved:
            return False
        self._clear_fault_stamps(slot)
        self.metrics["swaps_in"] += 1
        self._resident_since[slot] = self._boundary
        self._pending_since.pop(slot, None)
        return True

    def _growth_need(self, slot: int) -> int:
        """Total worst-case device blocks ``slot`` can pop during one
        K-step run (the sum of ``_growth_need_ch``)."""
        return int(self._growth_need_ch(slot).sum())

    # ------------------------------------------------------ fault recovery
    def _clear_fault_stamps(self, slot: int):
        """A completed tier move: the slot's failure count, backoff and
        watchdog stamp start over."""
        for d in (self._swap_fails, self._retry_at, self._progress):
            d.pop(slot, None)

    def _note_swap_fault(self, slot: int):
        """A swap failed with the state untouched: back the slot off for
        min(2^fails, swap_backoff_cap) rounds, and quarantine it once
        ``max_swap_retries`` attempts in a row have failed."""
        self.metrics["swap_faults"] += 1
        n = self._swap_fails.get(slot, 0) + 1
        self._swap_fails[slot] = n
        if n >= self.max_swap_retries:
            self._quarantine(slot, "swap retries exhausted")
        else:
            self._retry_at[slot] = self._boundary + min(
                1 << n, self.swap_backoff_cap)

    def _backed_off(self, slot: int) -> bool:
        """True while ``slot``'s backoff is open: the scheduler neither
        retries its swap nor picks it as a victim."""
        return self._retry_at.get(slot, 0) > self._boundary

    def _quarantine(self, slot: int, reason: str):
        """Take a failing slot out of service: free its pages (both
        tiers), requeue its request at the front of the queue with its
        output reset, and clear every per-slot stamp. Its reserved
        growth is free the moment this returns."""
        req = next((r for r in self.active.values() if r.slot == slot),
                   None)
        if req is None:
            return
        self.kvm.free_seq(slot)
        del self.active[req.rid]
        self._release_slot(slot)
        req.slot = -1
        req.out = []
        req.pending_prompt = []
        req.t_first = 0.0
        self.queue.appendleft(req)
        if self.journal is not None:
            self.journal.append(jl.QUAR, {"rid": req.rid, "lanes": 0})
        self.metrics["quarantines"] += 1
        self.metrics["requeues"] += 1
        if "watchdog" in reason:
            self.metrics["watchdog_quarantines"] += 1

    def _watchdog(self):
        """Quarantine any lane with no progress for ``watchdog_rounds``
        rounds. Progress is a token (generated, or a prompt token
        consumed) or a completed tier move (the swaps clear the stamp):
        a lane rotating through the host tier is waiting, not wedged."""
        for r in list(self.active.values()):
            s = r.slot
            cur = (len(r.out), len(r.pending_prompt))
            last = self._progress.get(s)
            if last is None or (last[0], last[1]) != cur:
                self._progress[s] = (cur[0], cur[1], self._boundary)
            elif self._boundary - last[2] >= self.watchdog_rounds:
                self._quarantine(s, "watchdog: no token progress")

    def _stall_shrink(self, free: np.ndarray) -> np.ndarray:
        """A free-block vector with the plane's per-channel stall
        multipliers applied (a browned-out channel advertises 1/stall of
        its blocks). Identity without a plane."""
        if self.faults is not None:
            st = self.faults.stall_vec(self.channels)
            if (st > 1.0).any():
                free = (free / np.maximum(st, 1.0)).astype(np.int64)
        return free

    def _free_eff(self) -> np.ndarray:
        """Per-channel free device blocks as the boundary planners
        (``_macro_eligible``, ``_swap_schedule``) see them: shrunk by the
        brownout, so residency and growth shrink on a stalled channel
        while the others keep their budget. The single-step path
        allocates against the real pool, so a brownout slows the engine
        but cannot livelock it."""
        return self._stall_shrink(self.kvm.free_device_vec())

    def _swap_schedule(self):
        """Boundary swap planner, run between K-step runs so that
        swap-pending slots are masked lanes instead of a fallback to
        single steps. Three passes:

          1. reserve: swap out victims (longest context first) until
             the residents' worst-case K-step growth fits the free
             device pool;
          2. resume: swap waiting slots back in, FIFO by the round they
             left, while they fit beside the reserve;
          3. aging: a slot pending for ``swap_patience`` rounds or more
             evicts the longest-resident slots until it fits, so no
             slot starves under sustained oversubscription.

        Every move is a swap with ``check=False``: the host dispatches
        it and goes on; nothing waits until the next token read."""
        kvm = self.kvm
        if kvm.pool.n_host == 0 or not self.active:
            return
        slots = {r.slot for r in self.active.values()}
        residents = [s for s in slots if kvm.is_resident(s)]
        pending = sorted((s for s in slots if not kvm.is_resident(s)),
                         key=lambda s: self._pending_since.get(s, 0))
        moved_now: set = set()

        # per-channel vectors: a reserve that fits in aggregate can
        # still run one channel dry
        def growth_total(slots):
            return sum((self._growth_need_ch(s) for s in slots),
                       np.zeros(self.channels, np.int64))

        def live():     # a quarantine mid-pass shrinks the active set
            return {r.slot for r in self.active.values()}

        def can_resume(s):
            # the swap-in takes the lane's host pages in real free
            # blocks; only the growth reserve is judged by the
            # stall-shrunk budget, so a brownout shrinks residency and
            # growth but does not wall off re-admission
            hp, fr = kvm.host_pages_vec(s), kvm.free_device_vec()
            if (hp > fr).any():
                return False
            return bool((self._stall_shrink(fr - hp)
                         >= total + self._growth_need_ch(s)).all())

        # 1. reserve: the K-step run must never run a channel dry.
        # Backed-off slots are no victims; a failed swap-out that
        # quarantined its victim freed the pages, which serves as well
        total = growth_total(residents)
        while (total > self._free_eff()).any() and len(residents) > 1:
            cands = [s for s in residents if not self._backed_off(s)]
            if not cands:
                break
            victim = max(cands, key=lambda s: int(self.ctx_lens[s]))
            if not self._swap_out_slot(victim):
                if victim not in live():
                    residents.remove(victim)
                    total = growth_total(residents)
                    continue
                if self._backed_off(victim):
                    continue    # a SwapFault: excluded next iteration
                break           # host tier full: nothing can move
            moved_now.add(victim)
            residents.remove(victim)
            pending.append(victim)
            total = growth_total(residents)
        # 2. resume FIFO while the reserve still holds
        for s in list(pending):
            if s in moved_now or self._backed_off(s):
                continue               # no ping-pong within one boundary
            if can_resume(s):
                if self._swap_in_slot(s):
                    moved_now.add(s)
                    pending.remove(s)
                    residents.append(s)
                    total += self._growth_need_ch(s)
                elif s not in live():
                    pending.remove(s)  # its failed swap-in quarantined it
        # 3. aging rotation: the oldest pending slot forces its way in
        rest = [s for s in pending
                if s not in moved_now and not self._backed_off(s)
                and s in live()]
        if not rest:
            return
        oldest = rest[0]
        waited = self._boundary - self._pending_since.get(oldest,
                                                          self._boundary)
        if waited < self.swap_patience:
            return
        while not can_resume(oldest) and len(residents) > 1:
            cands = [s for s in residents if s not in moved_now
                     and not self._backed_off(s)]
            if not cands:
                break
            victim = min(cands, key=lambda s: self._resident_since.get(s, 0))
            if not self._swap_out_slot(victim):
                if victim not in live():
                    residents.remove(victim)
                    total = growth_total(residents)
                    continue
                break
            residents.remove(victim)
            total = growth_total(residents)
        if can_resume(oldest):
            self._swap_in_slot(oldest)

    # ------------------------------------------------------------- prefill
    def _do_prefill(self, req: Request, n_chunk: Optional[int] = None):
        """Prefill the first ``n_chunk`` prompt tokens (default: all)."""
        n_chunk = len(req.tokens) if n_chunk is None else n_chunk
        self.metrics["prefill_tokens"] += n_chunk
        toks = torch.tensor(req.tokens[:n_chunk], dtype=torch.long,
                            device=self.device)[None]
        row = self.kvm.block_tables()[req.slot]   # device slice, no sync
        logits, cols = self.m.prefill(self.params, toks)
        _scatter_prefill(self.cfg, self.rt, self.caches, cols, row,
                         req.slot, self.scratch_block)
        self.ctx_lens[req.slot] = n_chunk
        if n_chunk < len(req.tokens):
            req.pending_prompt = list(req.tokens[n_chunk:])
            self.metrics["chunked_prefills"] += 1
        else:
            HOST_SYNCS[0] += 1
            req.out.append(int(torch.argmax(logits[0])))
            req.t_first = time.perf_counter()
            self.metrics["generated"] += 1
        self.metrics["prefills"] += 1

    # ------------------------------------------------------------- decode
    def _page_bucket(self, n_need: int) -> int:
        """Smallest power-of-2 page count >= n_need (>= min_page_bucket,
        <= max_pages): the live-page width attention runs over."""
        p = self.min_page_bucket
        while p < n_need and p < self.max_pages:
            p *= 2
        return min(p, self.max_pages)

    def _table_grid(self, table, pages):
        """Flat (or [C, L] channel-sharded) incremental table ->
        [n_slots, <=pages] global grid, through ``fb.interleave_table``
        (the one home of the shard-interleave layout)."""
        n = self.n_slots * self.max_pages    # table is geometry-padded
        grid = fb.interleave_table(table, n).reshape(self.n_slots,
                                                     self.max_pages)
        return grid[:, :pages or self.max_pages]

    def _mask_tables(self, grid, live):
        """Mask dead and swap-pending lanes to the scratch block (their
        garbage KV write lands there) and clamp out-of-range entries
        (NIL, host-tier tags >= HOST_BASE, any id at or past the scratch
        row) to it — what keeps every id the paged-attention kernel
        reads inside the pool: on the card a stray id is an illegal
        address, not an exception."""
        t = torch.where(live[:, None], grid, self.scratch_block)
        return torch.where((t < 0) | (t >= self.scratch_block),
                           self.scratch_block, t)

    def decode_fn(self, params, caches, tokens, ctx_lens, table, live,
                  pages):
        """One decode step on the device, shared by the single-step path
        and the K-step program: the flat table is reshaped and sliced to
        the live-page bucket, dead slots are masked to the scratch block
        with zeroed ctx, ``caches`` update in place, and greedy tokens
        come out."""
        tables = self._mask_tables(self._table_grid(table, pages), live)
        logits, _ = self.m.decode_step(
            params, tokens, caches, ctx_lens=torch.where(live, ctx_lens, 0),
            block_table=tables)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _grow_pages(self, residents) -> List[Request]:
        """Allocate pages for every resident crossing a page boundary:
        one batched allocation + one fused map call on the fast path.
        Returns the residents that may decode this step: preemption on
        the OutOfBlocks slow path may swap some out, and a slot whose
        growth fails outright PAUSES (decoding it with the new page
        unmapped would write its KV into the scratch block) and retries
        every step until blocks free up."""
        wants: Dict[int, int] = {}
        for r in residents:
            need = -(-int(self.ctx_lens[r.slot] + 1) // self.page)
            have = len(self.kvm.seq_pages[r.slot])
            if need > have and have < self.max_pages:
                wants[r.slot] = need - have
        if not wants:
            return residents
        try:
            self.kvm.extend_seqs(wants)
            return residents
        except OutOfBlocks:
            pass
        # slow path: grow slot by slot, preempting victims to the host
        # tier (without one, a slot that cannot grow pauses)
        failed = set()
        transient = False
        for slot, n in wants.items():
            if slot not in self.kvm.seq_pages \
                    or not self.kvm.is_resident(slot):
                # preempted earlier in this loop, or quarantined by a
                # failed preemption swap (its pages are free already)
                continue
            try:
                self.kvm.extend_seq(slot, n)
            except OutOfBlocks as e:
                transient |= e.transient
                if not self._preempt(exclude=slot):
                    failed.add(slot)
                    continue
                try:
                    self.kvm.extend_seq(slot, n)
                except OutOfBlocks as e:
                    transient |= e.transient
                    failed.add(slot)
        if len(failed) == len(residents) and not transient:
            # nothing extended, nothing swapped: the same state recurs
            # next step, so pausing would livelock instead of degrade.
            # An injected transient shortage is exempt: its schedule
            # advances at every consult, so the retry is progress
            raise OutOfBlocks(
                f"pool exhausted: all {len(residents)} resident "
                "sequences need pages and none can be grown or "
                "preempted (no host tier / no victim)")
        # a request quarantined in the loop holds a freed slot
        return [r for r in residents if r.slot not in failed
                and r.rid in self.active and self.kvm.is_resident(r.slot)]

    def _decode_step(self, done: Dict[int, List[int]]):
        self._ensure_resident()
        residents = [r for r in self.active.values()
                     if self.kvm.is_resident(r.slot)]
        if not residents:
            return
        residents = self._grow_pages(residents)
        if not residents:
            return
        tokens = np.zeros(self.n_slots, np.int32)
        resident_mask = np.zeros(self.n_slots, bool)
        for r in residents:
            tokens[r.slot] = (r.pending_prompt[0] if r.pending_prompt
                              else r.out[-1] if r.out else r.tokens[-1])
            resident_mask[r.slot] = True
        pages = self._page_bucket(max(
            len(self.kvm.seq_pages[r.slot]) for r in residents))
        dev = self.device
        next_tok = self.decode_fn(
            self.params, self.caches, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(self.ctx_lens, device=dev),
            self.kvm.state.table, torch.as_tensor(resident_mask, device=dev),
            pages)
        HOST_SYNCS[0] += 1
        self._finish_step(residents, next_tok.cpu().numpy(), done)

    def _finish_step(self, residents, next_tok: np.ndarray,
                     done: Dict[int, List[int]]):
        self.metrics["decode_steps"] += 1
        for r in list(residents):
            self.ctx_lens[r.slot] += 1
            if r.pending_prompt:
                # forced lane: the step consumed a known prompt token;
                # its prediction only counts once the prompt is done
                self.metrics["prefill_tokens"] += 1
                r.pending_prompt.pop(0)
                if r.pending_prompt:
                    continue
            tok = int(next_tok[r.slot])
            self._emit(r, [tok])
            if len(r.out) >= r.max_new or tok == self.eos_id:
                self._retire(r, done)

    def _emit(self, r: Request, toks: List[int]):
        r.out.extend(toks)
        if toks and not r.t_first:
            r.t_first = time.perf_counter()
        self.metrics["generated"] += len(toks)

    def _retire(self, r: Request, done: Dict[int, List[int]]):
        r.t_done = time.perf_counter()
        done[r.rid] = r.out[:r.max_new]
        self._journal_finish(r)
        self.kvm.free_seq(r.slot)
        self._release_slot(r.slot)
        del self.active[r.rid]

    def _release_slot(self, slot: int):
        """Per-slot cleanup at retirement and quarantine: a reused slot
        inherits no context length, residency ages, backoff or watchdog
        stamp."""
        self.ctx_lens[slot] = 0
        self._pending_since.pop(slot, None)
        self._resident_since.pop(slot, None)
        self._clear_fault_stamps(slot)

    # ------------------------------------------------------ macro-steps
    def _growth_need_ch(self, slot: int) -> np.ndarray:
        """Worst-case device blocks ``slot`` can pop during one K-step
        run, per owner channel ([total] at one channel): page p pops
        from channel (slot * max_pages + p) mod C. The same
        page-boundary arithmetic as the program and ``_growth_walk``."""
        have = len(self.kvm.seq_pages[slot])
        target = min(self.max_pages,
                     -(-(int(self.ctx_lens[slot]) + self.macro_k)
                       // self.page))
        out = np.zeros(self.channels, np.int64)
        base = slot * self.max_pages
        for p in range(have, target):
            out[(base + p) % self.channels] += 1
        return out

    def _macro_eligible(self) -> bool:
        """A macro step runs only when it provably cannot need the host
        mid-flight: the free pool covers the worst-case K-step growth of
        every decoding lane, so the device allocator cannot run dry.
        Finishing mid-run is fine (handled on the device). Under
        ``nonblocking_swap`` a swapped-out slot is no reason to fall
        back: it is a masked lane while the residents decode (the
        boundary scheduler reserved their growth); without it, every
        slot must be resident."""
        if not self._macro_on or not self.active:
            return False
        need = np.zeros(self.channels, np.int64)
        n_res = 0
        for r in self.active.values():
            if not self.kvm.is_resident(r.slot):
                if not self.nonblocking_swap:
                    return False
                continue
            n_res += 1
            need += self._growth_need_ch(r.slot)
        # per channel, against the brownout-shrunk budget
        return n_res > 0 and bool((need <= self._free_eff()).all())

    def _macro_lanes(self, residents, k: int):
        """Lane arrays for one K-step run: tokens/alive/budget/pages
        plus the forced-lane schedule of chunk-prefilled prompts."""
        s_n = self.n_slots
        tokens = np.zeros(s_n, np.int32)
        alive = np.zeros(s_n, bool)
        budget = np.zeros(s_n, np.int32)
        npages = np.zeros(s_n, np.int32)
        pend = np.zeros(s_n, np.int32)
        fmask = np.zeros((k, s_n), bool)
        ftok = np.zeros((k, s_n), np.int32)
        emit = np.ones((k, s_n), bool)
        slot2req: Dict[int, Request] = {}
        for r in residents:
            s = r.slot
            tokens[s] = (r.pending_prompt[0] if r.pending_prompt
                         else r.out[-1] if r.out else r.tokens[-1])
            alive[s] = True
            budget[s] = r.max_new - len(r.out)
            npages[s] = len(self.kvm.seq_pages[s])
            slot2req[s] = r
            # forced lanes: steps [0, P) consume known prompt tokens;
            # predictions before step P-1 are inside the prompt and
            # neither emit nor spend budget
            p = len(r.pending_prompt)
            pend[s] = p
            if p:
                chunk = r.pending_prompt[:k]
                fmask[:len(chunk), s] = True
                ftok[:len(chunk), s] = chunk
                emit[:min(p - 1, k), s] = False
        return (tokens, alive, budget, npages, pend, fmask, ftok, emit,
                slot2req)

    def _growth_walk(self, live_of_step, npages, ctx):
        """Which slots pop a block at each of the K steps: the one home
        of the program's arithmetic (``need = (ctx + page) // page;
        grow = live & (need > npg) & (npg < max_pages)``), shared by the
        simple schedule and the full-mode replay, which must pop in the
        device's order or the allocator mirror breaks.
        ``live_of_step(k)`` -> [S] bool. Returns (grow [K,S] bool,
        dl [K,S] int32 — each slot's next unmapped dlpn at that step,
        npg_end [S])."""
        k_n, s_n = self.macro_k, self.n_slots
        grow = np.zeros((k_n, s_n), bool)
        dl = np.zeros((k_n, s_n), np.int32)
        base = np.arange(s_n, dtype=np.int32) * self.max_pages
        npg = npages.copy()
        ctx = ctx.copy()
        for k in range(k_n):
            live = live_of_step(k)
            need = (ctx + self.page) // self.page
            grow[k] = live & (need > npg) & (npg < self.max_pages)
            dl[k] = base + npg
            npg += grow[k]
            ctx += live
        return grow, dl, npg

    def _macro_book_simple(self, residents, toks, pend, k: int,
                           done: Dict[int, List[int]]):
        """Boundary bookkeeping of a simple-mode run: every alive lane
        ran all K steps and none finished mid-run (budget == emitted
        retires here). A forced lane's outputs start at step P-1."""
        self.metrics["decode_steps"] += k
        for r in residents:
            s = r.slot
            p = int(pend[s])
            if p:
                self.metrics["prefill_tokens"] += min(p, k)
                del r.pending_prompt[:min(p, k)]
                outs = [int(t) for t in toks[p - 1:, s]] if p <= k else []
            else:
                outs = [int(t) for t in toks[:, s]]
            self._emit(r, outs)
            self.ctx_lens[s] += k
            if len(r.out) >= r.max_new:
                self._retire(r, done)

    def _macro_book_full(self, valid, toks, slot2req,
                         done: Dict[int, List[int]]):
        """Boundary bookkeeping of a full-mode run: replay the emitted
        tokens step by step (NIL lanes emitted nothing)."""
        for k in range(valid.shape[0]):
            if not valid[k].any():
                break                  # everyone retired: steps k.. idle
            stepped = [slot2req[s] for s in range(self.n_slots)
                       if valid[k, s]]
            self._finish_step(stepped, toks[k], done)

    def _step_buckets(self, live, npages, grow_sched) -> Tuple[int, ...]:
        """Each step's table width: the bucket a single step would use
        there, from the pages the growth walk has mapped by that step
        (``grow_sched`` [K,S]) over the lanes live at it (``live``
        [K,S]). A step with no live lane keeps the previous width."""
        npg = npages[None] + np.cumsum(grow_sched, axis=0)
        pages, b = [], self.min_page_bucket
        for s in range(self.macro_k):
            if live[s].any():
                b = self._page_bucket(int(npg[s][live[s]].max()))
            pages.append(b)
        return tuple(pages)

    def _macro_live(self, alive, budget, emit, simple: bool):
        """[K,S] lanes that decode at each step, as far as the host can
        tell: ``alive`` throughout a simple run; in a full run a lane
        stops after the step that spends its budget (an EOS stop is not
        known here: such a lane counts as live, which only widens later
        steps' buckets)."""
        if simple:
            return np.broadcast_to(alive, (self.macro_k, self.n_slots))
        spent = np.cumsum(emit, axis=0) - emit
        return alive[None] & (spent < budget[None])

    def _macro_decode_step(self, done: Dict[int, List[int]]):
        """One K-step run, then the boundary work: ONE host sync (the
        token matrix + oob flag), the replay of the device's pops onto
        the host pool, token bookkeeping, frees."""
        if self.channels > 1:
            self._macro_decode_step_sharded(done)
            return
        self.kvm.sync_allocator()      # no-op unless the pool mutated
        # swap-pending slots stay active but are not in the run: masked
        # lanes until the boundary scheduler resumes them
        residents = [r for r in self.active.values()
                     if self.kvm.is_resident(r.slot)]
        k = self.macro_k
        (tokens, alive, budget, npages, pend, fmask, ftok, emit,
         slot2req) = self._macro_lanes(residents, k)
        # simple mode applies when no lane can finish mid-run: a forced
        # lane only emits K - (P-1) tokens, so its budget covers that
        gen = k - np.maximum(pend - 1, 0)
        simple = self.eos_id < 0 and bool(
            (budget[alive] >= gen[alive]).all())
        lanes = dict(tokens=tokens, ctx=self.ctx_lens, alive=alive,
                     budget=budget, npages=npages)
        # no retirement in a simple run: the live set is static, so the
        # growth schedule is a pure function of what the host holds
        live = self._macro_live(alive, budget, emit, simple)
        grow_sched, dl, _ = self._growth_walk(lambda s: live[s], npages,
                                              self.ctx_lens)
        if simple:
            lanes.update(grow=grow_sched, dl=dl)
        pages = self._step_buckets(live, npages, grow_sched)
        forced = bool(pend.any())
        if forced:
            lanes.update(fmask=fmask, ftok=ftok, emit=emit)
        buf = macro.pack_inputs(k, self.n_slots, **lanes)
        MACRO_DISPATCHES[0] += 1
        if self._graphs is not None:
            st, out = self._graphs.run(self.kvm.state, buf, simple, forced,
                                       pages)
        else:
            st, out = macro.run_eager(self, buf, simple, forced, pages)
        self.kvm.state = st
        HOST_SYNCS[0] += 1
        out = out.cpu().numpy()
        toks, oob = out[:-1].reshape(k, self.n_slots), bool(out[-1])
        self.metrics["macro_steps"] += 1
        if simple:
            # np.nonzero on [K,S] is row-major == the device's
            # step-major, slot-ascending pop order
            grow_seq = [int(s) for s in np.nonzero(grow_sched)[1]]
        else:
            # NIL marks lanes that emitted nothing; replay the growth
            # decisions gated on the run's own live mask to recover
            # the pop sequence (no allocation log left the device)
            valid = (toks >= 0) & alive[None, :]
            grew, _, _ = self._growth_walk(lambda s: valid[s], npages,
                                           self.ctx_lens)
            grow_seq = [int(s) for s in np.nonzero(grew)[1]]
        got = self.kvm.reconcile_macro(grow_seq)
        self._retire_macro_programs(grow_seq, got)
        if simple:
            self._macro_book_simple(residents, toks, pend, k, done)
        else:
            self._macro_book_full(valid, toks, slot2req, done)
        if oob:
            # unreachable past the eligibility check; fold the flag into
            # the pool's exhaustion counts and mark the allocator dirty
            # (the re-sync clears it), single-step mode recovers
            self.kvm.observe_exhaustion(flags=[oob])

    def _retire_macro_programs(self, grow_seq, got):
        """The program-fault check of a one-channel K-step run's pops.
        The run already wrote KV into them, so a bad block's relocation
        also moves its rows (``retire_bad_blocks(pools=...)``: one
        COND_UPDATE commit and in-place row copies). The plane is
        consulted in the device's pop order (step-major, slot-ascending:
        ``grow_seq``), as the pre-commit paths consult it."""
        kvm = self.kvm
        if not got or kvm.faults is None:
            return
        idx = {s: len(kvm.seq_pages[s]) - len(bs) for s, bs in got.items()}
        bad = []
        for s in grow_seq:
            j = idx[s]
            idx[s] = j + 1
            if kvm.faults.program_fails():
                bad.append((s * self.max_pages + j, kvm.seq_pages[s][j]))
        if bad:
            kvm.retire_bad_blocks(bad, pools=self._pools(), block_axis=2)


    def _macro_decode_step_sharded(self, done: Dict[int, List[int]]):
        """The channel-sharded K-step run: commit the run's worst-case
        growth (no retirement) ahead of it, as one channel-aware pool
        allocation in the run's pop order (step-major, slot-ascending:
        what K single steps pop) and one map commit
        (``precommit_growth``), then the K decode steps against that
        table (``macro.macro_fn`` on the stacked state) and the usual
        bookkeeping. Per K tokens: one dispatch, one host sync, at most
        one map call, no allocator re-sync. A pool that cannot cover the schedule (the
        commit raises before any pop) falls back to one single step."""
        residents = [r for r in self.active.values()
                     if self.kvm.is_resident(r.slot)]
        k = self.macro_k
        (tokens, alive, budget, npages, pend, fmask, ftok, emit,
         slot2req) = self._macro_lanes(residents, k)
        grow_sched, dl, _ = self._growth_walk(lambda s: alive, npages,
                                              self.ctx_lens)
        grow_seq = [int(s) for s in np.nonzero(grow_sched)[1]]
        try:
            self.kvm.precommit_growth(
                grow_seq, dlpns=[int(d) for d in dl[grow_sched]])
        except OutOfBlocks:
            self.metrics["macro_fallbacks"] += 1
            self._decode_step(done)
            return
        gen = k - np.maximum(pend - 1, 0)
        simple = self.eos_id < 0 and bool(
            (budget[alive] >= gen[alive]).all())
        # each step's width from the pre-committed walk, over the lanes
        # that decode there (a lane live at a step has grown as it would
        # have in single steps)
        pages = self._step_buckets(
            self._macro_live(alive, budget, emit, simple), npages,
            grow_sched)
        lanes = dict(tokens=tokens, ctx=self.ctx_lens, alive=alive,
                     budget=budget)
        forced = bool(pend.any())
        if forced:
            lanes.update(fmask=fmask, ftok=ftok, emit=emit)
        buf = macro.pack_inputs(k, self.n_slots, **lanes)
        MACRO_DISPATCHES[0] += 1
        if self._graphs is not None:
            st, out = self._graphs.run(self.kvm.state, buf, simple, forced,
                                       pages)
        else:
            st, out = macro.run_eager(self, buf, simple, forced, pages)
        self.kvm.state = st
        HOST_SYNCS[0] += 1
        toks = out[:k * self.n_slots].cpu().numpy().reshape(k, self.n_slots)
        self.metrics["macro_steps"] += 1
        if simple:
            self._macro_book_simple(residents, toks, pend, k, done)
        else:
            valid = (toks >= 0) & alive[None, :]
            self._macro_book_full(valid, toks, slot2req, done)

    def _device_lanes(self) -> int:
        """Committed map-write lanes on the device (the ``commit_seq``
        lane, summed over the channel shards). A readback: diagnostics
        and tests only."""
        return int(fb.commit_seq_vec(self.kvm.state).sum())


# ----------------------------------------------------------------------
def _scatter_prefill(cfg, rt, caches, cols, table_row, slot: int,
                     scratch_block: int):
    """Write one request's prefill caches (B=1) in place: KV into its
    pool blocks, conv/SSM states into its slot. cols: per-period-index
    list of {"kv": (k, v)} with leaves [n_periods, 1, S, KV, hd] or
    {"ssm": (conv, state)} with leaves [n_periods, 1, K-1, C] and
    [n_periods, 1, nh, hd, N]. The reference's KV scatter drops rows
    outside the pool (``mode="drop"``); here such rows (NIL, never
    produced at admission) are routed to the scratch block instead,
    which holds garbage by design."""
    a_of, s_of = transformer.kind_index(cfg)
    page = rt.page_size
    for j in range(cfg.period):
        col = cols[j]
        if "kv" in col:
            k, v = col["kv"]
            n_p, _, s, kvh, hd = k.shape
            npages = -(-s // page)
            pad = npages * page - s
            kp = F.pad(k[:, 0], (0, 0, 0, 0, 0, pad)).reshape(
                n_p, npages, page, kvh, hd)
            vp = F.pad(v[:, 0], (0, 0, 0, 0, 0, pad)).reshape(
                n_p, npages, page, kvh, hd)
            rows = table_row[:npages].long()
            rows = torch.where((rows < 0) | (rows >= scratch_block),
                               scratch_block, rows)
            ai = a_of[j]
            caches["pool_k"][:, ai, rows] = kp.to(caches["pool_k"].dtype)
            caches["pool_v"][:, ai, rows] = vp.to(caches["pool_v"].dtype)
        if "ssm" in col:
            conv, state = col["ssm"]
            si = s_of[j]
            caches["conv"][:, si, slot] = conv[:, 0].to(caches["conv"].dtype)
            caches["ssm"][:, si, slot] = state[:, 0]
    return caches
