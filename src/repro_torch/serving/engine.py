"""Serving engine: continuous batching over a fixed slot grid, with the
FMMU page manager owning logical->physical KV translation. Port of the
single-step path of ``repro/serving/engine.py``, for dense and pure-SSM
models.

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

Not ported yet (later slices; ``ServeConfig`` rejects them): K-step
macro decode, the host tier and swaps, channel sharding, GC, prefix
sharing, journaling and the fault plane. Without a host tier there is
no preemption victim, so a slot whose page growth fails PAUSES until
blocks free up, as in the reference. As in the reference, every slot
runs through each decode step (token 0 on a paused or dead lane): its
KV write is masked to the scratch block, but a mamba layer's state of
a paused slot advances all the same (ROADMAP, reference divergences).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.counters import COUNTERS
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.paging.kv_manager import KVPageManager
from repro_torch.paging.pool import OutOfBlocks
from repro_torch.serving.config import ServeConfig

# one bump per blocking device->host readback (prefill's first token,
# each decode step's next tokens)
HOST_SYNCS = COUNTERS.cell("engine.host_syncs")


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
                 fault_plane=None):
        if fault_plane is not None:
            raise NotImplementedError(
                "not ported to repro_torch yet: fault_plane")
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
        self.kvm = KVPageManager(self.n_slots, self.max_pages, n_dev,
                                 device=self.device)
        # +1 scratch block: unmapped table entries (dead lanes) write
        # their garbage KV there instead of corrupting block 0
        self.scratch_block = n_dev
        # prefix sharing only applies to pure paged-attention state: a
        # mamba layer's recurrent state is per-slot and
        # position-dependent, so a skipped prefill cannot be rebuilt
        # from shared KV pages (ServeConfig rejects sharing for now)
        self._share_model_ok = not any(
            self.cfg.layer_kind(j) == "mamba"
            for j in range(self.cfg.period))
        self.caches = transformer.init_decode_caches(
            self.cfg, self.rt, self.n_slots, n_dev + 1,
            self.rt.compute_dtype, device=self.device)
        self.ctx_lens = np.zeros(self.n_slots, np.int32)
        self.active: Dict[int, Request] = {}
        self.eos_id = config.eos_id
        self.admit_tokens = config.admit_tokens
        self.queue: Deque[Request] = deque()
        self._rid = 0
        self.min_page_bucket = 4
        self.metrics = {"prefills": 0, "prefill_tokens": 0,
                        "decode_steps": 0, "generated": 0,
                        "chunked_prefills": 0}

    # ------------------------------------------------------------- API
    def submit(self, tokens: List[int], max_new: int = 16) -> int:
        rid = self._rid
        self._rid += 1
        self.queue.append(Request(rid, list(tokens), max_new,
                                  t_submit=time.perf_counter()))
        return rid

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        done: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            if not self.step(done):
                break
        return done

    def step(self, done: Dict[int, List[int]]) -> bool:
        """One scheduling round: admissions, then one decode step."""
        self._admit()
        if not self.active:
            return bool(self.queue)
        self._decode_step(done)
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
            self._do_prefill(req, chunk)
            if budget is not None:
                budget -= chunk

    def _preempt(self, exclude: int) -> bool:
        """Swap a victim out to the host tier. This slice has no host
        tier (the reference's ``n_host == 0`` branch), so there is never
        a victim: the caller pauses or stops instead."""
        return False

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
        """Flat incremental table -> [n_slots, <=pages] grid."""
        n = self.n_slots * self.max_pages    # table is geometry-padded
        grid = table[:n].reshape(self.n_slots, self.max_pages)
        return grid[:, :pages or self.max_pages]

    def _mask_tables(self, grid, live):
        """Mask dead lanes to the scratch block (their garbage KV write
        lands there) and clamp out-of-range entries (NIL, or ids past
        the pool) to it — what keeps every id the paged-attention kernel
        reads inside the pool."""
        t = torch.where(live[:, None], grid, self.scratch_block)
        return torch.where((t < 0) | (t >= self.scratch_block),
                           self.scratch_block, t)

    def _decode_fn(self, params, tokens, ctx_lens, table, resident_mask,
                   pages):
        """One decode step on the device: the flat table is reshaped and
        sliced to the live-page bucket, dead slots are masked to the
        scratch block with zeroed ctx, and greedy tokens come out."""
        tables = self._mask_tables(self._table_grid(table, pages),
                                   resident_mask)
        ctx = torch.where(resident_mask, ctx_lens, 0)
        logits, self.caches = self.m.decode_step(
            params, tokens, self.caches, ctx_lens=ctx, block_table=tables)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _grow_pages(self, residents) -> List[Request]:
        """Allocate pages for every resident crossing a page boundary:
        one batched allocation + one fused map call on the fast path.
        Returns the residents that may decode this step: a slot whose
        growth fails PAUSES (decoding it with the new page unmapped
        would write its KV into the scratch block) and retries every
        step until blocks free up."""
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
        # slow path: grow slot by slot (no host tier: no victim to
        # preempt, so a slot that cannot grow pauses)
        failed = set()
        for slot, n in wants.items():
            try:
                self.kvm.extend_seq(slot, n)
            except OutOfBlocks:
                failed.add(slot)
        if len(failed) == len(residents):
            # nothing extended, nothing swapped: the same state recurs
            # next step, so pausing would livelock instead of degrade
            raise OutOfBlocks(
                f"pool exhausted: all {len(residents)} resident "
                "sequences need pages and none can be grown or "
                "preempted (no host tier / no victim)")
        return [r for r in residents if r.slot not in failed]

    def _decode_step(self, done: Dict[int, List[int]]):
        residents = list(self.active.values())
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
        next_tok = self._decode_fn(
            self.params, torch.as_tensor(tokens, device=dev),
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
            r.out.append(tok)
            if not r.t_first:
                r.t_first = time.perf_counter()
            self.metrics["generated"] += 1
            if len(r.out) >= r.max_new or tok == self.eos_id:
                r.t_done = time.perf_counter()
                done[r.rid] = r.out[:r.max_new]
                self.kvm.free_seq(r.slot)
                self.ctx_lens[r.slot] = 0
                del self.active[r.rid]


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
