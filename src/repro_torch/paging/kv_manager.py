"""KV page manager: the FMMU as the serving page-table engine. Port of
the single-channel path of ``repro/paging/kv_manager.py``.

Logical address: DLPN = slot * max_pages + logical_page. Physical: a
block id in the KV pool. The mapping lives in the batched FMMU
(core/fmmu/batch); every map operation funnels through ONE fused entry
point (``_xlate`` -> ``translate_serving_``): one map commit per call
(one CMT probe, one insert pass and the incremental block-table
scatter; one kernel launch on the card), in place on ``self.state``.

The block table is a member of the device-resident map state, kept
coherent by the same call that commits each map write, so
``block_tables()`` is a view — no translation, no state change — and
decode performs zero full-map retranslations. ``retranslate_tables()``
keeps the from-scratch path as the test oracle.

Device-allocator mirror (the K-step macro path): the map state's
``free_stack``/``free_n`` mirror the host pool's free list. The host
pool is authoritative at macro-step boundaries: every host-side pool
mutation marks the device stacks stale and ``sync_allocator()``
re-pushes them before the next macro step. The pops a macro step makes
on the device are replayed onto the host pool (``reconcile_macro``) in
the same order, so both sides apply the same delta and steady-state
decode needs no re-push (``ALLOC_SYNCS``).

Not ported yet (later slices): the host tier and swaps, channel
sharding, GC, prefix sharing, the journal and the fault plane.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Union

import numpy as np
import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.core.fmmu import batch as fb
from repro_torch.core.fmmu.types import FMMUGeometry, NIL, UPDATE
from repro_torch.device import resolve_device
from repro_torch.paging.pool import BlockPool

# one bump per fused map call / full-map retranslation / allocator
# re-push
XLATE_CALLS = COUNTERS.cell("kvm.xlate_calls")
FULL_TABLE_CALLS = COUNTERS.cell("kvm.full_table_calls")
ALLOC_SYNCS = COUNTERS.cell("kvm.alloc_syncs")


@dataclasses.dataclass
class MapStats:
    """Typed ``KVPageManager.hit_stats()`` result: the reference's map
    and write counters that this slice maintains."""
    hits: int = 0
    misses: int = 0
    fills: int = 0
    updates: int = 0
    host_writes: int = 0
    pool_exhausted: List[int] = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __getitem__(self, key: str):
        if not any(f.name == key for f in dataclasses.fields(self)):
            raise KeyError(key)
        return getattr(self, key)


def _geometry(n_slots: int, max_pages: int) -> FMMUGeometry:
    """Map geometry sized for the serving grid (the reference's
    ``_geometry`` at one channel)."""
    n_dlpns = n_slots * max_pages
    ept = max(64, min(4096, max_pages))
    return FMMUGeometry(
        cmt_sets=max(8, min(512, n_dlpns // 64)),
        cmt_ways=4,
        cmt_entries=8,
        ctp_sets=8, ctp_ways=4,
        entries_per_tp=ept,
        n_tvpns=-(-n_dlpns // ept),
        queue_cap=64,
    )


class KVPageManager:
    """Host-driven control plane; device-resident map state."""

    def __init__(self, n_slots: int, max_pages: int, n_device_blocks: int,
                 *, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_pages = max_pages
        self.geom = _geometry(n_slots, max_pages)
        self.state = fb.init_serving_state(self.geom, n_device_blocks,
                                           n_lanes=n_slots,
                                           device=self.device)
        self.pool = BlockPool(n_device_blocks)
        self.seq_pages: Dict[int, List[int]] = {}   # slot -> block ids
        self.host_writes = 0
        # the device stacks are stale after a host-side pool mutation
        self._alloc_dirty = False

    # ----------------------------------------------------------- helpers
    def _dlpns(self, slot: int, n: int) -> np.ndarray:
        return np.arange(slot * self.max_pages, slot * self.max_pages + n,
                         dtype=np.int32)

    def _xlate(self, kind: int, dlpns, dppns):
        """Single fused map entry: one commit services the whole op
        batch, in place on the state's tensors. Lanes go host->device;
        nothing comes back."""
        XLATE_CALLS[0] += 1
        dev = self.device
        dl = torch.as_tensor(np.asarray(dlpns, np.int32), device=dev)
        dp = torch.as_tensor(np.asarray(dppns, np.int32), device=dev)
        return fb.translate_serving_(self.geom, self.state,
                                     torch.full_like(dl, kind), dl, dp,
                                     torch.zeros_like(dl))

    # ----------------------------------------------------------- API
    def new_seq(self, slot: int, n_pages: int) -> List[int]:
        """Admit a sequence into `slot` with `n_pages` logical pages."""
        assert slot not in self.seq_pages, f"slot {slot} busy"
        dl = self._dlpns(slot, n_pages)
        blocks = self.pool.alloc(n_pages)
        self.host_writes += len(blocks)
        self._alloc_dirty = True
        self._xlate(UPDATE, dl, blocks)
        self.seq_pages[slot] = list(blocks)
        return list(blocks)

    def extend_seq(self, slot: int, n_new: int) -> List[int]:
        return self.extend_seqs({slot: n_new}).get(slot, [])

    def extend_seqs(self, wants: Dict[int, int]) -> Dict[int, List[int]]:
        """Grow several sequences at once: ONE pool allocation and ONE
        fused map call for the whole step (the decode hot path). Raises
        OutOfBlocks before any state changes if the pool can't cover
        the full batch."""
        wants = {s: n for s, n in wants.items() if n > 0}
        if not wants:
            return {}
        dl: List[int] = []
        for slot, n in wants.items():           # validate BEFORE alloc
            have = len(self.seq_pages[slot])
            dl.extend(slot * self.max_pages + p
                      for p in range(have, have + n))
        blocks = self.pool.alloc(len(dl))
        self.host_writes += len(blocks)
        self._alloc_dirty = True
        got: Dict[int, List[int]] = {}
        i = 0
        for slot, n in wants.items():
            got[slot] = blocks[i:i + n]
            i += n
            self.seq_pages[slot].extend(got[slot])
        self._xlate(UPDATE, dl, blocks)
        return got

    def free_seq(self, slot: int):
        blocks = self.seq_pages.pop(slot)
        dl = self._dlpns(slot, len(blocks))
        self._xlate(UPDATE, dl, np.full(len(blocks), NIL, np.int32))
        self.pool.free(blocks)
        self._alloc_dirty = True

    def is_resident(self, slot: int) -> bool:
        """True when no page of `slot` lives in the host tier — always,
        as this slice has no host tier."""
        return True

    def block_tables(self) -> torch.Tensor:
        """[n_slots, max_pages] int32 device view of the incremental
        table: no translation, no state change. NIL for unmapped. Map
        commits update it in place; an allocator re-sync or a macro step
        may replace the state's tensors, so re-fetch."""
        n = self.n_slots * self.max_pages    # table is geometry-padded
        return self.state.table[:n].reshape(self.n_slots, self.max_pages)

    def retranslate_tables(self) -> torch.Tensor:
        """From-scratch full-map retranslation: every DLPN through
        ``lookup_batch``. The churn-equivalence test oracle only."""
        FULL_TABLE_CALLS[0] += 1
        dl = torch.arange(self.n_slots * self.max_pages, dtype=torch.int32,
                          device=self.device)
        fmmu, out = fb.lookup_batch(self.geom, self.state.fmmu, dl)
        self.state = self.state._replace(fmmu=fmmu)
        return out.reshape(self.n_slots, self.max_pages)

    # ------------------------------------------- device allocator mirror
    def sync_allocator(self):
        """Re-push the host free list into the device allocator stacks
        and clear the OutOfBlocks flag. No-op unless a host-side pool
        mutation happened since the last sync: steady-state macro decode
        performs none (``ALLOC_SYNCS``). No host tier: the host stack is
        empty and no lane is swap-pending."""
        if not self._alloc_dirty:
            return
        ALLOC_SYNCS[0] += 1
        dev = np.full(self.pool.n_device, NIL, np.int32)
        dev[:len(self.pool._free_dev)] = self.pool._free_dev
        self.state = fb.set_allocator(
            self.state, dev, np.int32(len(self.pool._free_dev)),
            np.zeros(0, np.int32), np.int32(0),
            np.zeros(self.n_slots, bool))
        self._alloc_dirty = False

    def reconcile_macro(self, grow_seq: List[int]) -> Dict[int, List[int]]:
        """Replay a macro step's device-side pops onto the host pool and
        page lists. ``grow_seq`` is the slot sequence that popped blocks
        in device pop order (step-major, slot-ascending within a step);
        popping the mirrored host free list in the same order yields the
        same block ids, so no allocation log leaves the device. The pool
        is not marked dirty: both sides applied the same delta. Returns
        {slot: [new blocks]} in page order."""
        got: Dict[int, List[int]] = {}
        if not grow_seq:
            return got
        blocks = self.pool.alloc(len(grow_seq))
        self.host_writes += len(blocks)
        for slot, b in zip(grow_seq, blocks):
            self.seq_pages[slot].append(b)
            got.setdefault(slot, []).append(b)
        return got

    def observe_exhaustion(self, flags):
        """Fold the sticky in-graph OutOfBlocks flags (host values, one
        per channel: the macro boundary passes the flag its one sync
        read) into the pool's per-channel exhaustion counts. A set flag
        marks the allocator dirty, so the next ``sync_allocator``
        re-push clears it."""
        for c, hit in enumerate(flags):
            if hit:
                self.pool.note_exhausted(c)
                self._alloc_dirty = True

    def free_device_vec(self) -> np.ndarray:
        """Free device blocks per channel ([total] at one channel): the
        engine's growth-reserve check compares per channel."""
        return np.asarray([self.pool.free_device], np.int64)

    def hit_stats(self) -> MapStats:
        """Map counters (a device->host read: diagnostics, not the hot
        path)."""
        s = self.state.fmmu.stats.cpu().tolist()
        return MapStats(hits=s[0], misses=s[1], fills=s[2], updates=s[3],
                        host_writes=self.host_writes,
                        pool_exhausted=list(self.pool.exhausted_ch))


__all__ = ["KVPageManager", "MapStats", "XLATE_CALLS", "FULL_TABLE_CALLS",
           "ALLOC_SYNCS"]
