"""KV page manager: the FMMU as the serving page-table engine. Port of
``repro/paging/kv_manager.py`` (one or C channels, host tier).

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

Host tier and swaps (one channel): a swap moves every page of a slot
that sits in the other tier with ONE map commit (``_swap``): each lane
a COND_UPDATE from the moving block to a fresh block of the other tier,
so the commit lands only where the map still points at the old block,
as the paper's relocations do. The same call flips the slot's
``swap_pending`` lane and moves the pool rows, in place; with
``check=False`` nothing is read back, so the host never waits on it.
The host tier is rows ``[n_device, n_device + n_host)`` of the same pool
tensors (``BlockPool.host_row``).

Device-allocator mirror (the K-step macro path): the map state's
``free_stack``/``free_n`` mirror the host pool's free list. The host
pool is authoritative at macro-step boundaries: every host-side pool
mutation marks the device stacks stale and ``sync_allocator()``
re-pushes them before the next macro step. The pops a macro step makes
on the device are replayed onto the host pool (``reconcile_macro``) in
the same order, so both sides apply the same delta and steady-state
decode needs no re-push (``ALLOC_SYNCS``).

Channel sharding (``channels=C > 1``): the map state is C per-channel
shards stacked on a leading axis (``batch.init_sharded_state``: each a
1/C-sized CMT, backing table and block-table slice, and the free stacks
of the blocks its channel owns), routed by the static hash owner(dlpn) =
dlpn mod C. Every map call is one sharded commit (one ``fmmu_commit``
launch of C blocks on the card), the pool stripes its free lists the
same way and allocates per owner channel (``_alloc_blocks``), and
``block_tables()`` interleaves the shards back to global order. The
channel-sharded macro path pre-commits a K-step run's growth at the
boundary (``precommit_growth``) instead of popping on the device, so
``reconcile_macro`` is the one-channel replay only.
``channel_lanes`` counts the lanes each channel serviced. At C > 1 no
serving path reads the device free stacks: the engine re-syncs them
only before a one-channel K-step run, so there they go stale by design,
and ``sync_allocator``'s C > 1 branch (with its blocking ``oob_vec``
read), ``batch.set_allocator_sharded`` and ``batch.grow_sharded_`` (the
kernel's sharded grow mode) are parity code with the reference, reached
by the tests and the kernel checks only.

Not ported yet (later slices): the channel mesh across devices, GC,
prefix sharing, the journal and the fault plane (so a swap has no
``SwapFault`` injection, no journal record and no shared-block filter,
and a pre-commit no program-fault retirement).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.core.fmmu import batch as fb
from repro_torch.core.fmmu.types import (COND_UPDATE, FMMUGeometry,
                                         LOOKUP, NIL, UPDATE)
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
    swaps_out: int = 0
    swaps_in: int = 0
    host_resident_slots: int = 0
    pool_exhausted: List[int] = dataclasses.field(default_factory=list)
    host_writes: int = 0
    flash_programs: int = 0
    write_amp: float = 1.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __getitem__(self, key: str):
        if not any(f.name == key for f in dataclasses.fields(self)):
            raise KeyError(key)
        return getattr(self, key)


def _geometry(n_slots: int, max_pages: int,
              channels: int = 1) -> FMMUGeometry:
    """Map geometry sized for one channel's shard: with C channels each
    shard owns ceil(n_dlpns / C) logical pages, so its CMT and backing
    table are 1/C-sized (the paper's per-channel partitioning)."""
    n_dlpns = -(-n_slots * max_pages // channels)
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
                 n_host_blocks: int = 0, channels: int = 1, *,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_pages = max_pages
        self.channels = c_n = int(channels)
        self.geom = _geometry(n_slots, max_pages, c_n)
        if c_n > 1:
            self.state = fb.init_sharded_state(
                self.geom, c_n, n_device_blocks, n_host_blocks,
                n_lanes=n_slots, device=self.device)
        else:
            self.state = fb.init_serving_state(
                self.geom, n_device_blocks, n_lanes=n_slots,
                n_host_blocks=n_host_blocks, device=self.device)
        self.pool = BlockPool(n_device_blocks, n_host_blocks,
                              n_channels=c_n)
        # lanes each channel serviced (routed map lanes): the 1/C
        # translate-work split is read from these, not inferred
        self.channel_lanes = np.zeros(c_n, np.int64)
        self.seq_pages: Dict[int, List[int]] = {}   # slot -> block ids
        # host-tier page count per slot, kept by the swaps so the
        # residency predicate is O(1)
        self._host_pages: Dict[int, int] = {}
        self.host_writes = 0
        # the device stacks are stale after a host-side pool mutation
        self._alloc_dirty = False

    # ----------------------------------------------------------- helpers
    def _dlpns(self, slot: int, n: int) -> np.ndarray:
        return np.arange(slot * self.max_pages, slot * self.max_pages + n,
                         dtype=np.int32)

    def _lanes(self, *arrays) -> List[torch.Tensor]:
        """Equal-length int32 lane arrays on the device, through one
        host->device copy. On the card the copy is staged in pinned
        memory and does not block the host; PyTorch's pinned allocator
        records the copy on the stream and hands the buffer out again
        only after it has run."""
        buf = torch.empty((len(arrays), len(arrays[0])), dtype=torch.int32,
                          pin_memory=self.device.type == "cuda")
        host = buf.numpy()
        for row, a in zip(host, arrays):
            row[:] = a
        return list(buf.to(self.device, non_blocking=True).unbind(0))

    def _count_lanes(self, dlpns) -> None:
        dl = np.asarray(dlpns, np.int64)
        self.channel_lanes += np.bincount(dl[dl >= 0] % self.channels,
                                          minlength=self.channels)

    def _commit(self, opcodes, dl, dp, old):
        """One map commit in place on the state (per channel when
        sharded: one launch either way): (out, ok)."""
        if self.channels > 1:
            return fb.translate_sharded_(self.geom, self.channels,
                                         self.state, opcodes, dl, dp, old)
        return fb.translate_serving_(self.geom, self.state, opcodes, dl,
                                     dp, old)

    def _xlate(self, kind: int, dlpns, dppns):
        """Single fused map entry: one commit services the whole op
        batch, in place on the state's tensors. Lanes go host->device;
        nothing comes back."""
        XLATE_CALLS[0] += 1
        self._count_lanes(dlpns)
        dl, dp = self._lanes(dlpns, dppns)
        return self._commit(torch.full_like(dl, kind), dl, dp,
                            torch.zeros_like(dl))

    def _alloc_blocks(self, dlpns: Sequence[int], *,
                      host: bool = False) -> List[int]:
        """Pool allocation for a batch of dlpns: channel-free pops at one
        channel, per owner channel otherwise (a page and its block share
        a channel, so each channel's device stack mirror stays exact)."""
        if self.channels == 1:
            return self.pool.alloc(len(dlpns), host=host)
        return self.pool.alloc_for(
            [int(d) % self.channels for d in dlpns], host=host)

    # ----------------------------------------------------------- API
    def new_seq(self, slot: int, n_pages: int) -> List[int]:
        """Admit a sequence into `slot` with `n_pages` logical pages."""
        assert slot not in self.seq_pages, f"slot {slot} busy"
        dl = self._dlpns(slot, n_pages)
        blocks = self._alloc_blocks(dl)
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
        blocks = self._alloc_blocks(dl)
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
        """Unmap every page of ``slot`` and return its blocks, of both
        tiers, to the pool."""
        blocks = self.seq_pages.pop(slot)
        self._host_pages.pop(slot, None)
        dl = self._dlpns(slot, len(blocks))
        self._xlate(UPDATE, dl, np.full(len(blocks), NIL, np.int32))
        self.pool.free(blocks)
        self._alloc_dirty = True

    def is_resident(self, slot: int) -> bool:
        """True when no page of `slot` lives in the host tier (the swaps
        keep the count; allocation only ever adds device blocks)."""
        return self._host_pages.get(slot, 0) == 0

    def n_device_pages(self, slot: int) -> int:
        """Device-tier pages held by `slot` (a preemption victim needs
        one, or swapping it out moves nothing)."""
        return (len(self.seq_pages.get(slot, ()))
                - self._host_pages.get(slot, 0))

    def n_host_pages(self, slot: int) -> int:
        """Host-tier pages held by `slot`."""
        return self._host_pages.get(slot, 0)

    def host_pages_vec(self, slot: int) -> np.ndarray:
        """Host-tier pages of `slot` per owner channel ([total] at one
        channel): the device blocks its swap-in would take."""
        out = np.zeros(self.channels, np.int64)
        for b in self.seq_pages.get(slot, ()):
            if BlockPool.is_host(b):
                out[self.pool.channel_of(b)] += 1
        return out

    def block_tables(self) -> torch.Tensor:
        """[n_slots, max_pages] int32 device view of the incremental
        table: no translation, no state change. NIL for unmapped;
        host-tier blocks appear tagged (>= HOST_BASE). Map
        commits update it in place; an allocator re-sync or a macro step
        may replace the state's tensors, so re-fetch. With channels the
        shards interleave back to global order (a relayout, no
        translation)."""
        n = self.n_slots * self.max_pages    # table is geometry-padded
        return fb.dense_table(self.state, n).reshape(
            self.n_slots, self.max_pages)

    def retranslate_tables(self) -> torch.Tensor:
        """From-scratch full-map retranslation: every DLPN through
        ``lookup_batch``. The churn-equivalence test oracle only. With
        channels every channel looks up all of its local pages (one
        sharded LOOKUP commit), and the answers interleave back."""
        FULL_TABLE_CALLS[0] += 1
        n = self.n_slots * self.max_pages
        if self.channels > 1:
            n_local = self.geom.n_tvpns * self.geom.entries_per_tp
            dl = torch.arange(self.channels * n_local, dtype=torch.int32,
                              device=self.device)
            out, _ = fb.translate_sharded_(
                self.geom, self.channels, self.state,
                torch.full_like(dl, LOOKUP), dl, torch.zeros_like(dl),
                torch.zeros_like(dl))
            return out[:n].reshape(self.n_slots, self.max_pages)
        dl = torch.arange(n, dtype=torch.int32, device=self.device)
        fmmu, out = fb.lookup_batch(self.geom, self.state.fmmu, dl)
        self.state = self.state._replace(fmmu=fmmu)
        return out.reshape(self.n_slots, self.max_pages)

    # ------------------------------------------- device allocator mirror
    def sync_allocator(self):
        """Re-push the host free lists (both tiers) into the device
        allocator stacks, refresh the ``swap_pending`` lane from the
        host's tier bookkeeping and clear the OutOfBlocks flag. No-op
        unless a host-side pool mutation happened since the last sync:
        steady-state macro decode performs none (``ALLOC_SYNCS``). A
        host-side free of a swapped-out slot leaves its lane set until
        here; every such free also dirties the pool."""
        if not self._alloc_dirty:
            return
        ALLOC_SYNCS[0] += 1
        resid = np.zeros(self.n_slots, bool)
        for s, c in self._host_pages.items():
            resid[s] = c > 0
        pool = self.pool
        if self.channels > 1:
            # the re-push clears the per-channel oob flags: fold set ones
            # into the exhaustion counts first (the sharded engine reads
            # the lane nowhere else)
            self.observe_exhaustion()
            c_n = self.channels
            dev = np.full(tuple(self.state.free_stack.shape), NIL, np.int32)
            host = np.full(tuple(self.state.host_stack.shape), NIL,
                           np.int32)
            for c in range(c_n):
                dev[c, :pool.free_device_ch(c)] = pool._free_dev_ch[c]
                host[c, :pool.free_host_ch(c)] = pool._free_host_ch[c]
            self.state = fb.set_allocator_sharded(
                self.state, dev,
                [pool.free_device_ch(c) for c in range(c_n)], host,
                [pool.free_host_ch(c) for c in range(c_n)], resid)
            self._alloc_dirty = False
            return
        dev = np.full(pool.n_device, NIL, np.int32)
        dev[:len(pool._free_dev)] = pool._free_dev
        host = np.full(pool.n_host, NIL, np.int32)
        host[:len(pool._free_host)] = pool._free_host
        self.state = fb.set_allocator(
            self.state, dev, np.int32(len(pool._free_dev)), host,
            np.int32(len(pool._free_host)), resid)
        self._alloc_dirty = False

    def reconcile_macro(self, grow_seq: List[int]) -> Dict[int, List[int]]:
        """Replay a macro step's device-side pops onto the host pool and
        page lists. ``grow_seq`` is the slot sequence that popped blocks
        in device pop order (step-major, slot-ascending within a step);
        popping the mirrored host free list in the same order yields the
        same block ids, so no allocation log leaves the device. The pool
        is not marked dirty: both sides applied the same delta. Returns
        {slot: [new blocks]} in page order. The one-channel replay: a
        sharded K-step run pops nothing on the device
        (``precommit_growth``), so replaying here would break the
        mirror."""
        assert self.channels == 1, \
            "reconcile_macro is the channels=1 replay; sharded macro " \
            "steps pre-commit growth via precommit_growth instead"
        got: Dict[int, List[int]] = {}
        if not grow_seq:
            return got
        blocks = self.pool.alloc(len(grow_seq))
        self.host_writes += len(blocks)
        for slot, b in zip(grow_seq, blocks):
            self.seq_pages[slot].append(b)
            got.setdefault(slot, []).append(b)
        return got

    def _grow_dlpns(self, grow_seq: List[int]) -> List[int]:
        """Growth dlpns for a pop sequence: each entry is the slot's
        next unmapped page at that point in the sequence."""
        pages = {s: len(self.seq_pages[s]) for s in set(grow_seq)}
        dl = []
        for s in grow_seq:
            dl.append(s * self.max_pages + pages[s])
            pages[s] += 1
        return dl

    def precommit_growth(self, grow_seq: List[int],
                         dlpns: Optional[List[int]] = None
                         ) -> Dict[int, List[int]]:
        """Channel-sharded macro growth: commit a whole K-step growth
        schedule ahead of the run, as one channel-aware pool allocation
        in the run's pop order (step-major, slot-ascending: what K single
        steps pop) and one map commit. The run then decodes against the
        post-growth table with no allocator on the device. ``dlpns``
        (aligned with ``grow_seq``) is the schedule the engine's growth
        walk produced; without it the schedule is derived from the page
        lists. Raises OutOfBlocks before any pop or map write. Returns
        {slot: [new blocks]} in page order."""
        got: Dict[int, List[int]] = {}
        if not grow_seq:
            return got
        dl = list(dlpns) if dlpns is not None \
            else self._grow_dlpns(grow_seq)
        assert len(dl) == len(grow_seq)
        blocks = self._alloc_blocks(dl)
        # the pool popped, the device stacks did not: a re-sync (parity
        # with the reference; no C > 1 serving path makes one) re-pushes
        self._alloc_dirty = True
        self.host_writes += len(blocks)
        for slot, b in zip(grow_seq, blocks):
            self.seq_pages[slot].append(b)
            got.setdefault(slot, []).append(b)
        self._xlate(UPDATE, dl, blocks)
        return got

    def observe_exhaustion(self, flags=None) -> np.ndarray:
        """Fold the sticky OutOfBlocks flags (one per channel) into the
        pool's per-channel exhaustion counts. ``flags`` are host values
        (the one-channel macro boundary passes the flag its one sync
        read); None reads the state's lane (``oob_vec``). A set flag
        marks the allocator dirty, so the next ``sync_allocator``
        re-push clears it. Returns the flags."""
        if flags is None:
            flags = fb.oob_vec(self.state).cpu().numpy()
        flags = np.atleast_1d(np.asarray(flags))
        for c, hit in enumerate(flags):
            if hit:
                self.pool.note_exhausted(c % self.channels)
                self._alloc_dirty = True
        return flags

    def free_device_vec(self) -> np.ndarray:
        """Free device blocks per channel ([total] at one channel): the
        engine's growth-reserve checks compare per channel, because a
        dry channel is real pool pressure even while others have
        blocks."""
        return np.asarray([self.pool.free_device_ch(c)
                           for c in range(self.channels)], np.int64)

    # ----------------------------------------------------------- swapping
    def _swap(self, out: bool, slot: int, pools: List[torch.Tensor],
              block_axis: int, check: bool) -> int:
        """Shared body of swap_out / swap_in: the host bookkeeping, then
        one map commit (every lane a COND_UPDATE from the moving block
        to a fresh block of the other tier), the slot's residency flip
        and the pool-row moves, all in place. The lanes go to the device
        in one staged copy; only ``check=True`` reads anything back (the
        guard mask). Returns the number of pages moved."""
        blocks = self.seq_pages[slot]
        moving = [b for b in blocks if BlockPool.is_host(b) != out]
        if not moving:
            return 0
        dl = [slot * self.max_pages + i for i, b in enumerate(blocks)
              if BlockPool.is_host(b) != out]
        fresh = self._alloc_blocks(dl, host=out)
        self._alloc_dirty = True
        row = self.pool.host_row
        src = [b if out else row(b) for b in moving]
        dst = [row(b) if out else b for b in fresh]
        XLATE_CALLS[0] += 1
        self._count_lanes(dl)
        dl_t, new_t, old_t, src_t, dst_t = self._lanes(dl, fresh, moving,
                                                       src, dst)
        _, ok = self._commit(torch.full_like(dl_t, COND_UPDATE), dl_t,
                             new_t, old_t)
        fb.mark_swap_(self.state, slot, out)    # every channel's copy
        src_t, dst_t = src_t.long(), dst_t.long()
        for p in pools:        # source and destination rows are disjoint
            p.index_copy_(block_axis, dst_t, p.index_select(block_axis,
                                                            src_t))
        if check and not bool(ok.all()):
            raise RuntimeError("swap raced with a concurrent relocation")
        self.pool.free(moving)
        where = dict(zip(moving, fresh))
        self.seq_pages[slot] = [where.get(b, b) for b in blocks]
        self._host_pages[slot] = sum(
            BlockPool.is_host(b) for b in self.seq_pages[slot])
        if out:
            self.pool.stats.swaps_out += len(moving)
        else:
            self.pool.stats.swaps_in += len(moving)
        return len(moving)

    def swap_out(self, slot: int, pools: List[torch.Tensor],
                 block_axis: int = 0, check: bool = True) -> int:
        """Relocate every device page of `slot` to the host tier, in
        place: one CondUpdate-guarded map commit, the ``swap_pending``
        lane set, and the pool rows moved in each of ``pools`` (the
        block index along ``block_axis``; host block b at row
        ``pool.host_row(b)``). Returns the pages moved. ``check=False``
        skips the guard-mask readback, so the host never waits (the
        serving scheduler's mode)."""
        return self._swap(True, slot, pools, block_axis, check)

    def swap_in(self, slot: int, pools: List[torch.Tensor],
                block_axis: int = 0, check: bool = True) -> int:
        """Bring a swapped-out sequence back to device blocks (the same
        pipeline as ``swap_out``; clears the lane)."""
        return self._swap(False, slot, pools, block_axis, check)

    def hit_stats(self) -> MapStats:
        """Map and tier counters (a device->host read: diagnostics, not
        the hot path). A swap-in programs every page it brings back, so
        it counts as flash programs beside the host's writes."""
        s = self.state.fmmu.stats.cpu()
        if self.channels > 1:
            s = s.sum(0, dtype=torch.int32)
        s = s.tolist()
        flash = self.host_writes + self.pool.stats.swaps_in
        return MapStats(
            hits=s[0], misses=s[1], fills=s[2], updates=s[3],
            swaps_out=self.pool.stats.swaps_out,
            swaps_in=self.pool.stats.swaps_in,
            host_resident_slots=sum(1 for c in self._host_pages.values()
                                    if c > 0),
            pool_exhausted=list(self.pool.exhausted_ch),
            host_writes=self.host_writes, flash_programs=flash,
            write_amp=flash / self.host_writes if self.host_writes else 1.0)


__all__ = ["KVPageManager", "MapStats", "XLATE_CALLS", "FULL_TABLE_CALLS",
           "ALLOC_SYNCS"]
