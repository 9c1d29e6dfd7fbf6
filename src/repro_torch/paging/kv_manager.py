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

Faults and journaling: with a fault plane (``faults``) the manager
consults it at its host commit points, as the reference does: a swap may
raise ``SwapFault`` before any change, an allocation may report a
transient shortage before any pop, and every freshly programmed device
block (admission, growth, a pre-commit; the engine checks a K-step
run's pops) may fail its program. A failed program is retired:
``retire_bad_blocks`` pops a same-channel replacement, moves the
mapping with one COND_UPDATE map commit (one ``fmmu_commit`` launch, of
C blocks when sharded) and, when the data was already written, the pool
rows in place, the swap's relocation (``_relocate``). With a journal
(``journal``) every commit point appends its record after the op, its
OOB frame first; ``snapshot_state`` and ``restore_mapping`` (one batched
UPDATE commit of every mapped page, one allocator re-push) are the
manager's share of a snapshot and of recovery.

Not ported yet (later slices): the channel mesh across devices, GC and
prefix sharing (so a swap has no shared-block filter).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import faults as flt
from repro_torch.core import journal as jl
from repro_torch.core.counters import COUNTERS
from repro_torch.core.fmmu import batch as fb
from repro_torch.core.fmmu.types import (COND_UPDATE, SWAP_IN, SWAP_OUT,
                                         FMMUGeometry, LOOKUP, NIL, UPDATE)
from repro_torch.device import resolve_device
from repro_torch.paging.pool import BlockPool, OutOfBlocks

# one bump per fused map call / full-map retranslation / allocator
# re-push
XLATE_CALLS = COUNTERS.cell("kvm.xlate_calls")
FULL_TABLE_CALLS = COUNTERS.cell("kvm.full_table_calls")
ALLOC_SYNCS = COUNTERS.cell("kvm.alloc_syncs")

# a retirement chain retires at most this many consecutive
# schedule-failed replacement candidates; the last one is kept
# regardless, so no cascade can stall a boundary
_MAX_REDRIVE = 4


def _ji(xs) -> List[int]:
    """Journal payloads are JSON: plain ints."""
    return [int(x) for x in xs]


@dataclasses.dataclass
class MapStats:
    """Typed ``KVPageManager.hit_stats()`` result: the reference's map,
    tier, fault and write counters that the port maintains."""
    hits: int = 0
    misses: int = 0
    fills: int = 0
    updates: int = 0
    swaps_out: int = 0
    swaps_in: int = 0
    host_resident_slots: int = 0
    retired_blocks: int = 0
    retired_ch: List[int] = dataclasses.field(default_factory=list)
    pool_exhausted: List[int] = dataclasses.field(default_factory=list)
    swap_faults: int = 0
    program_faults: int = 0
    alloc_faults: int = 0
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
                 faults: Optional["flt.FaultPlane"] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_pages = max_pages
        self._n_dev = n_device_blocks
        self._n_host = n_host_blocks
        self.channels = int(channels)
        self.geom = _geometry(n_slots, max_pages, self.channels)
        # lanes each channel serviced (routed map lanes): the 1/C
        # translate-work split is read from these, not inferred
        self.channel_lanes = np.zeros(self.channels, np.int64)
        self.reset(faults)

    def reset(self, faults: Optional["flt.FaultPlane"] = None):
        """Fresh map state, pool and bookkeeping on the same geometry,
        with ``faults`` as the fault plane. Detaches the journal (the
        engine re-attaches it after a recovery)."""
        if self.channels > 1:
            self.state = fb.init_sharded_state(
                self.geom, self.channels, self._n_dev, self._n_host,
                n_lanes=self.n_slots, device=self.device)
        else:
            self.state = fb.init_serving_state(
                self.geom, self._n_dev, n_lanes=self.n_slots,
                n_host_blocks=self._n_host, device=self.device)
        self.pool = BlockPool(self._n_dev, self._n_host,
                              n_channels=self.channels)
        self.channel_lanes[:] = 0
        self.seq_pages: Dict[int, List[int]] = {}   # slot -> block ids
        # host-tier page count per slot, kept by the swaps so the
        # residency predicate is O(1)
        self._host_pages: Dict[int, int] = {}
        self.host_writes = 0
        # the device stacks are stale after a host-side pool mutation
        self._alloc_dirty = False
        # consulted at the host commit points only, never on the device
        self.faults = faults
        self.journal: Optional["jl.Journal"] = None

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

    def _relocate(self, dlpns, news, olds, pools=(), block_axis: int = 0,
                  rows: Optional[Tuple[Sequence[int], Sequence[int]]] = None
                  ) -> torch.Tensor:
        """One relocation: a map commit of COND_UPDATE lanes dlpn: old ->
        new (each lands only where the map still points at the old
        block), then in each of ``pools`` the rows ``rows`` = (src, dst)
        move in place along ``block_axis`` (default: the block ids
        themselves, device-tier rows). Shared by the swaps and bad-block
        retirement. The lanes go to the device in one staged copy;
        nothing comes back. Returns the guard mask ``ok`` (on the
        device)."""
        XLATE_CALLS[0] += 1
        self._count_lanes(dlpns)
        src, dst = rows if rows is not None else (olds, news)
        dl_t, new_t, old_t, src_t, dst_t = self._lanes(dlpns, news, olds,
                                                       src, dst)
        _, ok = self._commit(torch.full_like(dl_t, COND_UPDATE), dl_t,
                             new_t, old_t)
        src_t, dst_t = src_t.long(), dst_t.long()
        for p in pools:        # source and destination rows are disjoint
            p.index_copy_(block_axis, dst_t, p.index_select(block_axis,
                                                            src_t))
        return ok

    def _alloc_blocks(self, dlpns: Sequence[int], *,
                      host: bool = False) -> List[int]:
        """Pool allocation for a batch of dlpns: channel-free pops at one
        channel, per owner channel otherwise (a page and its block share
        a channel, so each channel's device stack mirror stays exact).
        With a fault plane, each call consults its alloc axis first: a
        hit raises a transient ``OutOfBlocks`` before any pop, so a
        retry sees an untouched pool."""
        if self.faults is not None and len(dlpns) \
                and self.faults.alloc_fails():
            c = int(dlpns[0]) % self.channels
            self.pool.note_exhausted(c)
            raise OutOfBlocks(
                f"injected transient {'host' if host else 'device'} "
                f"allocator exhaustion ({len(dlpns)} blocks)",
                channel=c, transient=True)
        if self.channels == 1:
            return self.pool.alloc(len(dlpns), host=host)
        return self.pool.alloc_for(
            [int(d) % self.channels for d in dlpns], host=host)

    # ----------------------------------------------------------- API
    def new_seq(self, slot: int, n_pages: int) -> List[int]:
        """Admit a sequence into `slot` with `n_pages` logical pages.
        With a fault plane the fresh blocks' programs are checked after
        the map commit and before prefill writes them: a bad one is
        relocated map-only."""
        assert slot not in self.seq_pages, f"slot {slot} busy"
        dl = self._dlpns(slot, n_pages)
        blocks = self._alloc_blocks(dl)
        self.host_writes += len(blocks)
        self._alloc_dirty = True
        self._xlate(UPDATE, dl, blocks)
        self.seq_pages[slot] = list(blocks)
        if self.journal is not None:
            self.journal.append(
                jl.NEW_SEQ, {"slot": int(slot), "dl": _ji(dl),
                             "blocks": _ji(blocks)},
                programmed=zip(dl, blocks))
        self._maybe_retire_programs(dl, blocks)
        return list(self.seq_pages[slot])

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
        if self.journal is not None:
            self.journal.append(
                jl.EXTEND, {"dl": _ji(dl), "blocks": _ji(blocks)},
                programmed=zip(dl, blocks))
        # the decode step that follows programs these blocks, so a
        # failed program re-drives map-only
        if self._maybe_retire_programs(dl, blocks):
            got = {s: self.seq_pages[s][-n:] for s, n in wants.items()}
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
        if self.journal is not None:
            # no OOB frame: a free programs nothing
            self.journal.append(jl.FREE,
                                {"slot": int(slot), "blocks": _ji(blocks),
                                 "lanes": len(blocks)})

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
        dl: List[int] = []
        for slot, b in zip(grow_seq, blocks):
            self.seq_pages[slot].append(b)
            dl.append(slot * self.max_pages + len(self.seq_pages[slot]) - 1)
            got.setdefault(slot, []).append(b)
        if self.journal is not None:
            # the run committed these lanes on the device; this record
            # is their durability point
            self.journal.append(
                jl.RECONCILE, {"grow_seq": _ji(grow_seq), "dl": _ji(dl),
                               "blocks": _ji(blocks)},
                programmed=zip(dl, blocks))
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
        lists. Raises OutOfBlocks before any pop or map write. The run
        programs the blocks after this, so a failed program re-drives
        map-only. Returns {slot: [new blocks]} in page order."""
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
        counts: Dict[int, int] = {}
        for slot, b in zip(grow_seq, blocks):
            self.seq_pages[slot].append(b)
            got.setdefault(slot, []).append(b)
            counts[slot] = counts.get(slot, 0) + 1
        self._xlate(UPDATE, dl, blocks)
        if self.journal is not None:
            self.journal.append(
                jl.PRECOMMIT, {"grow_seq": _ji(grow_seq), "dl": _ji(dl),
                               "blocks": _ji(blocks)},
                programmed=zip(dl, blocks))
        if self._maybe_retire_programs(dl, blocks):
            got = {s: self.seq_pages[s][-n:] for s, n in counts.items()}
        return got

    # ------------------------------------------------ bad-block retirement
    def _maybe_retire_programs(self, dl, blocks) -> int:
        """Consult the fault plane once per freshly programmed device
        block, in allocation order, and retire the failed ones map-only
        (callers run this before the data is written). Returns the
        number relocated."""
        f = self.faults
        if f is None:
            return 0
        bad = [(int(d), int(b)) for d, b in zip(dl, blocks)
               if not BlockPool.is_host(int(b)) and f.program_fails()]
        if not bad:
            return 0
        return self.retire_bad_blocks(bad)

    def retire_bad_blocks(self, bad: List[Tuple[int, int]], pools=(),
                          block_axis: int = 0) -> int:
        """Bad-block retirement: for each (dlpn, block) whose program
        failed, pop a replacement from the same channel, move the mapping
        with one COND_UPDATE map commit for the whole batch (a program
        failure is one more relocation) and retire the bad block for
        good. With ``pools`` the relocation also moves the rows old ->
        new in place (data already written, as by a K-step run); without,
        only the map moves. A replacement's program consults the plane
        again: a chain retires up to ``_MAX_REDRIVE`` bad candidates. A
        dry channel defers the retirement (the old block serves on).
        Returns the number of pages relocated."""
        f = self.faults
        done: List[Tuple[int, int, int]] = []    # (dlpn, old, new)
        popped: List[int] = []      # every replacement candidate popped
        retired: List[int] = []     # every block retired
        for dlpn, old in bad:
            assert not BlockPool.is_host(old), \
                "program faults model device-tier block programs"
            c = self.pool.channel_of(old)
            chain = [old]
            new = None
            for i in range(_MAX_REDRIVE):
                try:
                    cand = self.pool.alloc_for([c])[0]
                except OutOfBlocks:
                    break
                popped.append(cand)
                chain.append(cand)
                if f is None or i == _MAX_REDRIVE - 1 \
                        or not f.program_fails():
                    new = cand
                    break
            if new is None:
                # dry channel: the old block serves on; candidates popped
                # before it ran dry failed their programs and retire
                dead = chain[1:]
                if dead:
                    self.pool.retire(dead)
                    retired.extend(dead)
                continue
            dead = [b for b in chain if b != new]
            self.pool.retire(dead)
            retired.extend(dead)
            done.append((dlpn, old, new))
        if popped:
            self._alloc_dirty = True
        if done:
            self._relocate([d for d, _, _ in done], [n for _, _, n in done],
                           [o for _, o, _ in done], pools, block_axis)
            for d, o, n in done:
                pages = self.seq_pages[d // self.max_pages]
                pages[pages.index(o)] = n
        if self.journal is not None and (done or popped):
            touched = sorted({d // self.max_pages for d, _, _ in done})
            self.journal.append(
                jl.RETIRE,
                {"done": [[int(d), int(o), int(n)] for d, o, n in done],
                 "popped": _ji(popped), "retired": _ji(retired),
                 "pages": {int(s): _ji(self.seq_pages[s])
                           for s in touched},
                 "lanes": len(done)},
                programmed=[(d, n) for d, _, n in done],
                retired=retired)
        return len(done)

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
        one relocation (``_relocate``: every lane a COND_UPDATE from the
        moving block to a fresh block of the other tier, and the pool
        rows) and the slot's residency flip, all in place. Only
        ``check=True`` reads anything back (the guard mask). An injected
        ``SwapFault`` raises before any change. Returns the number of
        pages moved."""
        blocks = self.seq_pages[slot]
        moving = [b for b in blocks if BlockPool.is_host(b) != out]
        if not moving:
            return 0
        if self.faults is not None and self.faults.swap_fails():
            raise flt.SwapFault(slot, SWAP_OUT if out else SWAP_IN,
                                len(moving))
        dl = [slot * self.max_pages + i for i, b in enumerate(blocks)
              if BlockPool.is_host(b) != out]
        fresh = self._alloc_blocks(dl, host=out)
        self._alloc_dirty = True
        row = self.pool.host_row
        src = [b if out else row(b) for b in moving]
        dst = [row(b) if out else b for b in fresh]
        ok = self._relocate(dl, fresh, moving, pools, block_axis,
                            rows=(src, dst))
        fb.mark_swap_(self.state, slot, out)    # every channel's copy
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
        if self.journal is not None:
            # the swap's commit point: a whole OOB frame (dl -> fresh)
            # lets the scan re-apply the move; a torn one drops it
            self.journal.append(
                jl.SWAP,
                {"slot": int(slot), "out": bool(out), "moving": _ji(moving),
                 "fresh": _ji(fresh), "pages": _ji(self.seq_pages[slot]),
                 "hp": int(self._host_pages[slot])},
                programmed=zip(dl, fresh))
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

    # -------------------------------------------------- crash consistency
    def journal_cfg(self) -> dict:
        """Geometry stamped into every snapshot: recovery refuses to
        restore into a manager of another shape."""
        return {"channels": self.channels, "n_device": self._n_dev,
                "n_host": self._n_host, "max_pages": self.max_pages,
                "n_slots": self.n_slots}

    def snapshot_state(self) -> dict:
        """The manager's share of a journal snapshot, in the reference's
        layout: page lists, host-page counts and the pool allocator's
        whole state (free-list order included). Host data only: the
        device map is a function of it (``restore_mapping``)."""
        d = {"cfg": self.journal_cfg(),
             "seq_pages": {int(s): _ji(p)
                           for s, p in self.seq_pages.items()},
             "host_pages": {int(s): int(n)
                            for s, n in self._host_pages.items()}}
        d.update(self.pool.state_dict())
        return d

    def restore_mapping(self, rec: "jl.Recovered") -> int:
        """Rebuild this (freshly reset) manager from recovered host
        truth: the pool and page lists, then the whole device map with
        ONE batched UPDATE commit of every mapped page (one
        ``fmmu_commit`` launch) and one allocator re-push. The table,
        free stacks and residency lanes come back as they were before the
        crash; the CMT refills warm. Returns the pages re-committed."""
        cfg = self.journal_cfg()
        assert rec.cfg == cfg, f"snapshot geometry {rec.cfg} != {cfg}"
        self.pool.load_state({
            "free_dev_ch": rec.free_dev_ch,
            "free_host_ch": rec.free_host_ch,
            "rr": rec.rr, "retired": sorted(rec.retired),
            "retired_ch": rec.retired_ch,
            "exhausted_ch": rec.exhausted_ch, "stats": rec.stats})
        self.seq_pages = {int(s): _ji(p)
                          for s, p in rec.seq_pages.items()}
        self._host_pages = {int(s): int(n)
                            for s, n in rec.host_pages.items()}
        dl: List[int] = []
        blocks: List[int] = []
        for s in sorted(self.seq_pages):
            for i, b in enumerate(self.seq_pages[s]):
                dl.append(s * self.max_pages + i)
                blocks.append(b)
        if dl:
            self._xlate(UPDATE, dl, blocks)
        self._alloc_dirty = True
        self.sync_allocator()    # stacks + residency lanes in one push
        return len(dl)

    def hit_stats(self) -> MapStats:
        """Map, tier and fault counters (a device->host read:
        diagnostics, not the hot path). A swap-in programs every page it
        brings back, so it counts as flash programs beside the host's
        writes; retirement re-drives do not (fault recovery, not
        amplification)."""
        s = self.state.fmmu.stats.cpu()
        if self.channels > 1:
            s = s.sum(0, dtype=torch.int32)
        s = s.tolist()
        flash = self.host_writes + self.pool.stats.swaps_in
        fired = self.faults.counts() if self.faults is not None else {}
        return MapStats(
            hits=s[0], misses=s[1], fills=s[2], updates=s[3],
            swaps_out=self.pool.stats.swaps_out,
            swaps_in=self.pool.stats.swaps_in,
            host_resident_slots=sum(1 for c in self._host_pages.values()
                                    if c > 0),
            retired_blocks=self.pool.stats.retired,
            retired_ch=list(self.pool.retired_ch),
            pool_exhausted=list(self.pool.exhausted_ch),
            swap_faults=fired.get("swap", 0),
            program_faults=fired.get("program", 0),
            alloc_faults=fired.get("alloc", 0),
            host_writes=self.host_writes, flash_programs=flash,
            write_amp=flash / self.host_writes if self.host_writes else 1.0)


__all__ = ["KVPageManager", "MapStats", "XLATE_CALLS", "FULL_TABLE_CALLS",
           "ALLOC_SYNCS"]
