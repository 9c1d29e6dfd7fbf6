"""Simulation-level map-cache schemes: DFTL [8], CDFTL [24], FMMU: the
port's own copy of ``repro/core/ftl/mapcache.py``.

These model the *cache behaviour* (hit/miss/victim/flush decisions over
real structures) and the *execution cost* (micro-op counts x costmodel)
of each scheme, for the discrete-event SSD simulator. Architectural
correctness of FMMU itself is proven separately (oracle/engine lockstep);
here FMMU's decision logic is a direct reuse of the same CMT/CTP/DTL
policies with hardware pipeline costs.

Interface (driven by core/sim/ssd.py per page-sized sub-request):
  access(dlpn, write) -> AccessPlan(cycles, tp_read, fill_cycles,
                                    flush=FlushWork|None)
The sim owns flash timing; tp_read is the TVPN to fetch when the scheme
misses, fill_cycles the exec charged on arrival. FlushWork carries TP
read-modify-writes (reads skipped when the page is CTP-resident) and
programs to schedule.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from repro_torch.core.ftl.costmodel import HW, SW, us


@dataclasses.dataclass
class FlushWork:
    cycles: float
    tp_reads: List[int]
    tp_programs: List[int]


@dataclasses.dataclass
class AccessPlan:
    cycles: float
    tp_read: Optional[int] = None
    fill_cycles: float = 0.0
    flush: Optional[FlushWork] = None


class _SetCache:
    """Set-associative cache of fixed-size blocks with second chance.
    ``dirty_ix`` (group key -> {(s,w)}) is a host-side index so the
    *simulator* can find same-TVPN dirty blocks in O(1); the *simulated*
    software still pays the full scan in cycles (that asymmetry is the
    paper's point)."""

    def __init__(self, n_sets: int, n_ways: int, group_of=None):
        self.n_sets = n_sets
        self.n_ways = n_ways
        self.tag = [[-1] * n_ways for _ in range(n_sets)]
        self.valid = [[False] * n_ways for _ in range(n_sets)]
        self.dirty = [[False] * n_ways for _ in range(n_sets)]
        self.ref = [[False] * n_ways for _ in range(n_sets)]
        self.clock = [0] * n_sets
        self.n_dirty = 0
        self.group_of = group_of or (lambda tag: 0)
        self.dirty_ix = {}

    def _ix_add(self, s, w):
        self.dirty_ix.setdefault(self.group_of(self.tag[s][w]), set()).add((s, w))

    def _ix_del(self, s, w):
        grp = self.group_of(self.tag[s][w])
        members = self.dirty_ix.get(grp)
        if members:
            members.discard((s, w))
            if not members:
                self.dirty_ix.pop(grp, None)

    def probe(self, tag: int) -> Tuple[int, Optional[int]]:
        s = tag % self.n_sets
        for w in range(self.n_ways):
            if self.valid[s][w] and self.tag[s][w] == tag:
                return s, w
        return s, None

    def second_chance(self, s: int) -> Tuple[Optional[int], int]:
        """Returns (way or None, ways_scanned) among non-dirty blocks."""
        scanned = 0
        for i in range(2 * self.n_ways):
            w = (self.clock[s] + i) % self.n_ways
            scanned += 1
            if self.dirty[s][w]:
                continue
            if self.ref[s][w]:
                self.ref[s][w] = False
                continue
            self.clock[s] = (w + 1) % self.n_ways
            return w, scanned
        return None, scanned

    def any_victim(self, s: int) -> Tuple[int, int]:
        """Victim allowing dirty blocks (clean preferred: FMMU fallback)."""
        w, scanned = self.second_chance(s)
        if w is not None:
            return w, scanned
        # all dirty: plain clock over dirty blocks
        w = self.clock[s]
        self.clock[s] = (w + 1) % self.n_ways
        return w, scanned + 1

    def clock_victim(self, s: int) -> Tuple[int, int]:
        """Classic second chance over ALL blocks, dirty or not — the
        DFTL/CDFTL policy (the paper's FMMU §4.4 twist is precisely that
        it restricts victims to non-dirty blocks; baselines do not)."""
        scanned = 0
        for i in range(2 * self.n_ways):
            w = (self.clock[s] + i) % self.n_ways
            scanned += 1
            if self.ref[s][w]:
                self.ref[s][w] = False
                continue
            self.clock[s] = (w + 1) % self.n_ways
            return w, scanned
        w = self.clock[s]
        self.clock[s] = (w + 1) % self.n_ways
        return w, scanned

    def install(self, s: int, w: int, tag: int, dirty: bool):
        if self.dirty[s][w]:
            self.n_dirty -= 1
            self._ix_del(s, w)
        self.tag[s][w] = tag
        self.valid[s][w] = True
        self.ref[s][w] = True
        self.dirty[s][w] = dirty
        if dirty:
            self.n_dirty += 1
            self._ix_add(s, w)

    def set_dirty(self, s: int, w: int):
        if not self.dirty[s][w]:
            self.dirty[s][w] = True
            self.n_dirty += 1
            self._ix_add(s, w)

    def clean(self, s: int, w: int):
        if self.dirty[s][w]:
            self._ix_del(s, w)
            self.dirty[s][w] = False
            self.n_dirty -= 1

    @property
    def blocks(self) -> int:
        return self.n_sets * self.n_ways


class BaseMapCache:
    name = "base"

    def __init__(self, cfg):
        self.cfg = cfg
        self.ec = cfg.cmt_block_entries
        self.ept = cfg.entries_per_tp
        self.stats = {"hit": 0, "miss": 0, "flushes": 0, "tp_reads": 0,
                      "tp_programs": 0, "exec_cycles": 0.0}

    def _done(self, plan: AccessPlan) -> AccessPlan:
        self.stats["exec_cycles"] += plan.cycles + plan.fill_cycles
        if plan.tp_read is not None:
            self.stats["tp_reads"] += 1
        if plan.flush:
            self.stats["tp_programs"] += len(plan.flush.tp_programs)
            self.stats["tp_reads"] += len(plan.flush.tp_reads)
            self.stats["exec_cycles"] += plan.flush.cycles
        return plan


# ======================================================================
class DFTLCache(BaseMapCache):
    """Single-level CMT over all map RAM; batch flush scans the WHOLE
    cache for same-TVPN dirty blocks (no index — the paper's complaint)."""
    name = "dftl"

    def __init__(self, cfg):
        super().__init__(cfg)
        blocks = cfg.map_ram_bytes // (self.ec * cfg.map_entry_bytes)
        bpt = self.ept // self.ec
        self.cmt = _SetCache(blocks // cfg.assoc, cfg.assoc,
                             group_of=lambda t: t // bpt)

    def access(self, dlpn: int, write: bool) -> AccessPlan:
        tag = dlpn // self.ec
        s, w = self.cmt.probe(tag)
        if w is not None:
            self.stats["hit"] += 1
            self.cmt.ref[s][w] = True
            if write:
                self.cmt.set_dirty(s, w)
            cycles = (SW.dispatch + SW.probe_way * self.cmt.n_ways
                      + SW.entry_rw + SW.lru)
            return self._done(AccessPlan(cycles))
        # miss
        self.stats["miss"] += 1
        vic, scanned = self.cmt.clock_victim(s)
        cycles = (SW.dispatch + SW.probe_way * self.cmt.n_ways
                  + SW.sc_pass * scanned + SW.miss_book + SW.issue)
        flush = None
        if self.cmt.dirty[s][vic]:
            flush = self._flush_tvpn(self.cmt.tag[s][vic] * self.ec
                                     // self.ept)
        self.cmt.install(s, vic, tag, dirty=write)
        fill = SW.fill_entry * self.ec + SW.fill_book + SW.lru
        return self._done(AccessPlan(cycles, tp_read=dlpn // self.ept,
                                     fill_cycles=fill, flush=flush))

    def _flush_tvpn(self, tvpn: int) -> FlushWork:
        """Batch update: scan every cache block for dirty blocks of this
        TVPN (cost O(total blocks)), then RMW the translation page."""
        self.stats["flushes"] += 1
        members = list(self.cmt.dirty_ix.get(tvpn, ()))
        for (s, w) in members:
            self.cmt.clean(s, w)
        # software has no index: charge the full O(cache) scan
        cycles = (SW.flush_scan_blk * self.cmt.blocks
                  + SW.flush_blk * len(members) + SW.tp_rmw + SW.issue)
        return FlushWork(cycles, tp_reads=[tvpn], tp_programs=[tvpn])


# ======================================================================
class CDFTLCache(BaseMapCache):
    """Two-level: small CMT + translation-page-sized CTP [24]."""
    name = "cdftl"

    def __init__(self, cfg):
        super().__init__(cfg)
        cmt_blocks = cfg.cmt_ram_bytes // (self.ec * cfg.map_entry_bytes)
        ctp_pages = cfg.ctp_ram_bytes // (self.ept * cfg.map_entry_bytes)
        bpt = self.ept // self.ec
        self.cmt = _SetCache(cmt_blocks // cfg.assoc, cfg.assoc,
                             group_of=lambda t: t // bpt)
        self.ctp = _SetCache(max(1, ctp_pages // cfg.assoc), cfg.assoc)

    def access(self, dlpn: int, write: bool) -> AccessPlan:
        tag = dlpn // self.ec
        s, w = self.cmt.probe(tag)
        if w is not None:
            self.stats["hit"] += 1
            self.cmt.ref[s][w] = True
            if write:
                self.cmt.set_dirty(s, w)
            cycles = (SW.dispatch + SW.probe_way * self.cmt.n_ways
                      + SW.entry_rw + SW.lru)
            return self._done(AccessPlan(cycles))
        self.stats["miss"] += 1
        cycles = SW.dispatch + SW.probe_way * self.cmt.n_ways + SW.l2_book
        flush = None
        vic, scanned = self.cmt.clock_victim(s)
        if self.cmt.dirty[s][vic]:
            flush = self._flush_cmt(self.cmt.tag[s][vic] * self.ec
                                    // self.ept)
        cycles += SW.sc_pass * scanned + SW.lru
        # second level
        tvpn = dlpn // self.ept
        ts, tw = self.ctp.probe(tvpn)
        if tw is not None:
            # CTP hit: copy entries up into CMT
            self.ctp.ref[ts][tw] = True
            self.cmt.install(s, vic, tag, dirty=write)
            cycles += (SW.probe_way * self.ctp.n_ways
                       + SW.fill_entry * self.ec + SW.fill_book)
            return self._done(AccessPlan(cycles))
        # CTP miss: evict a CTP page (program if dirty), read TP from flash
        tvic, tsc = self.ctp.any_victim(ts)
        cycles += (SW.probe_way * self.ctp.n_ways + SW.sc_pass * tsc
                   + SW.miss_book + SW.issue)
        if flush is None and self.ctp.dirty[ts][tvic]:
            self.stats["flushes"] += 1
            flush = FlushWork(SW.tp_rmw + SW.issue, tp_reads=[],
                              tp_programs=[self.ctp.tag[ts][tvic]])
        self.ctp.install(ts, tvic, tvpn, dirty=False)
        self.cmt.install(s, vic, tag, dirty=write)
        fill = SW.fill_entry * self.ec + SW.fill_book
        return self._done(AccessPlan(cycles, tp_read=tvpn, fill_cycles=fill,
                                     flush=flush))

    def _flush_cmt(self, tvpn: int) -> FlushWork:
        """Scan whole CMT for dirty blocks of tvpn; merge into CTP page
        (present or loaded); program later on CTP eviction."""
        self.stats["flushes"] += 1
        members = list(self.cmt.dirty_ix.get(tvpn, ()))
        n = len(members)
        for (s, w) in members:
            self.cmt.clean(s, w)
        reads = []
        ts, tw = self.ctp.probe(tvpn)
        if tw is None:
            tvic, _ = self.ctp.any_victim(ts)
            progs = ([self.ctp.tag[ts][tvic]]
                     if self.ctp.dirty[ts][tvic] else [])
            self.ctp.install(ts, tvic, tvpn, dirty=True)
            reads = [tvpn]
        else:
            progs = []
            self.ctp.set_dirty(ts, tw)
        cycles = (SW.flush_scan_blk * self.cmt.blocks + SW.flush_blk * n
                  + SW.tp_rmw)
        return FlushWork(cycles, tp_reads=reads, tp_programs=progs)


# ======================================================================
class FMMUCache(BaseMapCache):
    """FMMU decision logic (CMT+CTP+DTL, watermark flush, next-links)
    with hardware pipeline costs. Non-blocking behaviour (MSHR merging)
    is realized by the simulator's shared in-flight TP reads; merged
    requesters are charged HW.mshr_log only."""
    name = "fmmu"

    def __init__(self, cfg):
        super().__init__(cfg)
        cmt_blocks = cfg.cmt_ram_bytes // (self.ec * cfg.map_entry_bytes)
        ctp_pages = cfg.ctp_ram_bytes // (self.ept * cfg.map_entry_bytes)
        self.cmt = _SetCache(cmt_blocks // cfg.assoc, cfg.assoc)
        self.ctp = _SetCache(max(1, ctp_pages // cfg.assoc), cfg.assoc)
        # DTL: tvpn -> set of (s,w) dirty blocks (the next-link chains)
        self.dtl: "OrderedDict[int, set]" = OrderedDict()
        self.low = max(1, int(cfg.flush_low_watermark * self.cmt.blocks))
        self.high = max(self.low + 1,
                        int(cfg.flush_high_watermark * self.cmt.blocks))

    def access(self, dlpn: int, write: bool) -> AccessPlan:
        tag = dlpn // self.ec
        s, w = self.cmt.probe(tag)
        flush = self._maybe_flush()
        if w is not None:
            self.stats["hit"] += 1
            self.cmt.ref[s][w] = True
            if write and not self.cmt.dirty[s][w]:
                self.cmt.set_dirty(s, w)
                self._dtl_add(dlpn // self.ept, s, w)
            return self._done(AccessPlan(HW.cmt_packet, flush=flush))
        self.stats["miss"] += 1
        vic, _ = self.cmt.second_chance(s)
        if vic is None:
            fw = self._flush_tvpn_of_set(s)
            if flush is None:
                flush = fw
            elif fw:
                flush.cycles += fw.cycles
                flush.tp_reads += fw.tp_reads
                flush.tp_programs += fw.tp_programs
            vic, _ = self.cmt.second_chance(s)
            if vic is None:
                vic, _ = self.cmt.any_victim(s)
        tvpn = dlpn // self.ept
        ts, tw = self.ctp.probe(tvpn)
        if tw is not None:
            self.ctp.ref[ts][tw] = True
            self.cmt.install(s, vic, tag, dirty=write)
            if write:
                self._dtl_add(tvpn, s, vic)
            return self._done(AccessPlan(HW.cmt_packet + HW.ctp_packet,
                                         flush=flush))
        tvic, _ = self.ctp.any_victim(ts)
        progs = []
        if self.ctp.dirty[ts][tvic]:
            progs = [self.ctp.tag[ts][tvic]]
            self.stats["flushes"] += 1
        self.ctp.install(ts, tvic, tvpn, dirty=False)
        self.cmt.install(s, vic, tag, dirty=write)
        if write:
            self._dtl_add(tvpn, s, vic)
        if progs:
            pf = FlushWork(HW.fc_issue, [], progs)
            if flush is None:
                flush = pf
            else:
                flush.cycles += pf.cycles
                flush.tp_programs += progs
        return self._done(AccessPlan(
            HW.cmt_packet + HW.ctp_packet + HW.fc_issue,
            tp_read=tvpn, fill_cycles=HW.ctp_packet + HW.cmt_packet,
            flush=flush))

    def merged_cycles(self) -> float:
        """Cost charged to a request that merges into an in-flight miss."""
        return HW.cmt_packet + HW.mshr_log

    # ----------------------------------------------------------------
    def _dtl_add(self, tvpn: int, s: int, w: int):
        self.dtl.setdefault(tvpn, set()).add((s, w))

    def _maybe_flush(self) -> Optional[FlushWork]:
        nondirty = self.cmt.blocks - self.cmt.n_dirty
        if nondirty >= self.low or not self.dtl:
            return None
        work = FlushWork(0.0, [], [])
        while (self.cmt.blocks - self.cmt.n_dirty) < self.high and self.dtl:
            tvpn = max(self.dtl, key=lambda t: len(self.dtl[t]))  # greedy
            w2 = self._flush_chain(tvpn)
            work.cycles += w2.cycles
            work.tp_reads += w2.tp_reads
            work.tp_programs += w2.tp_programs
        self.stats["flushes"] += 1
        return work

    def _flush_tvpn_of_set(self, s: int) -> Optional[FlushWork]:
        for w in range(self.cmt.n_ways):
            if self.cmt.dirty[s][w]:
                tvpn = self.cmt.tag[s][w] * self.ec // self.ept
                if tvpn in self.dtl:
                    return self._flush_chain(tvpn)
        return None

    def _flush_chain(self, tvpn: int) -> FlushWork:
        """Walk next-links: O(dirty blocks of tvpn), not O(cache)."""
        chain = self.dtl.pop(tvpn, set())
        n = 0
        for (s, w) in chain:
            if self.cmt.dirty[s][w]:
                self.cmt.clean(s, w)
                n += 1
        cycles = HW.flush_base + HW.flush_blk * n
        # merge into CTP (load if absent — hardware RMW), mark dirty;
        # the program happens on CTP eviction or watermark
        ts, tw = self.ctp.probe(tvpn)
        reads: List[int] = []
        progs: List[int] = []
        if tw is None:
            tvic, _ = self.ctp.any_victim(ts)
            if self.ctp.dirty[ts][tvic]:
                progs = [self.ctp.tag[ts][tvic]]
            self.ctp.install(ts, tvic, tvpn, dirty=True)
            reads = [tvpn]
        else:
            self.ctp.set_dirty(ts, tw)
        return FlushWork(cycles, reads, progs)


SCHEMES = {"dftl": DFTLCache, "cdftl": CDFTLCache, "fmmu": FMMUCache}
