"""Readable Python reference of the FMMU state machine (§4 of the paper):
the port's own copy of ``repro/core/fmmu/oracle.py``.

This is the executable spec: two-level cache (CMT/CTP), in-cache MSHRs,
DTL next-link batch flush, second-chance replacement among non-dirty
blocks, low/high-watermark flushing interleaved with request service,
weighted-round-robin arbitration, GTD, and CondUpdate semantics.

Flash is modeled functionally (``flash_tp`` array + bump allocator);
timing is added by core/sim. Flash read *responses* are delivered by the
host (possibly out of order / delayed) — that asynchrony is what the
MSHRs absorb, and tests exercise it.

The port's packet engine (engine.py: the plain torch step and the CUDA
``fmmu_fsm`` kernel) mirrors this machine exactly; the tests drive both
in lockstep and assert identical responses, flash-op sequences, and
architectural state under random traces and delivery orders.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.core.fmmu.types import (
    COND_UPDATE, FC_READ, FC_READ_RESP, FLUSH_BLK, FMMUGeometry, LOAD,
    LOAD_RESP, LOOKUP, M_COND, M_FLUSH, M_LOAD, M_LOOKUP, M_UPDATE, NIL,
    PROGRAM, RESP, Request, Response, ST_OK, ST_STALE, UPDATE)

# queue ids (arbitration order; index into wrr_weights)
Q_FC_RESP, Q_CTP_RESP, Q_CTP_REQ, Q_HRM, Q_GCM = range(5)


class _Block:
    __slots__ = ("tag", "valid", "dirty", "transient", "refbit", "next",
                 "data", "mshrs")

    def __init__(self, entries: int):
        self.tag = NIL
        self.valid = False
        self.dirty = False
        self.transient = False
        self.refbit = False
        self.next = NIL          # packed (set*W+way) link for DTL chains
        self.data = [NIL] * entries
        self.mshrs: List[tuple] = []


class FMMUOracle:
    def __init__(self, geom: FMMUGeometry):
        self.g = geom
        g = geom
        self.cmt = [[_Block(g.cmt_entries) for _ in range(g.cmt_ways)]
                    for _ in range(g.cmt_sets)]
        self.ctp = [[_Block(g.entries_per_tp) for _ in range(g.ctp_ways)]
                    for _ in range(g.ctp_sets)]
        self.cmt_clock = [0] * g.cmt_sets
        self.ctp_clock = [0] * g.ctp_sets
        self.gtd = [NIL] * g.n_tvpns
        self.flash_tp: Dict[int, List[int]] = {}
        self.tppn_next = 0
        # DTL: ordered list of dicts {tvpn, head, ndirty, updated}
        self.dtl: List[dict] = []
        self.ctp_fifo: deque = deque()       # tvpns in CMT-flush order
        self.queues = [deque() for _ in range(5)]
        self.credits = list(g.wrr_weights)
        self.out_resps: List[Response] = []
        self.out_fc_reads: List[tuple] = []  # (tppn, ctp_set, ctp_way)
        self.out_programs: List[tuple] = []  # (tvpn, new_tppn)
        self.cmt_dirty = 0
        self.ctp_dirty = 0
        self._stalls_in_row = 0
        # counters
        self.stats = {"hit": 0, "miss": 0, "mshr_merge": 0, "stall": 0,
                      "flush_tvpns": 0, "flush_blocks": 0, "fc_reads": 0,
                      "programs": 0, "steps": 0, "ctp_hit": 0, "ctp_miss": 0}

    # ------------------------------------------------------------- util
    def _pack(self, s: int, w: int) -> int:
        return s * self.g.cmt_ways + w

    def _unpack(self, p: int) -> Tuple[int, int]:
        return p // self.g.cmt_ways, p % self.g.cmt_ways

    # ---------------------------------------------------------- host API
    def push_request(self, r: Request):
        q = Q_GCM if r.src else Q_HRM
        self.queues[q].append(("req", r))

    def push_flash_response(self, tppn: int, ctp_set: int, ctp_way: int):
        self.queues[Q_FC_RESP].append(("fc", (tppn, ctp_set, ctp_way)))

    def pending_work(self) -> bool:
        return any(self.queues)

    def drain_outputs(self):
        r, f, p = self.out_resps, self.out_fc_reads, self.out_programs
        self.out_resps, self.out_fc_reads, self.out_programs = [], [], []
        return r, f, p

    # ---------------------------------------------------------- main loop
    WORKED, IDLE, BLOCKED = 0, 1, 2

    def step(self) -> int:
        """One arbitration round. Returns WORKED / IDLE (no queued work)
        / BLOCKED (all queued packets stalled on in-flight flash fills)."""
        self.stats["steps"] += 1
        # watermark work takes precedence (paper §4.5: alternate flush/serve)
        if self._ctp_writeback_needed() and self._ctp_writeback_one():
            return self.WORKED
        if self._cmt_flush_needed() and self._cmt_flush_one():
            return self.WORKED
        qid = self._arbitrate()
        if qid is None:
            return self.IDLE
        # quiescence guard: every queued packet re-stalled in a row means
        # nothing can advance until the host delivers flash responses.
        if self._stalls_in_row > sum(len(q) for q in self.queues) + 4:
            self._stalls_in_row = 0
            return self.BLOCKED
        before = self._stalls_in_row
        kind, payload = self.queues[qid].popleft()
        if kind == "fc":
            self._ctp_fill(*payload)
        elif qid == Q_CTP_RESP:
            self._cmt_fill(payload)
        elif qid == Q_CTP_REQ:
            self._ctp_handle(payload)
        else:
            self._cmt_handle(payload, qid)
        if self._stalls_in_row == before:      # handler made progress
            self._stalls_in_row = 0
        return self.WORKED

    def run(self, max_steps: int = 1_000_000, auto_flash: bool = False) -> int:
        """Process until quiescent or blocked on the host. With
        auto_flash, flash-read responses are self-delivered immediately
        (zero-latency flash)."""
        n = 0
        while n < max_steps:
            code = self.step()
            n += 1
            if code == self.WORKED:
                continue
            if auto_flash and self.out_fc_reads:
                reads, self.out_fc_reads = self.out_fc_reads, []
                for tppn, s, w in reads:
                    self.push_flash_response(tppn, s, w)
                continue
            break  # IDLE or BLOCKED with nothing the engine can do
        return n

    def flush_all(self, max_steps: int = 100000) -> int:
        """Force-flush every dirty block (shutdown / checkpoint path).
        Self-serves flash reads (read-modify-write of translation pages)."""
        n = 0
        while n < max_steps and (self.dtl or self.ctp_fifo
                                 or self.pending_work()):
            if self.dtl:
                self._cmt_flush_one(force=True)
            n += self.run(max_steps - n, auto_flash=True)
            while self.ctp_fifo and n < max_steps:
                self._ctp_writeback_one(force=True)
                n += 1
            n += self.run(max_steps - n, auto_flash=True)
        return n

    def _arbitrate(self) -> Optional[int]:
        nonempty = [q for q in range(5) if self.queues[q]]
        if not nonempty:
            return None
        if all(self.credits[q] <= 0 for q in nonempty):
            self.credits = list(self.g.wrr_weights)
        for q in nonempty:
            if self.credits[q] > 0:
                self.credits[q] -= 1
                return q
        return None

    def set_gc_pressure(self, valid_pages_in_victim: int, pages_per_block: int):
        """Paper §4.6: HRM/GCM weights follow GC victim valid-page count."""
        frac = valid_pages_in_victim / max(pages_per_block, 1)
        w = list(self.g.wrr_weights)
        w[Q_GCM] = max(1, int(round(1 + 3 * frac)))
        w[Q_HRM] = max(1, 4 - w[Q_GCM] + 1)
        object.__setattr__(self.g, "wrr_weights", tuple(w))

    # ---------------------------------------------------------- CMT
    def _cmt_loc(self, dlpn: int) -> Tuple[int, int, int]:
        block_id = dlpn // self.g.cmt_entries
        return block_id, block_id % self.g.cmt_sets, dlpn % self.g.cmt_entries

    def _cmt_handle(self, r: Request, qid: int):
        block_id, s, off = self._cmt_loc(r.dlpn)
        ways = self.cmt[s]
        way = next((w for w in range(self.g.cmt_ways)
                    if ways[w].tag == block_id
                    and (ways[w].valid or ways[w].transient)), None)
        if way is not None and ways[way].transient:
            blk = ways[way]
            if len(blk.mshrs) >= self.g.mshr_cap:          # MSHR full: retry
                self._stall(qid, ("req", r))
                return
            self.stats["mshr_merge"] += 1
            blk.mshrs.append((self._mshr_kind(r.kind), off, r.req_id,
                              r.dppn, r.old_dppn))
            return
        if way is not None:                                 # hit
            self.stats["hit"] += 1
            blk = ways[way]
            blk.refbit = True
            self._apply_to_block(blk, s, way, r.kind, off, r.req_id,
                                 r.dppn, r.old_dppn)
            return
        # miss
        self.stats["miss"] += 1
        vic = self._second_chance(ways, self.cmt_clock, s, self.g.cmt_ways)
        if vic is None:
            # all ways dirty/transient: flush a TVPN owning a dirty block
            # in this set (paper: "not processed until a non-dirty cache
            # block is generated by the flush request"), then retry.
            self._targeted_cmt_flush(s)
            self._stall(qid, ("req", r))
            return
        blk = ways[vic]
        blk.tag = block_id
        blk.valid = False
        blk.transient = True
        blk.refbit = True
        blk.next = NIL
        blk.mshrs = [(self._mshr_kind(r.kind), off, r.req_id, r.dppn,
                      r.old_dppn)]
        tvpn = r.dlpn // self.g.entries_per_tp
        chunk = (r.dlpn % self.g.entries_per_tp) // self.g.cmt_entries
        self.queues[Q_CTP_REQ].append(
            ("ctp", (LOAD, tvpn, chunk, self._pack(s, vic), None)))

    @staticmethod
    def _mshr_kind(kind: int) -> int:
        return {LOOKUP: M_LOOKUP, UPDATE: M_UPDATE, COND_UPDATE: M_COND}[kind]

    def _apply_to_block(self, blk: _Block, s: int, w: int, kind: int,
                        off: int, req_id: int, dppn: int, old: int):
        if kind == LOOKUP:
            self.out_resps.append(Response(req_id, LOOKUP, blk.data[off], ST_OK))
            return
        if kind == COND_UPDATE and blk.data[off] != old:
            self.out_resps.append(Response(req_id, COND_UPDATE, blk.data[off],
                                           ST_STALE))
            return
        blk.data[off] = dppn
        if not blk.dirty:
            blk.dirty = True
            self.cmt_dirty += 1
            self._dtl_register(s, w, blk)
        self.out_resps.append(Response(req_id, kind, dppn, ST_OK))

    def _cmt_fill(self, payload):
        _, tvpn, chunk, dest, data = payload
        s, w = self._unpack(dest)
        blk = self.cmt[s][w]
        assert blk.transient and blk.tag == (
            tvpn * self.g.chunks_per_tp + chunk), "fill/dest mismatch"
        blk.data = list(data)
        blk.transient = False
        blk.valid = True
        mshrs, blk.mshrs = blk.mshrs, []
        for mk, off, req_id, dppn, old in mshrs:   # replay in arrival order
            kind = {M_LOOKUP: LOOKUP, M_UPDATE: UPDATE, M_COND: COND_UPDATE}[mk]
            self._apply_to_block(blk, s, w, kind, off, req_id, dppn, old)

    # ---------------------------------------------------------- DTL
    def _dtl_register(self, s: int, w: int, blk: _Block):
        tvpn = blk.tag // self.g.chunks_per_tp
        for e in self.dtl:
            if e["tvpn"] == tvpn:
                blk.next = e["head"]
                e["head"] = self._pack(s, w)
                e["ndirty"] += 1
                e["updated"] = True
                return
        if len(self.dtl) >= self.g.dtl_entries:    # full: flush oldest now
            self._flush_tvpn(self.dtl[0])
        blk.next = NIL
        self.dtl.append({"tvpn": tvpn, "head": self._pack(s, w),
                         "ndirty": 1, "updated": True})

    def _cmt_flush_needed(self) -> bool:
        nondirty = self.g.cmt_blocks - self.cmt_dirty
        return nondirty < self.g.cmt_low() and bool(self.dtl)

    def _pick_flush_victim(self) -> dict:
        # greedy cost-benefit: most dirty blocks; tie -> oldest registration
        best = max(self.dtl, key=lambda e: e["ndirty"])
        return best

    def _cmt_flush_one(self, force: bool = False) -> bool:
        if not self.dtl:
            return False
        e = self.dtl[0] if force else self._pick_flush_victim()
        self._flush_tvpn(e)
        return True

    def _flush_tvpn(self, e: dict):
        """Walk the next-link chain; emit one FLUSH_BLK per dirty block."""
        self.dtl.remove(e)
        self.stats["flush_tvpns"] += 1
        p = e["head"]
        while p != NIL:
            s, w = self._unpack(p)
            blk = self.cmt[s][w]
            nxt = blk.next
            if blk.dirty:                       # chain only holds dirty blocks
                chunk = blk.tag % self.g.chunks_per_tp
                self.queues[Q_CTP_REQ].append(
                    ("ctp", (FLUSH_BLK, e["tvpn"], chunk, NIL,
                             list(blk.data))))
                blk.dirty = False
                blk.next = NIL
                self.cmt_dirty -= 1
                self.stats["flush_blocks"] += 1
            p = nxt

    # ---------------------------------------------------------- CTP
    def _ctp_handle(self, payload):
        kind, tvpn, chunk, dest, data = payload
        s = tvpn % self.g.ctp_sets
        ways = self.ctp[s]
        way = next((w for w in range(self.g.ctp_ways)
                    if ways[w].tag == tvpn
                    and (ways[w].valid or ways[w].transient)), None)
        if way is not None and ways[way].transient:
            blk = ways[way]
            if len(blk.mshrs) >= self.g.ctp_mshr_cap:
                self._stall(Q_CTP_REQ, ("ctp", payload), front=True)
                return
            self.stats["mshr_merge"] += 1
            blk.mshrs.append((M_LOAD if kind == LOAD else M_FLUSH, chunk,
                              dest, data))
            return
        if way is not None:                     # CTP hit
            self.stats["ctp_hit"] += 1
            blk = ways[way]
            blk.refbit = True
            self._ctp_apply(blk, s, way, kind, chunk, dest, data)
            return
        self.stats["ctp_miss"] += 1
        vic = self._second_chance(ways, self.ctp_clock, s, self.g.ctp_ways)
        if vic is None:
            self._targeted_ctp_writeback(s)
            self._stall(Q_CTP_REQ, ("ctp", payload), front=True)
            return
        blk = ways[vic]
        blk.tag = tvpn
        blk.valid = False
        blk.transient = True
        blk.refbit = True
        blk.mshrs = [(M_LOAD if kind == LOAD else M_FLUSH, chunk, dest, data)]
        tppn = self.gtd[tvpn]
        if tppn == NIL:
            # never-written translation page: implicit all-unmapped
            self._ctp_fill_data(blk, s, vic, [NIL] * self.g.entries_per_tp)
        else:
            self.stats["fc_reads"] += 1
            self.out_fc_reads.append((tppn, s, vic))

    def _ctp_apply(self, blk: _Block, s: int, w: int, kind: int, chunk: int,
                   dest: int, data):
        ec = self.g.cmt_entries
        if kind == LOAD:
            sl = blk.data[chunk * ec:(chunk + 1) * ec]
            tvpn = blk.tag
            self.queues[Q_CTP_RESP].append(
                ("resp", (LOAD_RESP, tvpn, chunk, dest, list(sl))))
        else:  # FLUSH_BLK: merge one CMT block into the page
            blk.data[chunk * ec:(chunk + 1) * ec] = list(data)
            if not blk.dirty:
                blk.dirty = True
                self.ctp_dirty += 1
                if blk.tag not in self.ctp_fifo:   # dedup: <=1 entry/tvpn
                    self.ctp_fifo.append(blk.tag)  # first-dirtied order

    def _ctp_fill(self, tppn: int, s: int, w: int):
        blk = self.ctp[s][w]
        assert blk.transient, "flash response for non-transient block"
        self._ctp_fill_data(blk, s, w, list(self.flash_tp[tppn]))

    def _ctp_fill_data(self, blk: _Block, s: int, w: int, page: List[int]):
        blk.data = page
        blk.transient = False
        blk.valid = True
        mshrs, blk.mshrs = blk.mshrs, []
        for mk, chunk, dest, data in mshrs:
            self._ctp_apply(blk, s, w, LOAD if mk == M_LOAD else FLUSH_BLK,
                            chunk, dest, data)

    def _ctp_writeback_needed(self) -> bool:
        nondirty = self.g.ctp_blocks - self.ctp_dirty
        return nondirty < self.g.ctp_low() and bool(self.ctp_fifo)

    def _ctp_writeback_one(self, force: bool = False) -> bool:
        while self.ctp_fifo:
            tvpn = self.ctp_fifo.popleft()
            s = tvpn % self.g.ctp_sets
            way = next((w for w in range(self.g.ctp_ways)
                        if self.ctp[s][w].tag == tvpn
                        and self.ctp[s][w].valid and self.ctp[s][w].dirty),
                       None)
            if way is None:
                continue                        # already cleaned elsewhere
            blk = self.ctp[s][way]
            tppn = self.tppn_next
            self.tppn_next += 1
            assert self.tppn_next < self.g.tppn_cap, "translation space full"
            self.flash_tp[tppn] = list(blk.data)
            self.gtd[tvpn] = tppn
            blk.dirty = False
            self.ctp_dirty -= 1
            self.stats["programs"] += 1
            self.out_programs.append((tvpn, tppn))
            return True
        return False

    # ---------------------------------------------------------- shared
    def _stall(self, qid: int, item, front: bool = False):
        self.stats["stall"] += 1
        self._stalls_in_row += 1
        if front:      # head-of-line block: preserve FIFO dependencies
            self.queues[qid].appendleft(item)
        else:
            self.queues[qid].append(item)

    def _targeted_cmt_flush(self, s: int):
        """Free a way in CMT set s by flushing a TVPN with a dirty block
        there (keeps a full set from deadlocking on the global watermark)."""
        for w in range(self.g.cmt_ways):
            blk = self.cmt[s][w]
            if blk.dirty:
                tvpn = blk.tag // self.g.chunks_per_tp
                for e in self.dtl:
                    if e["tvpn"] == tvpn:
                        self._flush_tvpn(e)
                        return

    def _targeted_ctp_writeback(self, s: int):
        for w in range(self.g.ctp_ways):
            blk = self.ctp[s][w]
            if blk.dirty and blk.valid:
                tppn = self.tppn_next
                self.tppn_next += 1
                assert self.tppn_next < self.g.tppn_cap
                self.flash_tp[tppn] = list(blk.data)
                self.gtd[blk.tag] = tppn
                blk.dirty = False
                self.ctp_dirty -= 1
                self.stats["programs"] += 1
                self.out_programs.append((blk.tag, tppn))
                return

    @staticmethod
    def _second_chance(ways, clocks, s: int, n_ways: int) -> Optional[int]:
        for i in range(2 * n_ways):
            w = (clocks[s] + i) % n_ways
            blk = ways[w]
            if blk.dirty or blk.transient:
                continue
            if blk.refbit:
                blk.refbit = False
                continue
            clocks[s] = (w + 1) % n_ways
            return w
        return None

    # ---------------------------------------------------------- inspection
    def resolve(self, dlpn: int) -> int:
        """Current logical->physical view through CMT -> CTP -> flash."""
        block_id, s, off = self._cmt_loc(dlpn)
        for w in range(self.g.cmt_ways):
            blk = self.cmt[s][w]
            if blk.valid and blk.tag == block_id:
                return blk.data[off]
        tvpn = dlpn // self.g.entries_per_tp
        ts = tvpn % self.g.ctp_sets
        for w in range(self.g.ctp_ways):
            blk = self.ctp[ts][w]
            if blk.valid and blk.tag == tvpn:
                return blk.data[dlpn % self.g.entries_per_tp]
        tppn = self.gtd[tvpn]
        if tppn == NIL:
            return NIL
        return self.flash_tp[tppn][dlpn % self.g.entries_per_tp]
