"""Discrete-event SSD simulator (DiskSim/SSD-extension style, §5.1): the
port's own copy of ``repro/core/sim/ssd.py``, result for result.

Models: multi-channel/multi-way flash (chip cell-op servers + per-channel
bus pipes), NVMe host pipes, a map unit (software FTL on 1..n cores, or
the FMMU hardware pipeline), write buffering with NAND backpressure,
page-mapped BM with greedy GC, and shared in-flight translation-page
reads (the simulator-level realization of non-blocking miss merging).

The "ideal" scheme has zero FTL execution time — the paper's ideal
anchor. Absolute ideal numbers derive from Table 1 timing from first
principles (they differ from DiskSim's internal overheads; EXPERIMENTS.md
§Paper-repro reports both and validates ratios/shapes).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.configs.fmmu_paper import SSDConfig
from repro_torch.core.ftl.costmodel import HW, us
from repro_torch.core.ftl.mapcache import SCHEMES, AccessPlan, FMMUCache
from repro_torch.core.sim.events import EventQueue, Pipe, Server


@dataclasses.dataclass
class Cmd:
    op: str              # 'r' | 'w'
    dlpn: int            # first logical page
    npages: int
    bytes_per_page: int  # host payload per page (<= page size)


class SSDSim:
    WRITE_BUF_BYTES = 64 << 20

    def __init__(self, cfg: SSDConfig, scheme: str = "fmmu",
                 n_cores: int = 1, t_ftl_us: Optional[float] = None,
                 fixed_miss: bool = False, zero_exec: bool = False):
        # fixed_miss: with scheme='ideal'/fixed cost, force every access
        # through a translation-page flash read (Fig. 2 'map miss' case)
        # zero_exec: paper's "ideal" — the map cache behaves normally
        # (incl. its translation-page flash IO) but costs zero exec time
        self.cfg = cfg
        self.ev = EventQueue()
        n = cfg.nand
        self.page = n.page_data_bytes
        self.ppb = n.pages_per_block
        self.n_chips = cfg.channels * cfg.ways
        self.chips = [Server(self.ev, 1, f"chip{i}")
                      for i in range(self.n_chips)]
        self.buses = [Pipe(self.ev, n.bus_mbps, f"ch{c}",
                           op_overhead_us=n.bus_op_overhead_us)
                      for c in range(cfg.channels)]
        self.host_in = Pipe(self.ev, cfg.host_bw_gbps * 1000, "host_in")
        self.host_out = Pipe(self.ev, cfg.host_bw_gbps * 1000, "host_out")
        self.scheme = scheme
        self.t_ftl_us = t_ftl_us
        self.fixed_miss = fixed_miss
        self.zero_exec = zero_exec
        if scheme in SCHEMES:
            self.cache = SCHEMES[scheme](cfg)
            cores = 1 if scheme == "fmmu" else n_cores
        else:                      # 'ideal' or fixed-cost
            self.cache = None
            cores = max(1, n_cores)
        self.map_unit = Server(self.ev, cores, "ftl")
        # --- BM / physical state ---
        self.n_pages_logical = cfg.logical_pages
        n_blocks = int(cfg.physical_pages // self.ppb)
        self.n_blocks = n_blocks
        self.map = np.full(self.n_pages_logical, -1, np.int64)   # truth
        self.rmap = np.full(n_blocks * self.ppb, -1, np.int64)
        self.valid = np.zeros(n_blocks, np.int32)
        self.next_page = np.zeros(n_blocks, np.int32)
        self.free_blocks = list(range(self.n_chips, n_blocks))[::-1]
        self.active = list(range(self.n_chips))  # one active block per chip
        self.rr_chip = 0
        # GC thresholds adapt to the over-provisioning headroom so that
        # in-flight GC copies can never exhaust the reserve:
        #   max GC demand = GC_PARALLEL blocks <= RESERVE_BLOCKS - margin
        logical_blocks = self.n_pages_logical // self.ppb
        op_blocks = max(4, n_blocks - logical_blocks)
        self.GC_PARALLEL = min(16, max(2, op_blocks // 8))
        self.RESERVE_BLOCKS = self.GC_PARALLEL + 2
        self.GC_LOW = self.RESERVE_BLOCKS + self.GC_PARALLEL
        self.GC_HIGH = min(max(op_blocks // 2, self.GC_LOW + 2),
                           self.GC_LOW * 2)
        self.gc_chains = 0
        self.in_gc: set = set()
        self.free_pages = (len(self.free_blocks) + len(self.active)) * self.ppb
        self.alloc_waiters: List[Callable] = []
        self.write_buf = self.WRITE_BUF_BYTES
        self.buf_waiters: List[Tuple[int, Callable]] = []
        # shared in-flight TP reads: tvpn -> waiter callbacks
        self.tp_inflight: Dict[int, List[Callable]] = {}
        self.stats = {"reads": 0, "writes": 0, "gc_moves": 0, "erases": 0,
                      "tp_reads": 0, "tp_programs": 0, "host_bytes": 0}

    # ----------------------------------------------------------- layout
    def chip_of_block(self, blk: int) -> int:
        return blk % self.n_chips

    def chan_of_chip(self, chip: int) -> int:
        return chip % self.cfg.channels

    def tp_chip(self, tvpn: int) -> int:
        return tvpn % self.n_chips

    # ----------------------------------------------------------- alloc
    def _alloc(self) -> int:
        """Allocate next physical page, striping chips round-robin."""
        for _ in range(self.n_chips):
            chip = self.rr_chip
            self.rr_chip = (self.rr_chip + 1) % self.n_chips
            blk = self.active[chip]
            if self.next_page[blk] < self.ppb:
                p = blk * self.ppb + int(self.next_page[blk])
                self.next_page[blk] += 1
                self.free_pages -= 1
                return p
            if self.free_blocks:
                nb = self.free_blocks.pop()
                self.active[chip] = nb
                p = nb * self.ppb
                self.next_page[nb] = 1
                self.free_pages -= 1
                return p
        raise RuntimeError("out of space (GC failing)")

    def _host_can_alloc(self) -> bool:
        return self.free_pages > self.RESERVE_BLOCKS * self.ppb

    def _host_alloc_gate(self, cb: Callable):
        """Backpressure: host writes wait while GC digs out of the
        reserve (real SSDs throttle exactly like this)."""
        if self._host_can_alloc():
            cb()
        else:
            self.alloc_waiters.append(cb)
            self._maybe_gc()

    def _release_alloc_waiters(self):
        while self.alloc_waiters and self._host_can_alloc():
            self.alloc_waiters.pop(0)()

    def _write_page(self, dlpn: int, dppn: int):
        old = self.map[dlpn]
        if old >= 0:
            self.valid[old // self.ppb] -= 1
        self.map[dlpn] = dppn
        self.rmap[dppn] = dlpn
        self.valid[dppn // self.ppb] += 1

    # ----------------------------------------------------------- flash ops
    def flash_read(self, dppn_chip: int, nbytes: int, done: Callable):
        chip = dppn_chip
        self.chips[chip].request(
            self.cfg.nand.read_us,
            lambda: self.buses[self.chan_of_chip(chip)].transfer(nbytes, done))

    def flash_program(self, chip: int, nbytes: int, done: Callable):
        self.buses[self.chan_of_chip(chip)].transfer(
            nbytes,
            lambda: self.chips[chip].request(self.cfg.nand.program_us, done))

    def flash_erase(self, chip: int, done: Callable):
        self.chips[chip].request(self.cfg.nand.erase_us, done)

    # ----------------------------------------------------------- map unit
    def map_access(self, dlpn: int, write: bool, done: Callable):
        """Run the map-cache access (exec + possible TP read + flush IO)."""
        if self.cache is None:
            t = self.t_ftl_us or 0.0
            tvpn = dlpn // self.cfg.entries_per_tp

            def finish():
                if self.fixed_miss:
                    self.stats["tp_reads"] += 1
                    self.flash_read(self.tp_chip(tvpn), self.page,
                                    lambda: (self.map_unit.request(t, done)
                                             if t > 0 else done()))
                else:
                    done()

            if t > 0:
                self.map_unit.request(t, finish)
            else:
                self.ev.after(0.0, finish)
            return
        plan = self.cache.access(dlpn, write)
        if self.zero_exec:
            plan.cycles = 0.0
            plan.fill_cycles = 0.0
            if plan.flush is not None:
                plan.flush.cycles = 0.0
        if plan.flush is not None:
            self._schedule_flush(plan.flush)

        def after_exec():
            if plan.tp_read is None:
                done()
            else:
                self._tp_read(plan.tp_read, plan.fill_cycles, done)

        if self.zero_exec:
            self.ev.after(0.0, after_exec)
            return
        if self.scheme == "fmmu":
            # pipelined hardware: occupancy = initiation interval,
            # remaining latency elapses without holding the unit
            occ = us(min(plan.cycles, HW.pipeline_ii))
            lat = us(plan.cycles) - occ
            self.map_unit.request(occ, lambda: self.ev.after(lat, after_exec))
        else:
            self.map_unit.request(us(plan.cycles), after_exec)

    def _tp_read(self, tvpn: int, fill_cycles: float, done: Callable):
        if tvpn in self.tp_inflight:            # merge (MSHR semantics)
            if isinstance(self.cache, FMMUCache):
                extra = us(min(self.cache.merged_cycles(), 16))
            else:
                extra = us(100)
            self.tp_inflight[tvpn].append(
                lambda: self.map_unit.request(extra, done))
            return
        self.tp_inflight[tvpn] = []
        self.stats["tp_reads"] += 1

        def arrived():
            waiters = self.tp_inflight.pop(tvpn, [])
            self.map_unit.request(us(fill_cycles), done)
            for wcb in waiters:
                wcb()

        chip = self.tp_chip(tvpn)
        self.flash_read(chip, self.page, arrived)

    def _schedule_flush(self, fw):
        for tvpn in fw.tp_reads:
            self.stats["tp_reads"] += 1
            self.flash_read(self.tp_chip(tvpn), self.page, lambda: None)
        for tvpn in fw.tp_programs:
            self.stats["tp_programs"] += 1
            self.flash_program(self.tp_chip(tvpn), self.page, lambda: None)
        if fw.cycles:
            self.map_unit.request(us(fw.cycles), lambda: None)

    # ----------------------------------------------------------- GC
    def _maybe_gc(self):
        if len(self.free_blocks) >= self.GC_LOW:
            return
        while self.gc_chains < self.GC_PARALLEL:
            if not self._gc_step():
                break

    def _gc_step(self) -> bool:
        if len(self.free_blocks) >= self.GC_HIGH:
            return False
        active = set(self.active)
        cands = [b for b in range(self.n_blocks)
                 if b not in active and b not in self.in_gc
                 and self.next_page[b] >= self.ppb]
        if not cands:
            return False
        victim = min(cands, key=lambda b: self.valid[b])
        self.in_gc.add(victim)
        self.gc_chains += 1
        pages = [victim * self.ppb + i for i in range(self.ppb)]
        live = [p for p in pages if self.rmap[p] >= 0
                and self.map[self.rmap[p]] == p]
        moves = len(live)
        self.stats["gc_moves"] += moves

        def next_move(i: int):
            if i >= len(live):
                def erased():
                    self.stats["erases"] += 1
                    self.next_page[victim] = 0
                    self.valid[victim] = 0
                    self.free_blocks.append(victim)
                    self.free_pages += self.ppb
                    self.in_gc.discard(victim)
                    self.gc_chains -= 1
                    self._release_alloc_waiters()
                    self._maybe_gc()

                self.flash_erase(self.chip_of_block(victim), erased)
                return
            src = live[i]
            dlpn = int(self.rmap[src])

            def after_read():
                dst = self._alloc()

                def after_prog():
                    # CondUpdate through the map unit (GCM path)
                    if self.map[dlpn] == src:   # not raced by host write
                        self._write_page(dlpn, dst)
                    self.map_access(dlpn, True, lambda: next_move(i + 1))

                self.flash_program(self.chip_of_block(dst // self.ppb),
                                   self.page, after_prog)

            self.flash_read(self.chip_of_block(src // self.ppb), self.page,
                            after_read)

        next_move(0)

    # ----------------------------------------------------------- host ops
    def read_page(self, dlpn: int, nbytes: int, done: Callable):
        self.stats["reads"] += 1

        def after_map():
            dppn = int(self.map[dlpn])
            chip = (self.chip_of_block(dppn // self.ppb) if dppn >= 0
                    else dlpn % self.n_chips)

            def after_flash():
                self.stats["host_bytes"] += nbytes
                self.host_out.transfer(nbytes, done)

            self.flash_read(chip, nbytes, after_flash)

        self.map_access(dlpn, False, after_map)

    def write_page(self, dlpn: int, nbytes: int, done: Callable):
        self.stats["writes"] += 1

        def buffered():
            self.stats["host_bytes"] += nbytes
            dppn = self._alloc()
            self._write_page(dlpn, dppn)
            self._maybe_gc()

            def after_prog():
                self.write_buf += self.page
                if self.buf_waiters:
                    nb, cb = self.buf_waiters.pop(0)
                    self._acquire_buf(nb, cb)

            self.flash_program(self.chip_of_block(dppn // self.ppb),
                               self.page, after_prog)
            self.map_access(dlpn, True, done)   # ack after map update

        def after_host():
            self._acquire_buf(self.page, lambda: self._host_alloc_gate(buffered))

        self.host_in.transfer(nbytes, after_host)

    def _acquire_buf(self, nbytes: int, cb: Callable):
        if self.write_buf >= nbytes:
            self.write_buf -= nbytes
            cb()
        else:
            self.buf_waiters.append((nbytes, cb))

    # ----------------------------------------------------------- driver
    def submit(self, cmd: Cmd, done: Callable):
        left = [cmd.npages]

        def page_done():
            left[0] -= 1
            if left[0] == 0:
                done()

        for i in range(cmd.npages):
            dlpn = (cmd.dlpn + i) % self.n_pages_logical
            if cmd.op == "r":
                self.read_page(dlpn, cmd.bytes_per_page, page_done)
            else:
                self.write_page(dlpn, cmd.bytes_per_page, page_done)

    def precondition_sequential(self):
        """Instant (untimed) sequential fill of the whole logical space:
        map, BM and cache state warmed per-policy, no events."""
        for dlpn in range(self.n_pages_logical):
            dppn = self._alloc()
            self._write_page(dlpn, dppn)
            if self.cache is not None:
                self.cache.access(dlpn, True)
        if self.cache is not None:
            self.cache.stats = {k: (0 if isinstance(v, (int, float)) else v)
                                for k, v in self.cache.stats.items()}

    def run_closed_loop(self, workload: Iterator[Cmd], n_cmds: int,
                        outstanding: Optional[int] = None,
                        warmup_cmds: int = 0) -> dict:
        """Closed-loop driver; with warmup_cmds, an untimed steady-state
        warmup phase precedes measurement (stats reset at the boundary)."""
        outstanding = outstanding or self.cfg.outstanding
        it = iter(workload)
        if warmup_cmds:
            state_w = {"issued": 0, "done": 0}

            def issue_w():
                if state_w["issued"] >= warmup_cmds:
                    return
                try:
                    cmd = next(it)
                except StopIteration:
                    state_w["issued"] = warmup_cmds
                    return
                state_w["issued"] += 1
                self.submit(cmd, lambda: (state_w.__setitem__(
                    "done", state_w["done"] + 1), issue_w()))

            for _ in range(min(outstanding, warmup_cmds)):
                issue_w()
            self.ev.run()
            for srv in self.chips + [self.map_unit]:
                srv.busy_time = 0.0
            for p in self.buses + [self.host_in, self.host_out]:
                p.srv.busy_time = 0.0
            for k in self.stats:
                self.stats[k] = 0
        state = {"issued": 0, "done": 0}
        t0 = self.ev.now

        def issue_next():
            if state["issued"] >= n_cmds:
                return
            try:
                cmd = next(it)
            except StopIteration:
                state["issued"] = n_cmds
                return
            state["issued"] += 1
            self.submit(cmd, lambda: (state.__setitem__("done", state["done"] + 1),
                                      issue_next()))

        for _ in range(min(outstanding, n_cmds)):
            issue_next()
        self.ev.run()
        elapsed = self.ev.now - t0
        chips_util = float(np.mean([c.utilization(elapsed) for c in self.chips]))
        bus_util = float(np.mean([b.utilization(elapsed) for b in self.buses]))
        res = {
            "elapsed_us": elapsed,
            "cmds": state["done"],
            "iops": state["done"] / (elapsed / 1e6) if elapsed else 0.0,
            "gbps": self.stats["host_bytes"] / max(elapsed, 1e-9) / 1000.0,
            "util_chip": chips_util,
            "util_bus": bus_util,
            "util_ftl": self.map_unit.utilization(elapsed),
            "util_host": max(self.host_in.utilization(elapsed),
                             self.host_out.utilization(elapsed)),
            "stats": dict(self.stats),
        }
        if self.cache is not None:
            res["cache"] = dict(self.cache.stats)
        return res
