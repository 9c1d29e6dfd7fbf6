"""Workload generators (the port's own copy of
``repro/core/sim/workloads.py``): the paper's synthetic set (§5.1) and
MSR/UMass trace *surrogates* matched to Table 3's statistics (the
original traces are not redistributable; EXPERIMENTS.md flags every
number derived from surrogates)."""
from __future__ import annotations

import dataclasses
import random
from typing import Iterator

from repro_torch.configs.fmmu_paper import SSDConfig
from repro_torch.core.sim.ssd import Cmd


def _pages(cfg: SSDConfig, nbytes: int) -> int:
    return max(1, nbytes // cfg.nand.page_data_bytes)


def rand_read_4k(cfg: SSDConfig, seed: int = 0) -> Iterator[Cmd]:
    rng = random.Random(seed)
    n = cfg.logical_pages
    while True:
        yield Cmd("r", rng.randrange(n), 1, 4096)


def rand_write_4k(cfg: SSDConfig, seed: int = 0) -> Iterator[Cmd]:
    rng = random.Random(seed)
    n = cfg.logical_pages
    while True:
        yield Cmd("w", rng.randrange(n), 1, 4096)


def seq_read_64k(cfg: SSDConfig) -> Iterator[Cmd]:
    npg = _pages(cfg, 65536)
    pos = 0
    n = cfg.logical_pages
    while True:
        yield Cmd("r", pos, npg, cfg.nand.page_data_bytes)
        pos = (pos + npg) % n


def seq_write_64k(cfg: SSDConfig) -> Iterator[Cmd]:
    npg = _pages(cfg, 65536)
    pos = 0
    n = cfg.logical_pages
    while True:
        yield Cmd("w", pos, npg, cfg.nand.page_data_bytes)
        pos = (pos + npg) % n


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Table 3 statistics."""
    name: str
    read_ratio: float          # of commands
    avg_read_kb: float
    avg_write_kb: float
    hot_fraction: float        # footprint share receiving most accesses
    hot_weight: float          # probability mass on the hot set
    seq_prob: float            # chance a command continues a stream


MSR_PROJ = TraceSpec("MSR_proj", 0.1248, 17.83, 40.91, 0.04, 0.70, 0.55)
MSR_HM = TraceSpec("MSR_hm", 0.3550, 7.36, 8.33, 0.04, 0.85, 0.25)
WEBSEARCH = TraceSpec("WebSearch", 0.9998, 15.14, 8.60, 0.15, 0.80, 0.40)

TRACES = {t.name: t for t in (MSR_PROJ, MSR_HM, WEBSEARCH)}


def trace_surrogate(cfg: SSDConfig, spec: TraceSpec,
                    seed: int = 0) -> Iterator[Cmd]:
    rng = random.Random(seed)
    n = cfg.logical_pages
    hot_n = max(1, int(n * spec.hot_fraction))
    stream_pos = rng.randrange(n)

    def pick_lpn() -> int:
        if rng.random() < spec.hot_weight:
            return rng.randrange(hot_n)
        return hot_n + rng.randrange(max(1, n - hot_n))

    while True:
        is_read = rng.random() < spec.read_ratio
        avg_kb = spec.avg_read_kb if is_read else spec.avg_write_kb
        # sizes ~ clipped exponential around the Table-3 mean
        kb = max(4, min(512, int(rng.expovariate(1.0 / avg_kb)) or 4))
        npg = max(1, (kb * 1024) // cfg.nand.page_data_bytes)
        if rng.random() < spec.seq_prob:
            lpn = stream_pos
            stream_pos = (stream_pos + npg) % n
        else:
            lpn = pick_lpn()
            stream_pos = (lpn + npg) % n
        last_bytes = min(kb * 1024, npg * cfg.nand.page_data_bytes)
        yield Cmd("r" if is_read else "w", lpn, npg,
                  min(cfg.nand.page_data_bytes, last_bytes))
