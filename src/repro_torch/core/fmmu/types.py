"""Shared FMMU protocol constants and geometry: the port's own copy of
what the batched map path reads from ``repro/core/fmmu/types.py``."""
from __future__ import annotations

import dataclasses

# --- packet kinds of the batched translate path ------------------------
LOOKUP = 0        # f1=dlpn
UPDATE = 1        # f1=dlpn f2=dppn
COND_UPDATE = 2   # f1=dlpn f2=dppn f3=old_dppn

NIL = -1

# swap directions (``faults.SwapFault.direction``)
SWAP_OUT = 0      # device -> host tier
SWAP_IN = 1       # host -> device tier

# Tier tag for physical KV block ids: device blocks are [0, HOST_BASE),
# host ("flash"-analogue) blocks are [HOST_BASE, ...). Ids at or above
# 1<<24 leave float32's exact-integer range, so every map value path
# must move them as integers.
HOST_BASE = 1 << 24


@dataclasses.dataclass(frozen=True)
class FMMUGeometry:
    """Sizes follow the paper's §5.1 defaults; tests shrink everything."""
    cmt_sets: int = 512
    cmt_ways: int = 4
    cmt_entries: int = 8           # DLPN->DPPN entries per CMT block
    ctp_sets: int = 16
    ctp_ways: int = 4
    entries_per_tp: int = 4096     # 16KB page / 4B entry
    n_tvpns: int = 256             # logical pages / entries_per_tp
    dtl_entries: int = 128
    queue_cap: int = 1024
    mshr_cap: int = 8
    ctp_mshr_cap: int = 64
    tppn_cap: int = 16384
    low_watermark: float = 0.10
    high_watermark: float = 0.25
    wrr_weights: tuple = (4, 4, 2, 2, 1)

    def __post_init__(self):
        assert self.entries_per_tp % self.cmt_entries == 0
        assert self.mshr_cap <= self.cmt_entries, \
            "in-cache MSHRs live in the data area"

    @property
    def cmt_blocks(self) -> int:
        return self.cmt_sets * self.cmt_ways


def small_geometry(**kw) -> FMMUGeometry:
    """Tiny geometry for tests (matches the paper's Fig. 8 scale)."""
    defaults = dict(cmt_sets=4, cmt_ways=2, cmt_entries=4, ctp_sets=2,
                    ctp_ways=2, entries_per_tp=16, n_tvpns=8,
                    dtl_entries=4, queue_cap=256, mshr_cap=4,
                    ctp_mshr_cap=4, tppn_cap=4096)
    defaults.update(kw)
    return FMMUGeometry(**defaults)
