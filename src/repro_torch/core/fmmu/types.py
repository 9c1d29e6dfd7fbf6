"""Shared FMMU protocol constants and geometry: the port's own copy of
``repro/core/fmmu/types.py`` — what the batched map path reads, and the
packet formats, request kinds and geometry of the sequential packet
engine (``oracle.py``, ``state.py``, ``engine.py``)."""
from __future__ import annotations

import dataclasses

# --- packet kinds ------------------------------------------------------
LOOKUP = 0        # HRM/GCM -> CMT      f1=dlpn                     f4=req_id
UPDATE = 1        # HRM     -> CMT      f1=dlpn f2=dppn             f4=req_id
COND_UPDATE = 2   # GCM     -> CMT      f1=dlpn f2=dppn f3=old_dppn f4=req_id
LOAD = 3          # CMT -> CTP          f1=tvpn f2=chunk f3=dest(cmt set,way)
FLUSH_BLK = 4     # CMT -> CTP          f1=tvpn f2=chunk data=E_c entries
LOAD_RESP = 5     # CTP -> CMT          f1=tvpn f2=chunk f3=dest data=entries
FC_READ = 6       # CTP -> flash        f1=tppn f3=dest(ctp set,way)
FC_READ_RESP = 7  # flash -> CTP        f1=tppn f3=dest(ctp set,way)
PROGRAM = 8       # CTP -> BM/flash     f1=tvpn f2=new_tppn (write-back)
RESP = 9          # FMMU -> HRM/GCM     f1=req_id f2=dppn f3=status

# RESP status codes
ST_OK = 0
ST_STALE = 1      # CondUpdate lost the race (mapping moved on)

# MSHR kinds logged in transient blocks
M_LOOKUP, M_UPDATE, M_COND, M_LOAD, M_FLUSH = 0, 1, 2, 3, 4

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
    def chunks_per_tp(self) -> int:
        return self.entries_per_tp // self.cmt_entries

    @property
    def cmt_blocks(self) -> int:
        return self.cmt_sets * self.cmt_ways

    @property
    def ctp_blocks(self) -> int:
        return self.ctp_sets * self.ctp_ways

    @property
    def pkt_width(self) -> int:
        return 5 + self.cmt_entries  # kind, f1..f4, inline data

    def cmt_low(self) -> int:
        return max(1, int(self.low_watermark * self.cmt_blocks))

    def cmt_high(self) -> int:
        return max(self.cmt_low() + 1,
                   int(self.high_watermark * self.cmt_blocks))

    def ctp_low(self) -> int:
        return max(1, int(self.low_watermark * self.ctp_blocks))

    def ctp_high(self) -> int:
        return max(self.ctp_low() + 1,
                   int(self.high_watermark * self.ctp_blocks))


def small_geometry(**kw) -> FMMUGeometry:
    """Tiny geometry for tests (matches the paper's Fig. 8 scale)."""
    defaults = dict(cmt_sets=4, cmt_ways=2, cmt_entries=4, ctp_sets=2,
                    ctp_ways=2, entries_per_tp=16, n_tvpns=8,
                    dtl_entries=4, queue_cap=256, mshr_cap=4,
                    ctp_mshr_cap=4, tppn_cap=4096)
    defaults.update(kw)
    return FMMUGeometry(**defaults)


@dataclasses.dataclass
class Request:
    kind: int
    dlpn: int
    dppn: int = NIL
    old_dppn: int = NIL
    req_id: int = NIL
    src: int = 0          # 0 = HRM, 1 = GCM


@dataclasses.dataclass(frozen=True)
class Response:
    req_id: int
    kind: int
    dppn: int
    status: int
