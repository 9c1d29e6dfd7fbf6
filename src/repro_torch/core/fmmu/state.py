"""FMMUState: the sequential packet engine's state as int32 torch
tensors, the port's copy of ``repro/core/fmmu/state.py``.

The 43 fields keep the reference's names, shapes and order, so a state
carries across the packages field by field (``convert.fsm_state_from_jax``
and ``convert.fsm_state_to_numpy``). Scalars are 0-dim tensors. The
engine (``engine.py``) and the CUDA kernel (``kernels/fmmu_fsm.py``)
update every tensor in place, so a state keeps its storage across steps.

Cache flags are bit-packed per block: VALID|DIRTY|TRANSIENT|REF.
Queues are ring buffers with monotonic head/tail counters (head can move
backwards one slot for head-of-line re-insertion on CTP stalls).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.core.fmmu.types import NIL, FMMUGeometry

F_VALID, F_DIRTY, F_TRANS, F_REF = 1, 2, 4, 8

# queue ids (must match oracle.py)
Q_FC_RESP, Q_CTP_RESP, Q_CTP_REQ, Q_HRM, Q_GCM = range(5)

# engine step return codes
WORKED, IDLE, BLOCKED = 0, 1, 2

INT32_MAX = 2 ** 31 - 1


class FMMUState(NamedTuple):
    # --- CMT ---
    cmt_tag: torch.Tensor      # [S,W]
    cmt_flags: torch.Tensor    # [S,W]
    cmt_data: torch.Tensor     # [S,W,E]
    cmt_next: torch.Tensor     # [S,W]
    cmt_mshr: torch.Tensor     # [S,W,M,5] kind,off,req_id,dppn,old
    cmt_mshr_n: torch.Tensor   # [S,W]
    cmt_clock: torch.Tensor    # [S]
    cmt_dirty: torch.Tensor    # scalar
    # --- CTP ---
    ctp_tag: torch.Tensor
    ctp_flags: torch.Tensor
    ctp_data: torch.Tensor     # [S2,W2,Et]
    ctp_mshr: torch.Tensor     # [S2,W2,M2,3+E] kind,chunk,dest,data
    ctp_mshr_n: torch.Tensor
    ctp_clock: torch.Tensor
    ctp_dirty: torch.Tensor
    # --- DTL ---
    dtl_tvpn: torch.Tensor     # [D]
    dtl_head: torch.Tensor     # [D]
    dtl_ndirty: torch.Tensor   # [D]
    dtl_updated: torch.Tensor  # [D]
    dtl_seq: torch.Tensor      # [D] registration order; free slot = int32 max
    dtl_ctr: torch.Tensor      # scalar monotonic
    # --- CTP flush FIFO ---
    fifo: torch.Tensor         # [F]
    fifo_head: torch.Tensor
    fifo_tail: torch.Tensor
    # --- GTD / flash ---
    gtd: torch.Tensor          # [n_tvpns]
    flash_tp: torch.Tensor     # [tppn_cap, Et]
    tppn_next: torch.Tensor
    # --- queues ---
    qbuf: torch.Tensor         # [5, cap, PW]
    qhead: torch.Tensor        # [5]
    qtail: torch.Tensor        # [5]
    credits: torch.Tensor      # [5]
    weights: torch.Tensor      # [5] (runtime-adjustable, §4.6)
    stalls_in_row: torch.Tensor
    # --- outputs ---
    resp_buf: torch.Tensor     # [cap,4] req_id,kind,dppn,status
    resp_n: torch.Tensor       # tail (monotonic)
    resp_head: torch.Tensor    # drained-up-to pointer
    fc_buf: torch.Tensor       # [cap,3] tppn,set,way
    fc_n: torch.Tensor
    fc_head: torch.Tensor
    prog_buf: torch.Tensor     # [cap,2] tvpn,new_tppn
    prog_n: torch.Tensor
    prog_head: torch.Tensor
    # --- stats (order: STAT_NAMES) ---
    stats: torch.Tensor        # [11]


STAT_NAMES = ("hit", "miss", "mshr_merge", "stall", "flush_tvpns",
              "flush_blocks", "fc_reads", "programs", "steps", "ctp_hit",
              "ctp_miss")


def fifo_cap(g: FMMUGeometry) -> int:
    """The CTP flush FIFO's slots: a TVPN is queued at most once."""
    return max(16, g.n_tvpns + 1, 2 * g.ctp_blocks)


def init_state(g: FMMUGeometry,
               device: Union[str, torch.device]) -> FMMUState:
    """A fresh state on ``device`` (explicit: the engine resolves it)."""
    i32 = torch.int32
    pw = g.pkt_width
    m2w = 3 + g.cmt_entries
    cap = g.queue_cap

    def full(shape, v):
        return torch.full(shape, v, dtype=i32, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=i32, device=device)

    return FMMUState(
        cmt_tag=full((g.cmt_sets, g.cmt_ways), NIL),
        cmt_flags=zeros((g.cmt_sets, g.cmt_ways)),
        cmt_data=full((g.cmt_sets, g.cmt_ways, g.cmt_entries), NIL),
        cmt_next=full((g.cmt_sets, g.cmt_ways), NIL),
        cmt_mshr=full((g.cmt_sets, g.cmt_ways, g.mshr_cap, 5), NIL),
        cmt_mshr_n=zeros((g.cmt_sets, g.cmt_ways)),
        cmt_clock=zeros((g.cmt_sets,)),
        cmt_dirty=zeros(()),
        ctp_tag=full((g.ctp_sets, g.ctp_ways), NIL),
        ctp_flags=zeros((g.ctp_sets, g.ctp_ways)),
        ctp_data=full((g.ctp_sets, g.ctp_ways, g.entries_per_tp), NIL),
        ctp_mshr=full((g.ctp_sets, g.ctp_ways, g.ctp_mshr_cap, m2w), NIL),
        ctp_mshr_n=zeros((g.ctp_sets, g.ctp_ways)),
        ctp_clock=zeros((g.ctp_sets,)),
        ctp_dirty=zeros(()),
        dtl_tvpn=full((g.dtl_entries,), NIL),
        dtl_head=full((g.dtl_entries,), NIL),
        dtl_ndirty=zeros((g.dtl_entries,)),
        dtl_updated=zeros((g.dtl_entries,)),
        dtl_seq=full((g.dtl_entries,), INT32_MAX),
        dtl_ctr=zeros(()),
        fifo=full((fifo_cap(g),), NIL),
        fifo_head=zeros(()),
        fifo_tail=zeros(()),
        gtd=full((g.n_tvpns,), NIL),
        flash_tp=full((g.tppn_cap, g.entries_per_tp), NIL),
        tppn_next=zeros(()),
        qbuf=zeros((5, cap, pw)),
        qhead=zeros((5,)),
        qtail=zeros((5,)),
        credits=torch.tensor(g.wrr_weights, dtype=i32, device=device),
        weights=torch.tensor(g.wrr_weights, dtype=i32, device=device),
        stalls_in_row=zeros(()),
        resp_buf=zeros((cap, 4)),
        resp_n=zeros(()),
        resp_head=zeros(()),
        fc_buf=zeros((cap, 3)),
        fc_n=zeros(()),
        fc_head=zeros(()),
        prog_buf=zeros((cap, 2)),
        prog_n=zeros(()),
        prog_head=zeros(()),
        stats=zeros((11,)),
    )


def clone_state(st: FMMUState) -> FMMUState:
    """A deep copy (new storage for every tensor)."""
    return FMMUState(*(t.clone() for t in st))
