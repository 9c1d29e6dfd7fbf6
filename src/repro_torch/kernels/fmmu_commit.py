"""The whole FMMU map commit in one launch: the CUDA kernel of
``csrc/fmmu_commit.cu`` and its plain torch version.

The redesign of ``repro/kernels/fmmu_translate.py`` for the card: the
probe that kernel does, plus the commit around it that the reference
leaves to XLA (``repro/core/fmmu/batch.py``: the optional device-side
block pop of ``serving_grow``, the write-through, the MSHR-merged insert
pass and the block-table commit of ``translate_serving``), as one
launch instead of a chain of ~230 small ops.

The commit updates the state's tensors in place, as XLA does with
donated buffers; the functional entry points of ``core/fmmu/batch``
clone the state first. A CPU tensor takes the plain version
(``fmmu_commit_ref``: the map path's chain of torch ops, written into
the same tensors); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.core.fmmu.types import FMMUGeometry
from repro_torch.kernels import _build

LAUNCHES = COUNTERS.cell("kernel.fmmu_commit")
BIG = torch.iinfo(torch.int32).max
SMEM_MAX = 232448 - 1024     # a block's shared memory, less the static part

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 20 + [_I] * 9 + [_P]

__all__ = ["fmmu_commit", "fmmu_commit_ref", "smem_bytes", "LANE_CAP",
           "LAUNCHES"]


def smem_bytes(n_lanes: int) -> int:
    """Dynamic shared memory of one launch (``fmmu_commit_smem_bytes``
    in the source): sort keys and scan [pow2 >= Bq] int32 each, a hash
    of [pow2 >= 2 Bq] (block id, priority) pairs, one flag byte a
    lane."""
    n = 1 << max(n_lanes - 1, 0).bit_length()
    hs = 1 << max(2 * n_lanes - 1, 0).bit_length()
    return 4 * (n + n + 1 + 2 * hs) + n_lanes


# the most lanes one block's shared memory holds (a power of two: within
# (p/2, p] the footprint grows by one byte a lane)
LANE_CAP = max(1 << k for k in range(24) if smem_bytes(1 << k) <= SMEM_MAX)


def fmmu_commit_ref(g: FMMUGeometry, ms, dlpns, *, opcodes=None,
                    dppns=None, old_dppns=None, grow=None
                    ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                               Optional[torch.Tensor]]:
    """The plain version: ``core/fmmu/batch.commit_chain`` (the chain of
    torch ops the kernel replaces), written into ``ms``'s tensors."""
    # the chain lives with the map path, which imports this module
    from repro_torch.core.fmmu import batch
    new, out, ok, blocks = batch.commit_chain(
        g, ms, dlpns, opcodes=opcodes, dppns=dppns, old_dppns=old_dppns,
        grow=grow)
    for dst, src in zip(batch.state_tensors(ms), batch.state_tensors(new)):
        if dst is not src:
            dst.copy_(src)
    return out, ok, blocks


def fmmu_commit(g: FMMUGeometry, ms, dlpns, *, opcodes=None, dppns=None,
                old_dppns=None, grow=None
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                           Optional[torch.Tensor]]:
    """One map commit of the lanes ``dlpns`` [Bq] int32, in place.

    ``ms`` is a ServingMapState (the commit also writes its block table
    and ``commit_seq``) or a BatchFMMUState (``translate_batch``: no
    table). Either ``opcodes``, ``dppns``, ``old_dppns`` [Bq] int32 are
    given (a mixed LOOKUP / UPDATE / COND_UPDATE batch), or ``grow``
    [Bq] bool with a ServingMapState (``serving_grow``: one block pop
    per grow lane, an UPDATE of dlpn -> block where the pop succeeded).
    Returns (out [Bq] int32 or None in grow mode, ok [Bq] bool, blocks
    [Bq] int32 in grow mode or None). Raises ValueError past LANE_CAP
    lanes, on any device."""
    bq = dlpns.shape[0]
    if bq > LANE_CAP:
        raise ValueError(f"fmmu_commit: {bq} lanes; one launch holds at "
                         f"most {LANE_CAP} (its shared memory)")
    if dlpns.device.type == "cpu":
        return fmmu_commit_ref(g, ms, dlpns, opcodes=opcodes, dppns=dppns,
                               old_dppns=old_dppns, grow=grow)
    serving = hasattr(ms, "fmmu")
    st = ms.fmmu if serving else ms
    grow_mode = grow is not None
    if grow_mode and not serving:
        raise ValueError("fmmu_commit: grow needs a ServingMapState")
    dev = dlpns.device
    s, w, e = g.cmt_sets, g.cmt_ways, g.cmt_entries
    nb = g.n_tvpns * g.entries_per_tp // e
    q_cap = -(-nb // s)
    assert 4 * q_cap * (s + 1) < BIG, "packed insert key overflows"
    req = _build.require
    i32, b8 = torch.int32, torch.bool
    req(st.tags, "tags", device=dev, dtype=i32, shape=(s, w))
    req(st.valid, "valid", device=dev, dtype=b8, shape=(s, w))
    req(st.ref, "ref", device=dev, dtype=b8, shape=(s, w))
    req(st.clock, "clock", device=dev, dtype=i32, shape=(s,))
    req(st.data, "data", device=dev, dtype=i32, shape=(s, w, e))
    req(st.backing, "backing", device=dev, dtype=i32, shape=(nb * e,))
    req(st.stats, "stats", device=dev, dtype=i32, shape=(4,))
    req(dlpns, "dlpns", device=dev, dtype=i32, shape=(bq,))
    table = commit_seq = free_stack = free_n = oob = None
    if serving:
        table, commit_seq = ms.table, ms.commit_seq
        if table.dim() != 1:
            raise ValueError(f"table: expected [N], got {tuple(table.shape)}")
        req(table, "table", device=dev, dtype=i32, shape=table.shape)
        req(commit_seq, "commit_seq", device=dev, dtype=i32, shape=())
    if grow_mode:
        free_stack, free_n, oob = ms.free_stack, ms.free_n, ms.oob
        req(grow, "grow", device=dev, dtype=b8, shape=(bq,))
        req(free_stack, "free_stack", device=dev, dtype=i32,
            shape=free_stack.shape[:1])
        req(free_n, "free_n", device=dev, dtype=i32, shape=())
        req(oob, "oob", device=dev, dtype=b8, shape=())
        out = None
        blocks = torch.empty(bq, dtype=i32, device=dev)
    else:
        for name, t in (("opcodes", opcodes), ("dppns", dppns),
                        ("old_dppns", old_dppns)):
            req(t, name, device=dev, dtype=i32, shape=(bq,))
        out = torch.empty(bq, dtype=i32, device=dev)
        blocks = None
    ok = torch.empty(bq, dtype=b8, device=dev)
    if bq == 0:
        return out, ok, blocks

    def ptr(t):
        return t.data_ptr() if t is not None else None
    lib = _build.load("fmmu_commit", _ARGTYPES)
    err = lib.fmmu_commit_launch(
        *(ptr(t) for t in (st.tags, st.valid, st.ref, st.clock, st.data,
                           st.backing, st.stats, table, commit_seq,
                           free_stack, free_n, oob, grow, opcodes, dlpns,
                           dppns, old_dppns, out, ok, blocks)),
        s, w, e, st.backing.shape[0],
        table.shape[0] if table is not None else 0,
        free_stack.shape[0] if free_stack is not None else 0,
        bq, q_cap, nb, _build.stream_ptr(dlpns))
    _build.check(lib, "fmmu_commit", err)
    LAUNCHES[0] += 1
    return out, ok, blocks
