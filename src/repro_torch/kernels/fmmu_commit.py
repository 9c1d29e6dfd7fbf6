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

A channel-stacked serving state (tensors with a leading [C] axis,
``batch.init_sharded_state``) is one launch of C blocks, block c
committing channel c's shard with the lanes it owns
(``translate_sharded``, ``grow_sharded``: the reference's vmap over the
channels). Its plain version loops over the channels, the chain on
each shard's views.

A ServingMapState's optional count lanes (``live``, ``refcnt``: the GC
walk's and prefix sharing's per-device-block counts) are kept by the
same launch when present: each write lane moves one count from its
pre-batch block to its new one. An absent lane costs the launch
nothing (a null pointer).
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
_ARGTYPES = [_P] * 22 + [_I] * 25 + [_P]
# the stacked state tensors whose per-shard strides a launch passes
_SHARDED = ("tags", "valid", "ref", "clock", "data", "backing", "stats",
            "table", "commit_seq", "free_stack", "free_n", "oob", "live",
            "refcnt")

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
    torch ops the kernel replaces), written into ``ms``'s tensors; on a
    channel-stacked state, once per channel on the shard's views."""
    # the chain lives with the map path, which imports this module
    from repro_torch.core.fmmu import batch
    if isinstance(ms, batch.ServingMapState) and ms.table.dim() == 2:
        return _sharded_ref(g, ms, dlpns, opcodes, dppns, old_dppns, grow)
    new, out, ok, blocks = batch.commit_chain(
        g, ms, dlpns, opcodes=opcodes, dppns=dppns, old_dppns=old_dppns,
        grow=grow)
    for dst, src in zip(batch.state_tensors(ms), batch.state_tensors(new)):
        if dst is not src:
            dst.copy_(src)
    return out, ok, blocks


def _sharded_ref(g, ms, dlpns, opcodes, dppns, old_dppns, grow):
    """The plain sharded commit: channel c commits the lanes it owns
    (channel-local dlpns; the rest inactive) on its shard, and each
    lane's outputs come from its owner channel (NIL / False for a lane
    no channel owns), as the reference's "+1" sum over the channels."""
    from repro_torch.core.fmmu import batch
    n_ch = batch.n_channels(ms)
    owner = batch.channel_of(dlpns, n_ch)
    local = batch.local_dlpn(dlpns, n_ch)
    nil = torch.full_like(dlpns, -1)
    out, blocks = (None, nil) if grow is not None else (nil, None)
    ok = torch.zeros(dlpns.shape, dtype=torch.bool, device=dlpns.device)
    for c in range(n_ch):
        if grow is not None:
            own = grow & (owner == c)
        else:
            own = (dlpns >= 0) & (owner == c)
        dl = torch.where(own, local, -1).to(torch.int32)
        out_c, ok_c, blocks_c = fmmu_commit_ref(
            g, batch.shard(ms, c), dl, opcodes=opcodes, dppns=dppns,
            old_dppns=old_dppns, grow=own if grow is not None else None)
        if grow is not None:
            blocks = torch.where(own & ok_c, blocks_c, blocks)
        else:
            out = torch.where(own, out_c, out)
        ok = torch.where(own, ok_c, ok)
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
    A ServingMapState stacked on C channels is one launch of C blocks
    (global dlpns in, each lane committed by its owner channel).
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
    stacked = st.tags.dim() == 3
    if stacked and not serving:
        raise ValueError("fmmu_commit: a stacked state is a "
                         "ServingMapState")
    lead = (st.tags.shape[0],) if stacked else ()
    dev = dlpns.device
    s, w, e = g.cmt_sets, g.cmt_ways, g.cmt_entries
    nb = g.n_tvpns * g.entries_per_tp // e
    q_cap = -(-nb // s)
    assert 4 * q_cap * (s + 1) < BIG, "packed insert key overflows"
    i32, b8 = torch.int32, torch.bool

    def req(t, name, dtype, shape):
        _build.require(t, name, device=dev, dtype=dtype,
                       shape=lead + tuple(shape))
    req(st.tags, "tags", i32, (s, w))
    req(st.valid, "valid", b8, (s, w))
    req(st.ref, "ref", b8, (s, w))
    req(st.clock, "clock", i32, (s,))
    req(st.data, "data", i32, (s, w, e))
    req(st.backing, "backing", i32, (nb * e,))
    req(st.stats, "stats", i32, (4,))
    _build.require(dlpns, "dlpns", device=dev, dtype=i32, shape=(bq,))
    table = commit_seq = free_stack = free_n = oob = None
    live = refcnt = None
    n_device = 0
    if serving:
        table, commit_seq = ms.table, ms.commit_seq
        if table.dim() != len(lead) + 1:
            raise ValueError(f"table: expected {len(lead) + 1} dims, got "
                             f"{tuple(table.shape)}")
        req(table, "table", i32, table.shape[len(lead):])
        req(commit_seq, "commit_seq", i32, ())
        live, refcnt = ms.live, ms.refcnt
        lanes = [(n, t) for n, t in (("live", live), ("refcnt", refcnt))
                 if t is not None]
        if lanes:
            n_device = lanes[0][1].shape[-1]
        for name, t in lanes:
            req(t, name, i32, (n_device,))
    if grow_mode:
        free_stack, free_n, oob = ms.free_stack, ms.free_n, ms.oob
        _build.require(grow, "grow", device=dev, dtype=b8, shape=(bq,))
        req(free_stack, "free_stack", i32,
            free_stack.shape[len(lead):len(lead) + 1])
        req(free_n, "free_n", i32, ())
        req(oob, "oob", b8, ())
        out = None
        blocks = torch.empty(bq, dtype=i32, device=dev)
    else:
        for name, t in (("opcodes", opcodes), ("dppns", dppns),
                        ("old_dppns", old_dppns)):
            _build.require(t, name, device=dev, dtype=i32, shape=(bq,))
        out = torch.empty(bq, dtype=i32, device=dev)
        blocks = None
    ok = torch.empty(bq, dtype=b8, device=dev)
    if bq == 0:
        return out, ok, blocks
    tensors = {"tags": st.tags, "valid": st.valid, "ref": st.ref,
               "clock": st.clock, "data": st.data, "backing": st.backing,
               "stats": st.stats, "table": table, "commit_seq": commit_seq,
               "free_stack": free_stack, "free_n": free_n, "oob": oob,
               "live": live, "refcnt": refcnt}
    strides = [tensors[n].stride(0) if stacked and tensors[n] is not None
               else 0 for n in _SHARDED]

    def ptr(t):
        return t.data_ptr() if t is not None else None
    lib = _build.load("fmmu_commit", _ARGTYPES)
    per = len(lead)
    err = lib.fmmu_commit_launch(
        *(ptr(t) for t in (st.tags, st.valid, st.ref, st.clock, st.data,
                           st.backing, st.stats, table, commit_seq,
                           free_stack, free_n, oob, grow, opcodes, dlpns,
                           dppns, old_dppns, out, ok, blocks, live,
                           refcnt)),
        n_device, s, w, e, st.backing.shape[per],
        table.shape[per] if table is not None else 0,
        free_stack.shape[per] if free_stack is not None else 0,
        bq, q_cap, nb, lead[0] if stacked else 0, *strides,
        _build.stream_ptr(dlpns))
    _build.check(lib, "fmmu_commit", err)
    LAUNCHES[0] += 1
    return out, ok, blocks
