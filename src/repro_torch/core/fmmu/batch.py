"""Batched FMMU translation engine: port of ``repro/core/fmmu/batch.py``
(the single-probe path, its serving wrapper, the channel-sharded map
on one device, and the unfused three-call reference path).

``translate_batch`` services a mixed batch of LOOKUP / UPDATE /
COND_UPDATE lanes with exactly ONE CMT probe and ONE insert pass (one
sort on a packed int32 key). All lanes read the pre-batch mapping; the
writes apply together afterwards. Duplicate write dlpns in one batch
are a caller contract violation; duplicate cache blocks are merged into
one fill (the paper's MSHR merge).

A map commit (``translate_batch``, ``translate_serving``,
``serving_grow``) is one ``ops.fmmu_commit`` launch on the card: pop,
probe, write-through, insert pass and table commit together. Its plain
version is ``commit_chain``, the chain of torch ops below, which a CPU
tensor or ``impl="ref"`` takes. The in-place entries
(``translate_batch_``, ``translate_serving_``, ``serving_grow_``)
update the state's tensors, as XLA does with donated buffers; the
functional ones clone the state first and return the clone, so the
tensors they were given are not modified.

Every leaf keeps the reference's dtype (int32 map lanes, bool flags) and
is compared with it bit for bit. Three torch/jnp gaps are closed in the
chain:
  * jnp scatters with ``mode="drop"`` mark a lane "no write" with an
    out-of-range index; here the masked lanes write into one spare slot
    past the end of a copy that is then cut back (``_set_where``), which
    needs no host sync and no device assert;
  * jnp gathers clamp out-of-range indices; here they are clamped
    explicitly;
  * torch's integer sums and cumsums return int64; results are cast
    back to int32 where the reference keeps int32.
Nothing here reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.core.fmmu.types import (COND_UPDATE, HOST_BASE,
                                         FMMUGeometry, LOOKUP, NIL, UPDATE)
from repro_torch.kernels import ops

I = torch.int32
BIG = torch.iinfo(torch.int32).max

# bumped once per CMT probe / insert pass executed (a map commit is one
# of each, whichever lowering runs it)
PROBE_CALLS = COUNTERS.cell("fmmu.probe_calls")
INSERT_CALLS = COUNTERS.cell("fmmu.insert_calls")


class BatchFMMUState(NamedTuple):
    tags: torch.Tensor      # [S,W] block id or NIL
    valid: torch.Tensor     # [S,W] bool
    ref: torch.Tensor       # [S,W] bool (second-chance approximation)
    clock: torch.Tensor     # [S]
    data: torch.Tensor      # [S,W,E]
    backing: torch.Tensor   # [n_tvpns * entries_per_tp] full map table
    stats: torch.Tensor     # [4] hits, misses, unique_fills, updates


def init_batch_state(g: FMMUGeometry,
                     device: torch.device) -> BatchFMMUState:
    s, w = g.cmt_sets, g.cmt_ways
    return BatchFMMUState(
        tags=torch.full((s, w), NIL, dtype=I, device=device),
        valid=torch.zeros((s, w), dtype=torch.bool, device=device),
        ref=torch.zeros((s, w), dtype=torch.bool, device=device),
        clock=torch.zeros((s,), dtype=I, device=device),
        data=torch.full((s, w, g.cmt_entries), NIL, dtype=I, device=device),
        backing=torch.full((g.n_tvpns * g.entries_per_tp,), NIL, dtype=I,
                           device=device),
        stats=torch.zeros((4,), dtype=I, device=device),
    )


def _n_blocks(g: FMMUGeometry) -> int:
    return g.n_tvpns * g.entries_per_tp // g.cmt_entries


def _set_where(buf: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """``buf`` with rows ``idx[mask]`` set to ``vals[mask]`` (the jnp
    ``.at[where(mask, idx, OOB)].set(vals, mode="drop")``), computed on
    a copy with one spare row: unmasked lanes write the spare row, which
    is cut off again. Masked indices must be unique and in range, or
    out of range to be dropped."""
    n = buf.shape[0]
    ext = torch.cat([buf, buf.new_empty((1,) + tuple(buf.shape[1:]))])
    keep = mask & (idx >= 0) & (idx < n)
    ext[torch.where(keep, idx, n).long()] = vals.to(buf.dtype)
    return ext[:n]


def _insert_blocks(g: FMMUGeometry, st: BatchFMMUState, miss_bids, prio):
    """Insert up to W distinct missing blocks per set (vectorized).

    miss_bids [Bq] block ids (BIG = no miss); prio [Bq] insert-order
    class (LOOKUP=0, UPDATE=1, COND_UPDATE=2). One sort on the packed
    key (set*4 + prio) * ceil(NB/S) + bid//S orders the misses by set,
    priority and block id; equal keys are exactly the duplicate block
    ids, so the sort needs no stability. Set segments give each block
    its insertion rank; ranks >= W overflow and stay uncached."""
    dev = miss_bids.device
    s_cnt, w_cnt, e = g.cmt_sets, g.cmt_ways, g.cmt_entries
    nb = _n_blocks(g)
    q_cap = -(-nb // s_cnt)
    assert 4 * q_cap * (s_cnt + 1) < BIG, "packed insert key overflows"
    is_miss = miss_bids != BIG
    safe_bid = torch.where(is_miss, miss_bids, 0)
    # collapse priority per block id (scatter-min): duplicates of one
    # block carry one key and sort adjacently. A spare slot at nb takes
    # the dropped lanes (bid >= nb); reads clamp like a jnp gather.
    pbuf = torch.full((nb + 1,), 3, dtype=I, device=dev)
    pidx = torch.where(is_miss & (safe_bid < nb), safe_bid, nb).long()
    pbuf.scatter_reduce_(0, pidx, torch.where(is_miss, prio, 3).to(I),
                         reduce="amin", include_self=True)
    prio_eff = pbuf[safe_bid.clamp(0, nb - 1).long()]
    key = ((torch.remainder(safe_bid, s_cnt) * 4 + prio_eff) * q_cap
           + torch.div(safe_bid, s_cnt, rounding_mode="floor"))
    gkey = torch.sort(torch.where(is_miss, key, BIG)).values
    real = gkey != BIG
    gsets = torch.where(real, torch.div(gkey, 4 * q_cap,
                                        rounding_mode="floor"), s_cnt).to(I)
    gbids = torch.where(real, torch.remainder(gkey, q_cap) * s_cnt + gsets,
                        BIG).to(I)
    first = torch.ones_like(real)
    first[1:] = gkey[1:] != gkey[:-1]
    kept = first & (gsets < s_cnt)
    # rank within the set segment, counting kept (unique) entries only
    kept_i = kept.to(I)
    cf = torch.cumsum(kept_i, 0, dtype=I) - kept_i        # exclusive prefix
    # jnp.bincount(length=S+1) drops a set past S (the key of a block id
    # far past the map); a spare bin at S+1 takes it here
    counts = torch.zeros(s_cnt + 2, dtype=I, device=dev).index_add_(
        0, torch.where((gsets >= 0) & (gsets <= s_cnt), gsets,
                       s_cnt + 1).long(), torch.ones_like(gsets))[:s_cnt + 1]
    offs = torch.cumsum(counts, 0, dtype=I) - counts      # segment starts
    seg_start = offs[gsets.clamp(0, s_cnt).long()].clamp(
        0, gsets.shape[0] - 1)
    rank = cf - cf[seg_start.long()]
    keep = kept & (rank < w_cnt)
    way = torch.remainder(st.clock[gsets.clamp(0, s_cnt - 1).long()] + rank,
                          w_cnt).to(I)
    # gather fresh block contents from backing
    base = torch.where(keep, gbids, 0) * e
    idx = base[:, None] + torch.arange(e, dtype=I, device=dev)[None, :]
    fresh = st.backing[idx.clamp(0, st.backing.shape[0] - 1).long()]
    flat = gsets * w_cnt + way
    sw = s_cnt * w_cnt
    tags = _set_where(st.tags.reshape(-1), flat,
                      torch.where(keep, gbids, 0), keep).reshape(s_cnt, w_cnt)
    ones = torch.ones_like(keep)
    valid = _set_where(st.valid.reshape(-1), flat, ones, keep).reshape(
        s_cnt, w_cnt)
    ref = _set_where(st.ref.reshape(-1), flat, ones, keep).reshape(
        s_cnt, w_cnt)
    data = _set_where(st.data.reshape(sw, e), flat, fresh, keep).reshape(
        s_cnt, w_cnt, e)
    ins_per_set = torch.zeros(s_cnt + 1, dtype=I, device=dev).index_add_(
        0, torch.where(keep, gsets, s_cnt).long(), torch.ones_like(gsets))
    clock = torch.remainder(st.clock + ins_per_set[:s_cnt], w_cnt).to(I)
    n_fill = keep.sum(dtype=I)
    stats = st.stats.clone()
    stats[2] += n_fill
    return st._replace(tags=tags, valid=valid, ref=ref, data=data,
                       clock=clock, stats=stats), n_fill


def translate_batch(g: FMMUGeometry, st: BatchFMMUState, opcodes, dlpns,
                    dppns, old_dppns, impl=None
                    ) -> Tuple[BatchFMMUState, torch.Tensor, torch.Tensor]:
    """Fused mixed-op translate: ONE CMT probe, ONE insert pass.

    opcodes [Bq] in {LOOKUP, UPDATE, COND_UPDATE}; dlpns [Bq] (-1 =
    inactive lane); dppns [Bq] new mapping for write lanes; old_dppns
    [Bq] compare value for COND_UPDATE lanes. Returns (state, out, ok):
    out is the pre-batch mapping (NIL when unmapped/inactive); ok says
    whether a COND_UPDATE lane's guarded write applied, ``active`` for
    other lanes."""
    st = clone_state(st)
    out, ok = translate_batch_(g, st, opcodes, dlpns, dppns, old_dppns,
                               impl=impl)
    return st, out, ok


def translate_batch_(g: FMMUGeometry, st: BatchFMMUState, opcodes, dlpns,
                     dppns, old_dppns, impl=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``translate_batch`` in place on ``st``'s tensors: (out, ok)."""
    out, ok, _ = _commit(g, st, dlpns, impl, opcodes=opcodes, dppns=dppns,
                         old_dppns=old_dppns)
    return out, ok


def _commit(g: FMMUGeometry, ms, dlpns, impl, **lanes):
    """One map commit in place (``ops.fmmu_commit``): one probe and one
    insert pass per channel, whichever lowering runs it."""
    n = n_channels(ms)
    PROBE_CALLS[0] += n
    INSERT_CALLS[0] += n
    return ops.fmmu_commit(g, ms, dlpns, impl=impl, **lanes)


def n_channels(ms) -> int:
    """Channels of a map state: the leading axis of a stacked state's
    CMT tags ([C, S, W]), 1 for an unstacked one ([S, W])."""
    tags = ms.fmmu.tags if isinstance(ms, ServingMapState) else ms.tags
    return tags.shape[0] if tags.dim() == 3 else 1


def shard(ms: ServingMapState, c: int) -> ServingMapState:
    """Channel ``c``'s shard of a stacked state, as views of its
    tensors (writes to them land in the stacked state)."""
    return ServingMapState(BatchFMMUState(*(t[c] for t in ms.fmmu)), *(
        t[c] if t is not None else None for t in ms[1:]))


def state_tensors(ms) -> list:
    """The tensor leaves of a BatchFMMUState or ServingMapState, in a
    fixed order (the map state's, then the serving lanes')."""
    if isinstance(ms, ServingMapState):
        return list(ms.fmmu) + [t for t in ms[1:] if t is not None]
    return list(ms)


def clone_state(ms):
    """A copy of a BatchFMMUState or ServingMapState, tensor by tensor."""
    if isinstance(ms, ServingMapState):
        return ServingMapState(clone_state(ms.fmmu), *(
            t.clone() if t is not None else None for t in ms[1:]))
    return BatchFMMUState(*(t.clone() for t in ms))


def _translate_core(g: FMMUGeometry, st: BatchFMMUState, opcodes, dlpns,
                    dppns, old_dppns):
    """The chain's translate: the ``fmmu_translate`` probe's plain
    version, then the write-through, stats and insert pass as torch ops.
    Also returns the commit mask ``write`` (lanes whose dppn entered the
    map)."""
    e = g.cmt_entries
    active = dlpns >= 0
    is_l = opcodes == LOOKUP
    is_u = opcodes == UPDATE
    is_c = opcodes == COND_UPDATE
    # probed lanes (LOOKUP + COND) count hit/miss stats AND touch the
    # ref bit on a hit
    probed = active & (is_l | is_c)
    hit, cur, set_idx, way, refbits = ops.fmmu_translate(
        st.tags, st.valid, st.ref, st.data, st.backing, dlpns, probed,
        entries_per_block=e, impl="ref")
    ok = torch.where(is_c, active & (cur == old_dppns), active)
    write = (is_u & active) | (is_c & ok)
    # write-through to the backing table
    backing = _set_where(st.backing, dlpns, dppns, write)
    # update cached copies where the block is resident
    off = torch.remainder(torch.where(active, dlpns, 0), e)
    flat = (set_idx * g.cmt_ways + way) * e + off
    data = _set_where(st.data.reshape(-1), flat, dppns,
                      write & hit).reshape(st.data.shape)
    stats = st.stats + torch.stack([(probed & hit).sum(dtype=I),
                                    (probed & ~hit).sum(dtype=I),
                                    torch.zeros((), dtype=I,
                                                device=dlpns.device),
                                    write.sum(dtype=I)])
    st = st._replace(backing=backing, data=data, ref=refbits, stats=stats)
    # single insert pass for every miss, MSHR-merged; write-allocate for
    # UPDATE/COND lanes pulls post-write backing contents
    miss_bids = torch.where(active & ~hit,
                            torch.div(dlpns, e, rounding_mode="floor"),
                            BIG).to(I)
    prio = torch.where(is_l, 0, torch.where(is_u, 1, 2)).to(I)
    st, _ = _insert_blocks(g, st, miss_bids, prio)
    return st, torch.where(active, cur, NIL).to(I), ok, write


# ------------------------------------------------------ serving wrapper
class ServingMapState(NamedTuple):
    """FMMU state + the device-resident serving block table + allocator
    lanes, as in the reference. ``table`` holds the current dlpn->dppn
    mapping (NIL when unmapped), maintained by ``translate_serving`` in
    the same commit that writes the map. ``free_stack[:free_n]`` mirror
    the host pool's free list (index i == list index i). ``live`` and
    ``refcnt`` (GC and prefix sharing) are not ported and stay None."""
    fmmu: BatchFMMUState
    table: torch.Tensor
    free_stack: torch.Tensor   # [n_device] int32 free device block ids
    free_n: torch.Tensor       # [] int32 live stack depth
    host_stack: torch.Tensor   # [n_host] int32 free host block ids
    host_n: torch.Tensor       # [] int32
    oob: torch.Tensor          # [] bool, sticky OutOfBlocks flag
    swap_pending: torch.Tensor  # [n_lanes] bool host-tier residency lane
    commit_seq: torch.Tensor   # [] int32 committed write lanes
    live: Optional[torch.Tensor] = None
    refcnt: Optional[torch.Tensor] = None


def init_serving_state(g: FMMUGeometry, n_device_blocks: int = 0,
                       n_lanes: int = 0, *, n_host_blocks: int = 0,
                       device: torch.device) -> ServingMapState:
    """Stack order mirrors BlockPool: index i holds block n-1-i, so the
    first pop yields block 0 (HOST_BASE for the host stack)."""
    return ServingMapState(
        fmmu=init_batch_state(g, device),
        table=torch.full((g.n_tvpns * g.entries_per_tp,), NIL, dtype=I,
                         device=device),
        free_stack=torch.arange(n_device_blocks - 1, -1, -1, dtype=I,
                                device=device),
        free_n=torch.tensor(n_device_blocks, dtype=I, device=device),
        host_stack=torch.arange(HOST_BASE + n_host_blocks - 1,
                                HOST_BASE - 1, -1, dtype=I, device=device),
        host_n=torch.tensor(n_host_blocks, dtype=I, device=device),
        oob=torch.tensor(False, device=device),
        swap_pending=torch.zeros((n_lanes,), dtype=torch.bool,
                                 device=device),
        commit_seq=torch.tensor(0, dtype=I, device=device))


def translate_serving(g: FMMUGeometry, ms: ServingMapState, opcodes,
                      dlpns, dppns, old_dppns, impl=None
                      ) -> Tuple[ServingMapState, torch.Tensor, torch.Tensor]:
    """``translate_batch`` + incremental block-table maintenance: the
    lanes whose write committed (the core's ``write`` mask) scatter
    their new dppn into ``ms.table``, and ``commit_seq`` counts them.
    No extra probe, no extra sort."""
    ms = clone_state(ms)
    out, ok = translate_serving_(g, ms, opcodes, dlpns, dppns, old_dppns,
                                 impl=impl)
    return ms, out, ok


def translate_serving_(g: FMMUGeometry, ms: ServingMapState, opcodes,
                       dlpns, dppns, old_dppns, impl=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``translate_serving`` in place on ``ms``'s tensors: (out, ok)."""
    out, ok, _ = _commit(g, ms, dlpns, impl, opcodes=opcodes, dppns=dppns,
                         old_dppns=old_dppns)
    return out, ok


def commit_chain(g: FMMUGeometry, ms, dlpns, *, opcodes=None, dppns=None,
                 old_dppns=None, grow=None):
    """One map commit as a chain of torch ops: the plain version of the
    ``fmmu_commit`` kernel, the reference's code op for op. ``ms`` is a
    ServingMapState (with the table commit) or a BatchFMMUState; with
    ``grow`` (a ServingMapState's ``serving_grow``) the lanes pop their
    blocks first. Plain torch on any device (the probe too).
    Functional: returns (state, out or None, ok, blocks or None)."""
    if grow is not None:
        ms, blocks, ok = alloc_serving(ms, grow)
        dl = torch.where(ok, dlpns, -1).to(I)
        ms, _, _, _ = commit_chain(
            g, ms, dl, opcodes=torch.full_like(dl, UPDATE), dppns=blocks,
            old_dppns=torch.zeros_like(dl))
        return ms, None, ok, blocks
    serving = isinstance(ms, ServingMapState)
    st, out, ok, write = _translate_core(g, ms.fmmu if serving else ms,
                                         opcodes, dlpns, dppns, old_dppns)
    if not serving:
        return st, out, ok, None
    table = _set_where(ms.table, dlpns, dppns, write)
    return ms._replace(fmmu=st, table=table,
                       commit_seq=ms.commit_seq + write.sum(dtype=I)), \
        out, ok, None


def oob_vec(ms: ServingMapState) -> torch.Tensor:
    """The sticky OutOfBlocks flag as a [C] vector ([1] for the
    unsharded state, whose flag is a scalar): the one read layout of
    every boundary observer (``KVPageManager.observe_exhaustion``)."""
    return torch.atleast_1d(ms.oob)


def commit_seq_vec(ms: ServingMapState) -> torch.Tensor:
    """The committed-lane counter as a [C] vector ([1] unsharded); its
    sum is the map's committed write lanes (``ServeEngine._device_lanes``)."""
    return torch.atleast_1d(ms.commit_seq)


# ------------------------------------------------- device allocator ops
# Pure transitions on the allocator lanes, as in the reference. None of
# them reads a value back to the host, so a K-step decode program that
# calls them can be captured into one CUDA graph.
def alloc_serving(ms: ServingMapState, want
                  ) -> Tuple[ServingMapState, torch.Tensor, torch.Tensor]:
    """Pop one device block per requesting lane. want [B] bool; the
    lane of rank r among the requesters gets ``free_stack[free_n-1-r]``
    (the host ``BlockPool.alloc`` order). Lanes past the stack's depth
    fail (ok False, block NIL) and raise the sticky ``oob`` flag.
    Returns (state, blocks [B] int32, ok [B] bool). With no lane
    requesting, every lane of the state keeps its value."""
    want = want.bool()
    wi = want.to(I)
    rank = torch.cumsum(wi, 0, dtype=I) - wi
    idx = ms.free_n - 1 - rank
    ok = want & (idx >= 0)
    cap = ms.free_stack.shape[0]
    if cap:
        picked = ms.free_stack[idx.clamp(0, cap - 1).long()]
    else:
        picked = torch.full(want.shape, NIL, dtype=I, device=want.device)
    blocks = torch.where(ok, picked, NIL).to(I)
    return ms._replace(free_n=ms.free_n - ok.sum(dtype=I),
                       oob=ms.oob | (want & ~ok).any()), blocks, ok


def free_serving(ms: ServingMapState, blocks) -> ServingMapState:
    """Push blocks back onto their tier stacks in lane order (the host
    ``BlockPool.free`` appends). blocks [B] int32, NIL lanes ignored,
    tier routed by HOST_BASE; pushes past a stack's capacity drop. No
    caller, as in the reference (a swap frees on the host pool and the
    next ``set_allocator`` re-push carries it): held bit-identical to
    the reference's for parity."""
    valid = blocks >= 0
    is_host = valid & (blocks >= HOST_BASE)
    is_dev = valid & ~is_host
    di, hi = is_dev.to(I), is_host.to(I)
    drank = torch.cumsum(di, 0, dtype=I) - di
    hrank = torch.cumsum(hi, 0, dtype=I) - hi
    return ms._replace(
        free_stack=_set_where(ms.free_stack, ms.free_n + drank, blocks,
                              is_dev),
        free_n=ms.free_n + di.sum(dtype=I),
        host_stack=_set_where(ms.host_stack, ms.host_n + hrank, blocks,
                              is_host),
        host_n=ms.host_n + hi.sum(dtype=I))


def set_allocator(ms: ServingMapState, free_stack, free_n, host_stack,
                  host_n, swap_pending) -> ServingMapState:
    """Overwrite the allocator tiers and the residency lane
    (``swap_pending``) from the (authoritative) host pool and clear the
    OutOfBlocks flag: the macro-step-boundary resync."""
    dev = ms.free_n.device

    def t(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)
    return ms._replace(
        free_stack=t(free_stack, I), free_n=t(free_n, I),
        host_stack=t(host_stack, I), host_n=t(host_n, I),
        oob=torch.tensor(False, device=dev),
        swap_pending=t(swap_pending, torch.bool))


def mark_swap(ms: ServingMapState, lane, pending) -> ServingMapState:
    """Flip one slot's host-tier residency lane (a pure transition, as
    in the reference)."""
    ms = ms._replace(swap_pending=ms.swap_pending.clone())
    mark_swap_(ms, lane, pending)
    return ms


def mark_swap_(ms: ServingMapState, lane: int, pending: bool) -> None:
    """``mark_swap`` in place on ``ms.swap_pending``: one fill on the
    device with the value as a kernel argument (an indexed assignment
    would copy it from the host and wait). The swap path calls it on the
    map state the K-step graphs read, so a flip reaches their next
    replay. On a channel-stacked state ([C, n_lanes]) the lane flips in
    every channel's copy (``mark_swap_sharded``)."""
    ms.swap_pending.narrow(-1, lane, 1).fill_(bool(pending))


def serving_grow(g: FMMUGeometry, ms: ServingMapState, grow, dlpns,
                 impl=None
                 ) -> Tuple[ServingMapState, torch.Tensor, torch.Tensor]:
    """Device-side page growth: one pop per ``grow`` lane
    (``alloc_serving``) and one fused map commit of the new dlpn ->
    block mappings (``translate_serving``). A lane that could not be
    served commits nothing and raises ``oob``. With every lane masked
    the state comes back bit-identical (no pop; the commit adds zeros
    to the stats, ``commit_seq`` and the clock), which is what lets a
    captured decode program run this on every step in place of the
    reference's ``lax.cond``. Returns (state, blocks [B], ok [B])."""
    ms = clone_state(ms)
    blocks, ok = serving_grow_(g, ms, grow, dlpns, impl=impl)
    return ms, blocks, ok


def serving_grow_(g: FMMUGeometry, ms: ServingMapState, grow, dlpns,
                  impl=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``serving_grow`` in place on ``ms``'s tensors: (blocks, ok)."""
    _, ok, blocks = _commit(g, ms, dlpns, impl, grow=grow.bool())
    return blocks, ok


# ----------------------------------------------- channel-sharded map
# The paper's scalability axis: the map state is partitioned per
# channel. Logical pages stripe by the static hash owner(dlpn) = dlpn
# mod C, and each channel holds a complete ServingMapState shard: a
# 1/C-sized CMT, backing table and block-table slice, and the free
# stacks of the blocks it owns (block b belongs to channel b mod C,
# host blocks by their tier-local index), so a page and its block live
# in one channel. A sharded state is a ServingMapState whose tensors
# carry a leading [C] axis. Every per-channel transition is the
# unchanged single-probe commit: on the card one ``fmmu_commit`` launch
# of C blocks, block c committing shard c; on a CPU tensor a loop over
# the channels of ``commit_chain`` on views of the stacked tensors (the
# reference's vmap, written out). Lane results merge as the reference's
# "+1" sum does: each active lane takes its owner channel's answer, a
# lane no channel owns gets NIL / False.
def channel_of(dlpns, n_channels: int):
    """Static dlpn -> channel hash (the paper's channel striping)."""
    return torch.remainder(dlpns, n_channels)


def local_dlpn(dlpns, n_channels: int):
    """Channel-local logical page id of a global dlpn."""
    return torch.div(dlpns, n_channels, rounding_mode="floor")


def channel_stack(n_blocks: int, n_channels: int, c: int, cap: int,
                  base: int = 0) -> Tuple[np.ndarray, int]:
    """Free-stack init for one channel: the blocks it owns (global id
    mod C == c) in per-channel BlockPool order (first pop yields block
    base + c), padded with NIL to the channel-uniform capacity ``cap``.
    Returns (stack [cap] int32, depth)."""
    owned = np.asarray([base + b for b in range(n_blocks)
                        if b % n_channels == c][::-1], np.int32)
    out = np.full((cap,), NIL, np.int32)
    out[:owned.shape[0]] = owned
    return out, owned.shape[0]


def init_sharded_state(g: FMMUGeometry, n_channels: int,
                       n_device_blocks: int = 0, n_host_blocks: int = 0,
                       n_lanes: int = 0, track_live: bool = False,
                       track_refs: bool = False, *,
                       device: torch.device) -> ServingMapState:
    """C per-channel ServingMapStates stacked on a leading channel axis.
    ``g`` is the per-channel geometry (its dlpn space covers
    ceil(n_dlpns / C) local pages). Both tiers stripe by block id mod C
    with channel-uniform stack capacities ceil(n / C). The residency
    lane is replicated: every channel masks the same slots."""
    if track_live or track_refs:
        raise NotImplementedError(
            "not ported to repro_torch yet: the live and refcnt lanes "
            "(GC and prefix sharing)")
    c_n = n_channels
    dev_cap = -(-n_device_blocks // c_n)
    host_cap = -(-n_host_blocks // c_n)
    stacks = {"free": [], "host": []}
    depths = {"free": [], "host": []}
    for c in range(c_n):
        for key, n, cap, base in (("free", n_device_blocks, dev_cap, 0),
                                  ("host", n_host_blocks, host_cap,
                                   HOST_BASE)):
            stack, depth = channel_stack(n, c_n, c, cap, base)
            stacks[key].append(stack)
            depths[key].append(depth)
    one = init_serving_state(g, 0, n_lanes, device=device)

    def stacked(t):
        return t[None].expand((c_n,) + tuple(t.shape)).contiguous()

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)
    return ServingMapState(
        fmmu=BatchFMMUState(*(stacked(x) for x in one.fmmu)),
        table=stacked(one.table),
        free_stack=t(np.stack(stacks["free"]).reshape(c_n, dev_cap)),
        free_n=t(depths["free"]),
        host_stack=t(np.stack(stacks["host"]).reshape(c_n, host_cap)),
        host_n=t(depths["host"]),
        oob=stacked(one.oob), swap_pending=stacked(one.swap_pending),
        commit_seq=stacked(one.commit_seq))


def _check_sharded(ms: ServingMapState, n_channels: int) -> None:
    if ms.table.dim() != 2 or ms.table.shape[0] != n_channels:
        raise ValueError(f"expected a state stacked on {n_channels} "
                         f"channels, got a table of {tuple(ms.table.shape)}")


def translate_sharded(g: FMMUGeometry, n_channels: int, ms: ServingMapState,
                      opcodes, dlpns, dppns, old_dppns, impl=None
                      ) -> Tuple[ServingMapState, torch.Tensor, torch.Tensor]:
    """Channel-sharded ``translate_serving``: each channel services the
    lanes it owns (channel-local dlpns) with one local probe and one
    local insert pass, all channels in one commit. ``ms`` tensors carry
    a leading [C] axis. Returns (state, out, ok)."""
    ms = clone_state(ms)
    out, ok = translate_sharded_(g, n_channels, ms, opcodes, dlpns, dppns,
                                 old_dppns, impl=impl)
    return ms, out, ok


def translate_sharded_(g: FMMUGeometry, n_channels: int,
                       ms: ServingMapState, opcodes, dlpns, dppns,
                       old_dppns, impl=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``translate_sharded`` in place on ``ms``'s tensors: (out, ok)."""
    _check_sharded(ms, n_channels)
    out, ok, _ = _commit(g, ms, dlpns, impl, opcodes=opcodes, dppns=dppns,
                         old_dppns=old_dppns)
    return out, ok


def grow_sharded(g: FMMUGeometry, n_channels: int, ms: ServingMapState,
                 grow, dlpns, impl=None
                 ) -> Tuple[ServingMapState, torch.Tensor, torch.Tensor]:
    """Channel-sharded ``serving_grow``: each growth lane pops from its
    owner channel's free stack and commits through that channel's map;
    a dry channel fails only its own lanes and raises only its own
    ``oob``. Returns (state, blocks [B] (NIL where the pop failed), ok)."""
    ms = clone_state(ms)
    blocks, ok = grow_sharded_(g, n_channels, ms, grow, dlpns, impl=impl)
    return ms, blocks, ok


def grow_sharded_(g: FMMUGeometry, n_channels: int, ms: ServingMapState,
                  grow, dlpns, impl=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``grow_sharded`` in place on ``ms``'s tensors: (blocks, ok)."""
    _check_sharded(ms, n_channels)
    _, ok, blocks = _commit(g, ms, dlpns, impl, grow=grow.bool())
    return blocks, ok


def set_allocator_sharded(ms: ServingMapState, free_stack, free_n,
                          host_stack, host_n, swap_pending=None
                          ) -> ServingMapState:
    """``set_allocator`` on a channel-stacked state: the tier stacks
    arrive as [C, cap] rows (host pool order), the per-channel
    OutOfBlocks flags clear, and the residency lane refreshes in every
    channel's copy."""
    dev = ms.free_n.device

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    sp = ms.swap_pending
    if swap_pending is not None:
        sp = t(swap_pending, torch.bool)[None].expand(
            tuple(sp.shape)).contiguous()
    return ms._replace(
        free_stack=t(free_stack, I), free_n=t(free_n, I),
        host_stack=t(host_stack, I), host_n=t(host_n, I),
        oob=torch.zeros_like(ms.oob), swap_pending=sp)


# the reference's name: ``mark_swap`` flips the lane in every channel's
# copy of a stacked state
mark_swap_sharded = mark_swap


def interleave_table(table: torch.Tensor, n: int) -> torch.Tensor:
    """The one home of the shard-interleave layout: a [C, L] stack of
    per-channel table shards flattens to global dlpn order (global d
    lives at shard [d mod C, d // C]); a flat [L] table (unstacked)
    passes through, cut to ``n``. Every reader of the striped layout
    (``dense_table``, the engine's decode paths, the sharded
    retranslation) goes through here."""
    if table.dim() == 1:
        return table[:n]
    return table.t().reshape(-1)[:n]


def dense_table(ms: ServingMapState, n: int) -> torch.Tensor:
    """The global block table of a (possibly channel-stacked) serving
    state: ``interleave_table`` on ``ms.table``. The layout follows the
    table's rank, so a stacked C = 1 state ([1, L]) reads right too."""
    return interleave_table(ms.table, n)


# ------------------------------------------------------------ wrappers
def lookup_batch(g: FMMUGeometry, st: BatchFMMUState, dlpns, impl=None
                 ) -> Tuple[BatchFMMUState, torch.Tensor]:
    """Translate a batch of DLPNs (-1 = inactive). Misses are served
    from backing in the same step and filled into the cache."""
    z = torch.zeros_like(dlpns)
    st, out, _ = translate_batch(g, st, torch.full_like(dlpns, LOOKUP),
                                 dlpns, z, z, impl=impl)
    return st, out


def update_batch(g: FMMUGeometry, st: BatchFMMUState, dlpns, dppns,
                 impl=None) -> BatchFMMUState:
    """Write-through batched Update."""
    st, _, _ = translate_batch(g, st, torch.full_like(dlpns, UPDATE),
                               dlpns, dppns, torch.zeros_like(dlpns),
                               impl=impl)
    return st


def cond_update_batch(g: FMMUGeometry, st: BatchFMMUState, dlpns, dppns,
                      old_dppns, impl=None):
    """Batched CondUpdate: apply only where the current mapping still
    equals old_dppn. Returns (state, applied mask)."""
    st, _, ok = translate_batch(g, st, torch.full_like(dlpns, COND_UPDATE),
                                dlpns, dppns, old_dppns, impl=impl)
    return st, ok


# ----------------------------------------------------------------------
# Unfused reference path: the pre-fusion implementation (one probe per
# op kind, CondUpdate = lookup + update = 2 probes + 2 insert passes,
# each insert paying a full sort and a stable argsort). The software-
# style baseline of the fused path; a mixed batch split into the three
# calls leaves the state bit-identical to ``translate_batch`` on the
# batches where the split is order-insensitive (tests/
# test_torch_fmmu.py). New callers use translate_batch.
# ----------------------------------------------------------------------
def _probe_unfused(g: FMMUGeometry, st: BatchFMMUState, dlpns, impl=None):
    PROBE_CALLS[0] += 1
    return ops.fmmu_lookup(st.tags, st.valid, st.data, dlpns,
                           entries_per_block=g.cmt_entries, impl=impl)


def _insert_blocks_unfused(g: FMMUGeometry, st: BatchFMMUState, miss_bids):
    """Pre-fusion insert: dedup via a full sort, then a stable argsort
    by set; ranks >= W overflow and stay uncached."""
    INSERT_CALLS[0] += 1
    dev = miss_bids.device
    s_cnt, w_cnt, e = g.cmt_sets, g.cmt_ways, g.cmt_entries
    sorted_b = torch.sort(miss_bids).values
    first = torch.ones_like(sorted_b, dtype=torch.bool)
    first[1:] = sorted_b[1:] != sorted_b[:-1]
    uniq = torch.where(first & (sorted_b != BIG), sorted_b, BIG)
    usets = torch.where(uniq != BIG, torch.remainder(uniq, s_cnt),
                        s_cnt).to(I)
    order = torch.sort(usets, stable=True).indices
    gsets = usets[order]
    gbids = uniq[order]
    counts = torch.zeros(s_cnt + 1, dtype=I, device=dev).index_add_(
        0, gsets.long(), torch.ones_like(gsets))
    offs = torch.cumsum(counts, 0, dtype=I) - counts
    rank = torch.arange(gsets.shape[0], dtype=I, device=dev) - \
        offs[gsets.long()]
    keep = (gsets < s_cnt) & (rank < w_cnt)
    way = torch.remainder(st.clock[gsets.clamp(0, s_cnt - 1).long()] + rank,
                          w_cnt).to(I)
    base = torch.where(keep, gbids, 0) * e
    idx = base[:, None] + torch.arange(e, dtype=I, device=dev)[None, :]
    fresh = st.backing[idx.clamp(0, st.backing.shape[0] - 1).long()]
    flat = torch.where(keep, gsets, s_cnt - 1) * w_cnt + \
        torch.where(keep, way, 0)
    sw = s_cnt * w_cnt
    tags = _set_where(st.tags.reshape(-1), flat, gbids, keep).reshape(
        s_cnt, w_cnt)
    ones = torch.ones_like(keep)
    valid = _set_where(st.valid.reshape(-1), flat, ones, keep).reshape(
        s_cnt, w_cnt)
    ref = _set_where(st.ref.reshape(-1), flat, ones, keep).reshape(
        s_cnt, w_cnt)
    data = _set_where(st.data.reshape(sw, e), flat, fresh, keep).reshape(
        s_cnt, w_cnt, e)
    ins_per_set = torch.zeros(s_cnt + 1, dtype=I, device=dev).index_add_(
        0, torch.where(keep, gsets, s_cnt).long(), torch.ones_like(gsets))
    clock = torch.remainder(st.clock + ins_per_set[:s_cnt], w_cnt).to(I)
    n_fill = keep.sum(dtype=I)
    stats = st.stats.clone()
    stats[2] += n_fill
    return st._replace(tags=tags, valid=valid, ref=ref, data=data,
                       clock=clock, stats=stats), n_fill


def lookup_batch_unfused(g: FMMUGeometry, st: BatchFMMUState, dlpns,
                         impl=None) -> Tuple[BatchFMMUState, torch.Tensor]:
    hit, dppn, set_idx, way = _probe_unfused(g, st, dlpns, impl=impl)
    active = dlpns >= 0
    miss = active & ~hit
    backing_val = st.backing[dlpns.clamp(0, st.backing.shape[0] - 1).long()]
    out = torch.where(hit, dppn, torch.where(active, backing_val, NIL))
    ref = _set_where(st.ref.reshape(-1), set_idx * g.cmt_ways + way,
                     torch.ones_like(hit), hit).reshape(st.ref.shape)
    stats = st.stats + torch.stack([
        hit.sum(dtype=I), miss.sum(dtype=I),
        torch.zeros((), dtype=I, device=dlpns.device),
        torch.zeros((), dtype=I, device=dlpns.device)])
    st = st._replace(ref=ref, stats=stats)
    miss_bids = torch.where(
        miss, torch.div(dlpns, g.cmt_entries, rounding_mode="floor"),
        BIG).to(I)
    st, _ = _insert_blocks_unfused(g, st, miss_bids)
    return st, out.to(I)


def update_batch_unfused(g: FMMUGeometry, st: BatchFMMUState, dlpns, dppns,
                         impl=None) -> BatchFMMUState:
    active = dlpns >= 0
    stats = st.stats.clone()
    stats[3] += active.sum(dtype=I)
    st = st._replace(backing=_set_where(st.backing, dlpns, dppns, active),
                     stats=stats)
    hit, _, set_idx, way = _probe_unfused(g, st, dlpns, impl=impl)
    off = torch.remainder(torch.where(active, dlpns, 0), g.cmt_entries)
    flat = (set_idx * g.cmt_ways + way) * g.cmt_entries + off
    data = _set_where(st.data.reshape(-1), flat, dppns, hit).reshape(
        st.data.shape)
    st = st._replace(data=data)
    miss_bids = torch.where(
        active & ~hit, torch.div(dlpns, g.cmt_entries, rounding_mode="floor"),
        BIG).to(I)
    st, _ = _insert_blocks_unfused(g, st, miss_bids)
    return st


def cond_update_batch_unfused(g: FMMUGeometry, st: BatchFMMUState, dlpns,
                              dppns, old_dppns, impl=None):
    st2, cur = lookup_batch_unfused(g, st, dlpns, impl=impl)
    ok = (cur == old_dppns) & (dlpns >= 0)
    eff = torch.where(ok, dlpns, -1).to(I)
    st3 = update_batch_unfused(g, st2, eff, dppns, impl=impl)
    return st3, ok
