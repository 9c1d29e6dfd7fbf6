"""The FMMU packet engine: the plain torch version of the machine, and the
host-side engine that runs it on the card through the ``fmmu_fsm``
kernel.

Port of ``repro/core/fmmu/engine.py``, helper by helper: the same
deterministic policies and packet/arbitration semantics as the oracle
(``oracle.py``), over the fixed-shape tensors of ``FMMUState``. One
``step`` is one arbitration round: one packet, or one watermark flush or
write-back action, like the hardware pipeline. ``run`` drives steps
until the machine is quiescent or blocked.

Here ``lax.cond`` / ``switch`` become Python branches on scalar reads,
and every update is in place: ``step(g, st)`` and ``run(g, st, ...)``
change ``st``'s tensors and return the code / the step count. That is
the plain version; on a CUDA state each read would sync the host, so
``FMMUEngine`` runs ``run`` on the card as one launch of the hand-written
kernel (``kernels/fmmu_fsm.py``) and uses this version on the CPU, or on
the card when asked (``kernel_impl="ref"``).

The reference's index semantics are kept where an index comes from data:
a jnp gather normalizes a negative index once and clamps it, a scatter
drops an out-of-range write (``_rd`` / ``_wr``): a page programmed at
``tppn >= tppn_cap`` is dropped, and a read of it returns page
``tppn_cap - 1``; a chunk slice's start is clamped as ``lax.dynamic_slice``
clamps it. Every ``%`` and ``//`` is Python's floor form, as jnp's.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.fmmu import state as S
from repro_torch.core.fmmu.state import (BLOCKED, F_DIRTY, F_REF, F_TRANS,
                                         F_VALID, IDLE, INT32_MAX, Q_CTP_REQ,
                                         Q_CTP_RESP, Q_FC_RESP, Q_GCM, Q_HRM,
                                         WORKED, FMMUState)
from repro_torch.core.fmmu.types import (COND_UPDATE, FC_READ_RESP,
                                         FLUSH_BLK, LOAD, LOAD_RESP, LOOKUP,
                                         M_COND, M_FLUSH, M_LOAD, M_LOOKUP,
                                         M_UPDATE, NIL, FMMUGeometry,
                                         Request, Response, ST_OK, ST_STALE,
                                         UPDATE)
from repro_torch.device import resolve_device
from repro_torch.kernels import fmmu_fsm

(ST_HIT, ST_MISS, ST_MERGE, ST_STALL, ST_FTV, ST_FBLK, ST_FC, ST_PROG,
 ST_STEPS, ST_CHIT, ST_CMISS) = range(11)

I32 = torch.int32


# ----------------------------------------------------------------------
# index semantics of the reference's gathers and scatters
# ----------------------------------------------------------------------
def _rd(i: int, n: int) -> int:
    """A gather's index: a negative one counts from the end once, then
    it is clamped into [0, n)."""
    if i < 0:
        i += n
    return min(max(i, 0), n - 1)


def _wr(i: int, n: int) -> Optional[int]:
    """A scatter's index: None (the write is dropped) when out of range
    after one normalization of a negative index."""
    if i < 0:
        i += n
    return i if 0 <= i < n else None


def _slice_start(start: int, n: int, size: int) -> int:
    """``lax.dynamic_slice`` / ``dynamic_update_slice``'s start: a
    negative one counts from the end once, then it is clamped so the
    window fits."""
    if start < 0:
        start += n
    return min(max(start, 0), n - size)


def _bump(st, idx):
    st.stats[idx] += 1


def _row(st, vals) -> torch.Tensor:
    return torch.tensor(vals, dtype=I32, device=st.stats.device)


# ----------------------------------------------------------------------
# queues
# ----------------------------------------------------------------------
def _qpush(st, q, pkt):
    cap = st.qbuf.shape[1]
    st.qbuf[q, int(st.qtail[q]) % cap] = _row(st, pkt)
    st.qtail[q] += 1


def _qpush_front(st, q, pkt):
    cap = st.qbuf.shape[1]
    st.qbuf[q, (int(st.qhead[q]) - 1) % cap] = _row(st, pkt)
    st.qhead[q] -= 1


def _qpop(st, q) -> List[int]:
    cap = st.qbuf.shape[1]
    pkt = st.qbuf[q, int(st.qhead[q]) % cap].tolist()
    st.qhead[q] += 1
    return pkt


def _pkt(g, kind, f1=NIL, f2=NIL, f3=NIL, f4=NIL, data=None) -> List[int]:
    if data is None:
        data = [NIL] * g.cmt_entries
    return [kind, f1, f2, f3, f4] + list(data)


# ----------------------------------------------------------------------
# outputs
# ----------------------------------------------------------------------
def _emit_resp(st, rid, kind, dppn, status):
    cap = st.resp_buf.shape[0]
    st.resp_buf[int(st.resp_n) % cap] = _row(st, [rid, kind, dppn, status])
    st.resp_n.add_(1)


def _emit_fc(st, tppn, s, w):
    cap = st.fc_buf.shape[0]
    st.fc_buf[int(st.fc_n) % cap] = _row(st, [tppn, s, w])
    st.fc_n.add_(1)
    _bump(st, ST_FC)


def _emit_prog(st, tvpn, tppn):
    cap = st.prog_buf.shape[0]
    st.prog_buf[int(st.prog_n) % cap] = _row(st, [tvpn, tppn])
    st.prog_n.add_(1)
    _bump(st, ST_PROG)


def _stall(st, q, pkt, front=False):
    _bump(st, ST_STALL)
    st.stalls_in_row.add_(1)
    if front:
        _qpush_front(st, q, pkt)
    else:
        _qpush(st, q, pkt)


# ----------------------------------------------------------------------
# second-chance victim selection (shared CMT/CTP)
# ----------------------------------------------------------------------
def _second_chance(flags_row: List[int], clock: int, n_ways: int
                   ) -> Tuple[bool, int, List[int], int]:
    """(found, way, new_flags_row, new_clock): scan 2W slots from the
    clock, clearing refbits until a clean, non-transient,
    non-referenced block is found."""
    fl = list(flags_row)
    found, way = False, 0
    for i in range(2 * n_ways):
        w = (clock + i) % n_ways
        f = fl[w]
        if f & (F_DIRTY | F_TRANS):
            continue
        if f & F_REF:
            fl[w] = f & ~F_REF
            continue
        found, way = True, w
        break
    new_clock = (way + 1) % n_ways if found else clock
    return found, way, fl, new_clock


# ----------------------------------------------------------------------
# DTL
# ----------------------------------------------------------------------
def _first(mask: List[bool]) -> Tuple[bool, int]:
    """(any, argmax): the first True index, 0 when none."""
    for i, m in enumerate(mask):
        if m:
            return True, i
    return False, 0


def _dtl_find(st, tvpn):
    return _first([t == tvpn for t in st.dtl_tvpn.tolist()])


def _dtl_register(g, st, s, w, tvpn):
    """Link CMT block (s,w) into the DTL chain for tvpn."""
    p = s * g.cmt_ways + w
    found, idx = _dtl_find(st, tvpn)
    if found:
        st.cmt_next[s, w] = st.dtl_head[idx]
        st.dtl_head[idx] = p
        st.dtl_ndirty[idx] += 1
        st.dtl_updated[idx] = 1
        return
    free = [t == NIL for t in st.dtl_tvpn.tolist()]
    if not any(free):
        # full: flush the oldest entry (min seq), like oracle dtl[0]
        seq = st.dtl_seq.tolist()
        _flush_tvpn(g, st, seq.index(min(seq)))
    _, slot = _first([t == NIL for t in st.dtl_tvpn.tolist()])
    st.cmt_next[s, w] = NIL
    st.dtl_tvpn[slot] = tvpn
    st.dtl_head[slot] = p
    st.dtl_ndirty[slot] = 1
    st.dtl_updated[slot] = 1
    st.dtl_seq[slot] = st.dtl_ctr
    st.dtl_ctr.add_(1)


def _flush_tvpn(g, st, idx):
    """Walk the next-link chain of DTL entry idx, emitting one FLUSH_BLK
    per dirty block (paper's O(dirty) batch flush)."""
    tvpn = int(st.dtl_tvpn[idx])
    _bump(st, ST_FTV)
    p = int(st.dtl_head[idx])
    while p != NIL:
        s, w = p // g.cmt_ways, p % g.cmt_ways
        nxt = int(st.cmt_next[s, w])
        fl = int(st.cmt_flags[s, w])
        if fl & F_DIRTY:
            chunk = int(st.cmt_tag[s, w]) % g.chunks_per_tp
            _qpush(st, Q_CTP_REQ, _pkt(g, FLUSH_BLK, tvpn, chunk,
                                       data=st.cmt_data[s, w].tolist()))
            st.cmt_flags[s, w] = fl & ~F_DIRTY
            st.cmt_next[s, w] = NIL
            st.cmt_dirty.sub_(1)
            _bump(st, ST_FBLK)
        p = nxt
    st.dtl_tvpn[idx] = NIL
    st.dtl_head[idx] = NIL
    st.dtl_ndirty[idx] = 0
    st.dtl_updated[idx] = 0
    st.dtl_seq[idx] = INT32_MAX


def _pick_flush_victim(st) -> int:
    """Greedy: max ndirty; tie -> oldest (min seq). Matches Python max()
    over registration order."""
    tv, nd, sq = (st.dtl_tvpn.tolist(), st.dtl_ndirty.tolist(),
                  st.dtl_seq.tolist())
    nd = [n if t != NIL else -1 for t, n in zip(tv, nd)]
    best = max(nd)
    seq = [q if (t != NIL and n == best) else INT32_MAX
           for t, n, q in zip(tv, nd, sq)]
    return seq.index(min(seq))


# ----------------------------------------------------------------------
# CMT
# ----------------------------------------------------------------------
def _cmt_apply(g, st, s, w, kind, off, rid, dppn, old):
    """Hit/replay application of LOOKUP/UPDATE/COND_UPDATE to block (s,w)."""
    cur = int(st.cmt_data[s, w, off])
    if kind == LOOKUP:
        _emit_resp(st, rid, LOOKUP, cur, ST_OK)
        return
    if kind == COND_UPDATE and cur != old:
        _emit_resp(st, rid, COND_UPDATE, cur, ST_STALE)
        return
    st.cmt_data[s, w, off] = dppn
    fl = int(st.cmt_flags[s, w])
    if not fl & F_DIRTY:
        st.cmt_flags[s, w] = fl | F_DIRTY
        st.cmt_dirty.add_(1)
        tvpn = int(st.cmt_tag[s, w]) // g.chunks_per_tp
        _dtl_register(g, st, s, w, tvpn)
    _emit_resp(st, rid, kind, dppn, ST_OK)


def _targeted_cmt_flush(g, st, s):
    """Free a way in set s by flushing a TVPN owning a dirty block there."""
    any_dirty, w = _first([(f & F_DIRTY) != 0
                           for f in st.cmt_flags[s].tolist()])
    if not any_dirty:
        return
    tvpn = int(st.cmt_tag[s, w]) // g.chunks_per_tp
    found, idx = _dtl_find(st, tvpn)
    if found:
        _flush_tvpn(g, st, idx)


def _mshr_kind(kind):
    return M_LOOKUP if kind == LOOKUP else M_UPDATE if kind == UPDATE \
        else M_COND


def _cmt_handle(g, st, pkt, qid):
    kind, dlpn, dppn, old, rid = pkt[:5]
    block_id = dlpn // g.cmt_entries
    s = block_id % g.cmt_sets
    off = dlpn % g.cmt_entries
    tags, flags = st.cmt_tag[s].tolist(), st.cmt_flags[s].tolist()
    found, way = _first([t == block_id and (f & (F_VALID | F_TRANS)) != 0
                         for t, f in zip(tags, flags)])
    is_trans = found and (flags[way] & F_TRANS) != 0
    mshr_row = [_mshr_kind(kind), off, rid, dppn, old]
    if is_trans:
        n = int(st.cmt_mshr_n[s, way])
        if n >= g.mshr_cap:
            _stall(st, qid, pkt)
            return
        _bump(st, ST_MERGE)
        st.cmt_mshr[s, way, n] = _row(st, mshr_row)
        st.cmt_mshr_n[s, way] = n + 1
        return
    if found:
        _bump(st, ST_HIT)
        st.cmt_flags[s, way] = flags[way] | F_REF
        _cmt_apply(g, st, s, way, kind, off, rid, dppn, old)
        return
    _bump(st, ST_MISS)
    ok, vic, new_row, new_clock = _second_chance(
        flags, int(st.cmt_clock[s]), g.cmt_ways)
    if not ok:
        _targeted_cmt_flush(g, st, s)
        _stall(st, qid, pkt)
        return
    new_row[vic] = F_TRANS | F_REF
    st.cmt_flags[s] = _row(st, new_row)
    st.cmt_clock[s] = new_clock
    st.cmt_tag[s, vic] = block_id
    st.cmt_next[s, vic] = NIL
    st.cmt_mshr[s, vic, 0] = _row(st, mshr_row)
    st.cmt_mshr_n[s, vic] = 1
    tvpn = dlpn // g.entries_per_tp
    chunk = (dlpn % g.entries_per_tp) // g.cmt_entries
    dest = s * g.cmt_ways + vic
    _qpush(st, Q_CTP_REQ, _pkt(g, LOAD, tvpn, chunk, dest))


def _cmt_fill(g, st, pkt):
    """LOAD_RESP from CTP: fill block, replay in-cache MSHRs in order."""
    dest = pkt[3]
    s, w = dest // g.cmt_ways, dest % g.cmt_ways
    st.cmt_data[s, w] = _row(st, pkt[5:5 + g.cmt_entries])
    st.cmt_flags[s, w] = (int(st.cmt_flags[s, w]) & ~F_TRANS) | F_VALID
    n = int(st.cmt_mshr_n[s, w])
    st.cmt_mshr_n[s, w] = 0
    rows = st.cmt_mshr[s, w, :n].tolist()
    for mk, off, rid, dppn, old in rows:
        kind = LOOKUP if mk == M_LOOKUP else UPDATE if mk == M_UPDATE \
            else COND_UPDATE
        _cmt_apply(g, st, s, w, kind, off, rid, dppn, old)


def _cmt_flush_needed(g, st) -> bool:
    return (g.cmt_blocks - int(st.cmt_dirty)) < g.cmt_low() and \
        bool((st.dtl_tvpn != NIL).any())


def _cmt_flush_one(g, st):
    _flush_tvpn(g, st, _pick_flush_victim(st))


# ----------------------------------------------------------------------
# CTP
# ----------------------------------------------------------------------
def _fifo_push(st, tvpn):
    """Dedup'd push: a TVPN is queued at most once (bounds occupancy by
    n_tvpns; matches oracle). Popped slots are NIL'd so the CAM scan over
    the ring cannot false-positive."""
    if bool((st.fifo == tvpn).any()):
        return
    st.fifo[int(st.fifo_tail) % st.fifo.shape[0]] = tvpn
    st.fifo_tail.add_(1)


def _ctp_apply(g, st, s, w, kind, chunk, dest, data):
    ec = g.cmt_entries
    start = _slice_start(chunk * ec, g.entries_per_tp, ec)
    if kind == LOAD:
        sl = st.ctp_data[s, w, start:start + ec].tolist()
        tvpn = int(st.ctp_tag[s, w])
        _qpush(st, Q_CTP_RESP, _pkt(g, LOAD_RESP, tvpn, chunk, dest,
                                    data=sl))
        return
    st.ctp_data[s, w, start:start + ec] = _row(st, data)
    fl = int(st.ctp_flags[s, w])
    if not fl & F_DIRTY:
        st.ctp_flags[s, w] = fl | F_DIRTY
        st.ctp_dirty.add_(1)
        _fifo_push(st, int(st.ctp_tag[s, w]))


def _ctp_fill_data(g, st, s, w, page: Optional[torch.Tensor]):
    """Fill CTP block (s,w) with ``page`` (None: never written, all NIL)
    and replay its MSHRs in order."""
    if page is None:
        st.ctp_data[s, w] = NIL
    else:
        st.ctp_data[s, w] = page
    st.ctp_flags[s, w] = (int(st.ctp_flags[s, w]) & ~F_TRANS) | F_VALID
    n = int(st.ctp_mshr_n[s, w])
    st.ctp_mshr_n[s, w] = 0
    rows = st.ctp_mshr[s, w, :n].tolist()
    for row in rows:
        mk, chunk, dest = row[:3]
        kind = LOAD if mk == M_LOAD else FLUSH_BLK
        _ctp_apply(g, st, s, w, kind, chunk, dest, row[3:3 + g.cmt_entries])


def _targeted_ctp_writeback(g, st, s):
    any_dirty, w = _first([(f & F_DIRTY) != 0 and (f & F_VALID) != 0
                           for f in st.ctp_flags[s].tolist()])
    if any_dirty:
        _writeback_block(g, st, s, w)


def _writeback_block(g, st, s, w):
    tppn = int(st.tppn_next)
    tvpn = int(st.ctp_tag[s, w])
    j = _wr(tppn, g.tppn_cap)
    if j is not None:
        st.flash_tp[j] = st.ctp_data[s, w]
    k = _wr(tvpn, g.n_tvpns)
    if k is not None:
        st.gtd[k] = tppn
    st.tppn_next.add_(1)
    st.ctp_flags[s, w] = int(st.ctp_flags[s, w]) & ~F_DIRTY
    st.ctp_dirty.sub_(1)
    _emit_prog(st, tvpn, tppn)


def _ctp_handle(g, st, pkt):
    kind, tvpn, chunk, dest = pkt[:4]
    data = pkt[5:5 + g.cmt_entries]
    s = tvpn % g.ctp_sets
    tags, flags = st.ctp_tag[s].tolist(), st.ctp_flags[s].tolist()
    found, way = _first([t == tvpn and (f & (F_VALID | F_TRANS)) != 0
                         for t, f in zip(tags, flags)])
    is_trans = found and (flags[way] & F_TRANS) != 0
    mk = M_LOAD if kind == LOAD else M_FLUSH
    mshr_row = [mk, chunk, dest] + data
    if is_trans:
        n = int(st.ctp_mshr_n[s, way])
        if n >= g.ctp_mshr_cap:
            _stall(st, Q_CTP_REQ, pkt, front=True)
            return
        _bump(st, ST_MERGE)
        st.ctp_mshr[s, way, n] = _row(st, mshr_row)
        st.ctp_mshr_n[s, way] = n + 1
        return
    if found:
        _bump(st, ST_CHIT)
        st.ctp_flags[s, way] = flags[way] | F_REF
        _ctp_apply(g, st, s, way, kind, chunk, dest, data)
        return
    _bump(st, ST_CMISS)
    ok, vic, new_row, new_clock = _second_chance(
        flags, int(st.ctp_clock[s]), g.ctp_ways)
    if not ok:
        _targeted_ctp_writeback(g, st, s)
        _stall(st, Q_CTP_REQ, pkt, front=True)
        return
    new_row[vic] = F_TRANS | F_REF
    st.ctp_flags[s] = _row(st, new_row)
    st.ctp_clock[s] = new_clock
    st.ctp_tag[s, vic] = tvpn
    st.ctp_mshr[s, vic, 0] = _row(st, mshr_row)
    st.ctp_mshr_n[s, vic] = 1
    tppn = int(st.gtd[_rd(tvpn, g.n_tvpns)])
    if tppn == NIL:
        _ctp_fill_data(g, st, s, vic, None)
    else:
        _emit_fc(st, tppn, s, vic)


def _fc_handle(g, st, pkt):
    """FC_READ_RESP: f1=tppn, f2=ctp_set, f3=ctp_way."""
    tppn, s, w = pkt[1:4]
    _ctp_fill_data(g, st, s, w, st.flash_tp[_rd(tppn, g.tppn_cap)])


def _ctp_writeback_needed(g, st) -> bool:
    return (g.ctp_blocks - int(st.ctp_dirty)) < g.ctp_low() and \
        int(st.fifo_tail) > int(st.fifo_head)


def _ctp_writeback_one(g, st) -> bool:
    """Pop stale FIFO entries until one dirty match is written back.
    Returns whether one was."""
    cap = st.fifo.shape[0]
    while int(st.fifo_tail) > int(st.fifo_head):
        pos = int(st.fifo_head) % cap
        tvpn = int(st.fifo[pos])
        st.fifo_head.add_(1)
        st.fifo[pos] = NIL
        s = tvpn % g.ctp_sets
        found, w = _first([t == tvpn and (f & F_VALID) != 0
                           and (f & F_DIRTY) != 0 for t, f in
                           zip(st.ctp_tag[s].tolist(),
                               st.ctp_flags[s].tolist())])
        if found:
            _writeback_block(g, st, s, w)
            return True
    return False


# ----------------------------------------------------------------------
# arbitration + step
# ----------------------------------------------------------------------
def _arbitrate(g, st) -> Tuple[bool, int]:
    lens = (st.qtail - st.qhead).tolist()
    credits = st.credits.tolist()
    nonempty = [n > 0 for n in lens]
    any_ne = any(nonempty)
    if any_ne and all(c <= 0 for c, ne in zip(credits, nonempty) if ne):
        credits = st.weights.tolist()
    picked, qid = _first([ne and c > 0 for ne, c in zip(nonempty, credits)])
    if picked:
        credits[qid] -= 1
    st.credits.copy_(_row(st, credits))
    return picked and any_ne, qid


def step(g: FMMUGeometry, st: FMMUState) -> int:
    """One arbitration round, in place. Returns the code (WORKED, IDLE
    or BLOCKED)."""
    _bump(st, ST_STEPS)
    # watermark work first (mirrors oracle.step)
    if _ctp_writeback_needed(g, st) and _ctp_writeback_one(g, st):
        return WORKED
    if _cmt_flush_needed(g, st):
        _cmt_flush_one(g, st)
        return WORKED
    picked, qid = _arbitrate(g, st)
    if not picked:
        return IDLE
    qlens = int((st.qtail - st.qhead).sum())
    if int(st.stalls_in_row) > qlens + 4:
        st.stalls_in_row.zero_()
        return BLOCKED
    before = int(st.stalls_in_row)
    pkt = _qpop(st, qid)
    q = min(max(qid, 0), 4)
    if q == Q_FC_RESP:
        _fc_handle(g, st, pkt)
    elif q == Q_CTP_RESP:
        _cmt_fill(g, st, pkt)
    elif q == Q_CTP_REQ:
        _ctp_handle(g, st, pkt)
    else:                                   # Q_HRM, Q_GCM
        _cmt_handle(g, st, pkt, qid)
    if int(st.stalls_in_row) == before:
        st.stalls_in_row.zero_()
    return WORKED


def _deliver_fc(g, st):
    """auto_flash: self-deliver all pending flash reads (zero latency)."""
    cap = st.fc_buf.shape[0]
    for i in range(int(st.fc_head), int(st.fc_n)):
        tppn, s, w = st.fc_buf[i % cap].tolist()
        _qpush(st, Q_FC_RESP, _pkt(g, FC_READ_RESP, tppn, s, w))
    st.fc_head.copy_(st.fc_n)


def run(g: FMMUGeometry, st: FMMUState, max_steps: int,
        auto_flash: bool = False) -> int:
    """Drive steps until quiescent/blocked (mirrors oracle.run), in
    place. Returns the steps taken."""
    n = 0
    cont = True
    while cont and n < max_steps:
        code = step(g, st)
        n += 1
        worked = code == WORKED
        if auto_flash:
            can_deliver = (not worked) and int(st.fc_n) > int(st.fc_head)
            if can_deliver:
                _deliver_fc(g, st)
            cont = worked or can_deliver
        else:
            cont = worked
    return n


def force_flush_one(g: FMMUGeometry, st: FMMUState) -> None:
    """flush_all's DTL step: flush the oldest registered TVPN, if any."""
    if bool((st.dtl_tvpn != NIL).any()):
        seq = st.dtl_seq.tolist()
        _flush_tvpn(g, st, seq.index(min(seq)))


def force_wb(g: FMMUGeometry, st: FMMUState) -> bool:
    """flush_all's CTP step: write back the next dirty FIFO entry."""
    return _ctp_writeback_one(g, st)


# ======================================================================
# Host-side engine with the oracle's API
# ======================================================================
class FMMUEngine:
    """The packet engine with the oracle's API.

    ``device`` defaults to the card and raises without one (pass
    ``device="cpu"`` for the plain version). On a CUDA state ``run`` and
    ``flush_all``'s steps are launches of the ``fmmu_fsm`` kernel;
    ``kernel_impl="ref"`` runs the plain version on the card instead (for
    tests and the smoke's parity check). There is no fallback: a CUDA
    state whose kernel cannot be built or launched raises."""

    def __init__(self, geom: FMMUGeometry,
                 device: Union[str, torch.device] = "cuda",
                 kernel_impl: Optional[str] = None):
        if kernel_impl not in (None, "ref"):
            raise ValueError(f"kernel_impl {kernel_impl!r}: expected None "
                             "or 'ref'")
        self.g = geom
        self.device = resolve_device(device)
        self.kernel_impl = kernel_impl
        self.state = S.init_state(geom, self.device)
        self._checked = fmmu_fsm.StateCheck()   # the kernel's state check

    # -- pushes: host-side edits of the queue ring --
    def push_request(self, r: Request):
        self.push_requests([r])

    def push_flash_response(self, tppn: int, ctp_set: int, ctp_way: int):
        self.push_flash_responses([(tppn, ctp_set, ctp_way)])

    def push_requests(self, reqs):
        """``push_request`` of each of ``reqs`` in order, one copy per
        queue (a caller's batch)."""
        rows = {Q_HRM: [], Q_GCM: []}
        for r in reqs:
            rows[Q_GCM if r.src else Q_HRM].append(
                [r.kind, r.dlpn, r.dppn, r.old_dppn, r.req_id])
        for q, head in rows.items():
            if head:
                self._push_many(q, head)

    def push_flash_responses(self, reads):
        """``push_flash_response`` of each (tppn, set, way) in order, in
        one copy."""
        reads = [tuple(r) for r in reads]
        for _, s, w in reads:
            if not (0 <= s < self.g.ctp_sets and 0 <= w < self.g.ctp_ways):
                raise ValueError(f"flash response for CTP block ({s}, {w}) "
                                 "outside the geometry")
        if reads:
            self._push_many(Q_FC_RESP, [[FC_READ_RESP, t, s, w, NIL]
                                        for t, s, w in reads])

    def _push_many(self, q: int, heads):
        st, cap = self.state, self.g.queue_cap
        pkts = np.full((len(heads), self.g.pkt_width), NIL, np.int32)
        pkts[:, :5] = np.asarray(heads, np.int64)
        head, tail = int(st.qhead[q]), int(st.qtail[q])
        if tail - head + len(pkts) > cap:
            raise OverflowError(f"queue {q} overflow: {tail - head} + "
                                f"{len(pkts)} packets past {cap}")
        pos = torch.from_numpy((tail + np.arange(len(pkts))) % cap)
        st.qbuf[q, pos.to(self.device)] = torch.from_numpy(pkts).to(
            self.device)
        st.qtail[q] += len(pkts)

    def pending_work(self) -> bool:
        return bool((self.state.qtail - self.state.qhead).sum() > 0)

    def run(self, max_steps: int = 100_000, auto_flash: bool = False) -> int:
        return int(fmmu_fsm.fmmu_fsm_run(self.g, self.state, max_steps,
                                         auto_flash, impl=self.kernel_impl,
                                         checked=self._checked))

    def drain_outputs(self):
        st = self.state
        r0, f0, p0 = int(st.resp_head), int(st.fc_head), int(st.prog_head)
        rn, fn, pn = int(st.resp_n), int(st.fc_n), int(st.prog_n)
        rbuf = st.resp_buf.cpu().numpy()
        fbuf = st.fc_buf.cpu().numpy()
        pbuf = st.prog_buf.cpu().numpy()
        resps = [Response(*map(int, rbuf[i % rbuf.shape[0]]))
                 for i in range(r0, rn)]
        fcs = [tuple(map(int, fbuf[i % fbuf.shape[0]])) for i in range(f0, fn)]
        progs = [tuple(map(int, pbuf[i % pbuf.shape[0]]))
                 for i in range(p0, pn)]
        st.resp_head.fill_(rn)
        st.fc_head.fill_(fn)
        st.prog_head.fill_(pn)
        return resps, fcs, progs

    # -- shutdown path -------------------------------------------------
    def flush_all(self, max_rounds: int = 1000):
        impl, st = self.kernel_impl, self.state
        for _ in range(max_rounds):
            dtl_left = bool((st.dtl_tvpn != NIL).any())
            fifo_left = int(st.fifo_tail - st.fifo_head) > 0
            if not (dtl_left or fifo_left or self.pending_work()):
                break
            if dtl_left:
                fmmu_fsm.fmmu_fsm_force_flush_one(self.g, st, impl=impl,
                                                  checked=self._checked)
            self.run(auto_flash=True)
            while int(st.fifo_tail - st.fifo_head) > 0:
                if not bool(fmmu_fsm.fmmu_fsm_force_wb(
                        self.g, st, impl=impl, checked=self._checked)):
                    break
            self.run(auto_flash=True)

    # -- inspection ------------------------------------------------------
    def stats(self) -> dict:
        return dict(zip(S.STAT_NAMES, self.state.stats.tolist()))

    def resolve_many(self, dlpns) -> torch.Tensor:
        """``resolve`` of every dlpn at once, as int32 on the engine's
        device: one gather per level, no host read."""
        g, st = self.g, self.state
        d = torch.as_tensor(dlpns, dtype=torch.int64, device=self.device)

        def rd(i, n):
            i = torch.where(i < 0, i + n, i)
            return i.clamp(0, n - 1)

        def first_hit(tags, flags, key):
            hit = (tags == key[:, None]) & ((flags & F_VALID) != 0)
            return hit.any(1), hit.int().argmax(1)

        block = torch.div(d, g.cmt_entries, rounding_mode="floor")
        s = torch.remainder(block, g.cmt_sets)
        c_hit, c_way = first_hit(st.cmt_tag[s], st.cmt_flags[s], block)
        c_val = st.cmt_data[s, c_way, torch.remainder(d, g.cmt_entries)]
        tvpn = torch.div(d, g.entries_per_tp, rounding_mode="floor")
        off = torch.remainder(d, g.entries_per_tp)
        ts = torch.remainder(tvpn, g.ctp_sets)
        t_hit, t_way = first_hit(st.ctp_tag[ts], st.ctp_flags[ts], tvpn)
        t_val = st.ctp_data[ts, t_way, off]
        tppn = st.gtd[rd(tvpn, g.n_tvpns)].long()
        f_val = torch.where(tppn == NIL, torch.full_like(tppn, NIL),
                            st.flash_tp[rd(tppn, g.tppn_cap), off].long())
        return torch.where(c_hit, c_val.long(), torch.where(
            t_hit, t_val.long(), f_val)).to(I32)

    def resolve(self, dlpn: int) -> int:
        g = self.g
        st = self.state
        block_id = dlpn // g.cmt_entries
        s = block_id % g.cmt_sets
        tags = st.cmt_tag[s].tolist()
        fl = st.cmt_flags[s].tolist()
        for w in range(g.cmt_ways):
            if tags[w] == block_id and (fl[w] & F_VALID):
                return int(st.cmt_data[s, w, dlpn % g.cmt_entries])
        tvpn = dlpn // g.entries_per_tp
        ts = tvpn % g.ctp_sets
        ttags = st.ctp_tag[ts].tolist()
        tfl = st.ctp_flags[ts].tolist()
        for w in range(g.ctp_ways):
            if ttags[w] == tvpn and (tfl[w] & F_VALID):
                return int(st.ctp_data[ts, w, dlpn % g.entries_per_tp])
        tppn = int(st.gtd[_rd(tvpn, g.n_tvpns)])
        if tppn == NIL:
            return NIL
        return int(st.flash_tp[_rd(tppn, g.tppn_cap),
                               dlpn % g.entries_per_tp])
