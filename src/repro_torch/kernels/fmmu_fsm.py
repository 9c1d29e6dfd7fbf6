"""The FMMU packet engine's run loop as one launch: the CUDA kernel of
``csrc/fmmu_fsm.cu`` and its plain torch version (``core/fmmu/engine.py``).

The reference's ``run`` (``repro/core/fmmu/engine.py:671``) is one
compiled ``lax.while_loop`` over ``step``; a torch loop of steps on a
CUDA state would sync the host at every branch. Here the whole loop is
one kernel launch on one thread block: the engine's hot state is
resident in shared memory for the launch, one warp runs the serial
machine with its scans lane-parallel, and the other warps move the
16 KB translation pages. The step count goes to a device int32 that the
caller reads once. ``flush_all``'s two helpers are the kernel's other
modes.

The shared-memory layout is computed here (``_layout``) and passed to
the launch: every resident region's offset and the bytes. A geometry
whose layout exceeds the card's per-block limit (``SMEM_LIMIT``) raises
``ValueError`` before any launch.

A CPU state takes the plain version; a CUDA state launches the kernel
or raises (``impl="ref"`` selects the plain version on any device). The
state is updated in place either way.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Optional, Union

import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.core.fmmu import state as S
from repro_torch.core.fmmu.types import FMMUGeometry
from repro_torch.kernels import _build

LAUNCHES = COUNTERS.cell("kernel.fmmu_fsm")
MAX_ENTRIES = 32          # csrc/fmmu_fsm.cu kMaxEntries
MAX_WAYS = 32             # csrc/fmmu_fsm.cu kMaxWays
MODE_RUN, MODE_FLUSH_ONE, MODE_WB = 0, 1, 2
SMEM_LIMIT = 232_448      # H100: shared memory a block may opt into
# the queues whose rings are resident: the two that stall steps re-push
RING_QUEUES = (S.Q_CTP_REQ, S.Q_HRM)
N_SCALARS = 44            # csrc/fmmu_fsm.cu K_COUNT: 20 queue words, 13
                          # scalars, 11 stats
N_CTL = 32                # a page move's command, each ring's span
_MAGIC = 0x46534D32       # csrc/fmmu_fsm.cu kMagic
# csrc/fmmu_fsm.cu's Region order; the resident state, then scratch
_STATE_REGIONS = ("cmt_data", "cmt_tag", "cmt_flags", "cmt_next",
                  "cmt_mshr_n", "cmt_clock", "ctp_tag", "ctp_flags",
                  "ctp_mshr_n", "ctp_clock", "dtl_tvpn", "dtl_head",
                  "dtl_ndirty", "dtl_updated", "dtl_seq", "gtd", "scalars")
_REGIONS = _STATE_REGIONS + tuple(f"ring{q}" for q in range(5)) + (
    "page", "rows", "ctl", "fifo")

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _I, _I, _I, _P, _P]

__all__ = ["fmmu_fsm_run", "fmmu_fsm_force_flush_one", "fmmu_fsm_force_wb",
           "StateCheck", "LAUNCHES"]


def _region_ints(g: FMMUGeometry, rings=RING_QUEUES):
    """Each shared-memory region's int32 words (0: not resident)."""
    cb, tb, d = g.cmt_blocks, g.ctp_blocks, g.dtl_entries
    n = dict(cmt_data=cb * g.cmt_entries, cmt_tag=cb, cmt_flags=cb,
             cmt_next=cb, cmt_mshr_n=cb, cmt_clock=g.cmt_sets, ctp_tag=tb,
             ctp_flags=tb, ctp_mshr_n=tb, ctp_clock=g.ctp_sets, dtl_tvpn=d,
             dtl_head=d, dtl_ndirty=d, dtl_updated=d, dtl_seq=d,
             gtd=g.n_tvpns, scalars=N_SCALARS, fifo=S.fifo_cap(g),
             page=g.entries_per_tp,
             rows=max(g.mshr_cap * 5,
                      g.ctp_mshr_cap * (3 + g.cmt_entries)),
             ctl=N_CTL)
    for q in range(5):
        n[f"ring{q}"] = g.queue_cap * g.pkt_width if q in rings else 0
    return n


def _layout(g: FMMUGeometry, rings=RING_QUEUES):
    """({region: offset in ints, -1 when absent}, dynamic shared bytes):
    the regions in csrc/fmmu_fsm.cu's order, each at a 16-byte
    boundary."""
    n, off, at = _region_ints(g, rings), {}, 0
    for name in _REGIONS:
        if n[name] == 0:
            off[name] = -1
            continue
        off[name] = at
        at += -(-n[name] // 4) * 4
    return off, 4 * (off["fifo"] + n["fifo"])


def resident_bytes(g: FMMUGeometry, rings=RING_QUEUES) -> int:
    """Bytes of the engine state the kernel keeps in shared memory for a
    launch: the CMT's tags, flags, next links, MSHR counts, clocks and
    data, the CTP's tags, flags, MSHR counts and clocks, the DTL, the
    GTD, the FIFO, the scalars and the resident queue rings."""
    n = _region_ints(g, rings)
    return 4 * sum(n[r] for r in _STATE_REGIONS + ("fifo",) + tuple(
        f"ring{q}" for q in range(5)))


def smem_bytes(g: FMMUGeometry, rings=RING_QUEUES) -> int:
    """The launch's dynamic shared memory: the resident state, the
    staging copy of a filled page, the MSHR rows of a replay, the
    control words."""
    return _layout(g, rings)[1]


def _lg(n: int) -> int:
    return n.bit_length() - 1 if n > 0 and n & (n - 1) == 0 else -1


@functools.lru_cache(maxsize=None)
def _geom(g: FMMUGeometry, rings=RING_QUEUES):
    """The kernel's Geom struct, in its field order."""
    off, nbytes = _layout(g, rings)
    vals = (g.cmt_sets, g.cmt_ways, g.cmt_entries, g.ctp_sets, g.ctp_ways,
            g.entries_per_tp, g.n_tvpns, g.dtl_entries, g.queue_cap,
            g.mshr_cap, g.ctp_mshr_cap, g.tppn_cap, S.fifo_cap(g),
            g.cmt_low(), g.ctp_low(), g.cmt_blocks, g.ctp_blocks,
            g.chunks_per_tp, g.pkt_width) + tuple(_lg(n) for n in (
                g.cmt_sets, g.cmt_ways, g.cmt_entries, g.ctp_sets,
                g.ctp_ways, g.entries_per_tp, g.chunks_per_tp,
                g.queue_cap)) + (
        sum(1 << q for q in rings), nbytes) + tuple(
            off[r] for r in _REGIONS) + (_MAGIC,)
    return (ctypes.c_int * len(vals))(*vals)


def _check_geometry(g: FMMUGeometry) -> None:
    """Raise for a geometry the kernel cannot run: more entries or ways
    than a warp has lanes, or a layout past the card's shared memory."""
    if g.cmt_entries > MAX_ENTRIES or max(g.cmt_ways, g.ctp_ways) > MAX_WAYS:
        raise ValueError(f"fmmu_fsm: geometry past the kernel's limits "
                         f"(entries <= {MAX_ENTRIES}, ways <= {MAX_WAYS})")
    need = smem_bytes(g)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"fmmu_fsm: geometry needs {need} B of shared memory (its "
            f"resident state {resident_bytes(g)} B), past the card's "
            f"{SMEM_LIMIT} B a block")


def _check(g: FMMUGeometry, st: S.FMMUState) -> torch.device:
    """Raise unless the kernel can run geometry ``g`` and every tensor of
    ``st`` is a contiguous int32 tensor of the shape ``init_state(g)``
    gives, on one CUDA device."""
    _check_geometry(g)
    dev = st.stats.device
    want = _shapes(g)
    for name, t in zip(S.FMMUState._fields, st):
        _build.require(t, name, device=dev, dtype=torch.int32,
                       shape=want[name])
    return dev


@functools.lru_cache(maxsize=None)
def _shapes(g: FMMUGeometry):
    """Each field's shape in a state of geometry ``g``."""
    return {n: tuple(t.shape) for n, t in
            zip(S.FMMUState._fields, S.init_state(g, "meta"))}


class StateCheck:
    """The last state a launch checked: its geometry, its tensors (weak
    references: nothing is kept alive) and their data pointers. A caller
    that launches on one state call after call (``FMMUEngine``) keeps one
    and passes it as ``checked``: the 43 tensors are then checked when
    the state is new or changed, not at every call (checking them costs
    about a tenth of a run call's time on the host)."""

    __slots__ = ("g", "refs", "addrs")

    def __init__(self):
        self.g, self.refs, self.addrs = None, (), ()

    def __call__(self, g: FMMUGeometry, st: S.FMMUState, addrs) -> None:
        """``_check`` unless ``st`` is the state last passed: the same
        tensors at the same addresses (``addrs``), the same geometry."""
        if (self.addrs == addrs and self.g == g
                and len(self.refs) == len(st)
                and all(r() is t for r, t in zip(self.refs, st))):
            return
        _check(g, st)
        self.g, self.addrs = g, addrs
        self.refs = tuple(weakref.ref(t) for t in st)


def _launch(g: FMMUGeometry, st: S.FMMUState, mode: int, max_steps: int,
            auto_flash: bool, checked: Optional[StateCheck]) -> torch.Tensor:
    addrs = tuple(map(torch.Tensor.data_ptr, st))
    if checked is None:
        _check(g, st)
    else:
        checked(g, st, addrs)
    out = torch.zeros(1, dtype=torch.int32, device=st.stats.device)
    ptrs = (ctypes.c_void_p * len(st))(*addrs)
    lib = _build.load("fmmu_fsm", _ARGTYPES)
    err = lib.fmmu_fsm_launch(ptrs, _geom(g), mode, int(max_steps),
                              int(bool(auto_flash)), out.data_ptr(),
                              _build.stream_ptr(out))
    _build.check(lib, "fmmu_fsm", err)
    LAUNCHES[0] += 1
    return out[0]


def _plain(st: S.FMMUState, impl: Optional[str]) -> bool:
    if impl not in (None, "ref"):
        raise ValueError(f"fmmu_fsm impl {impl!r}: expected None or 'ref'")
    return impl == "ref" or st.stats.device.type == "cpu"


def fmmu_fsm_run(g: FMMUGeometry, st: S.FMMUState, max_steps: int,
                 auto_flash: bool = False, *, impl: Optional[str] = None,
                 checked: Optional[StateCheck] = None
                 ) -> Union[int, torch.Tensor]:
    """``engine.run`` on ``st`` in place: the steps taken, as an int from
    the plain version or a device int32 (0-dim) from the kernel."""
    if _plain(st, impl):
        from repro_torch.core.fmmu import engine   # engine imports this
        return engine.run(g, st, max_steps, auto_flash)
    return _launch(g, st, MODE_RUN, max_steps, auto_flash, checked)


def fmmu_fsm_force_flush_one(g: FMMUGeometry, st: S.FMMUState, *,
                             impl: Optional[str] = None,
                             checked: Optional[StateCheck] = None) -> None:
    """``flush_all``'s DTL step on ``st`` in place."""
    if _plain(st, impl):
        from repro_torch.core.fmmu import engine
        engine.force_flush_one(g, st)
        return
    _launch(g, st, MODE_FLUSH_ONE, 0, False, checked)


def fmmu_fsm_force_wb(g: FMMUGeometry, st: S.FMMUState, *,
                      impl: Optional[str] = None,
                      checked: Optional[StateCheck] = None
                      ) -> Union[bool, torch.Tensor]:
    """``flush_all``'s CTP step on ``st`` in place: whether a block was
    written back (a device int32 from the kernel)."""
    if _plain(st, impl):
        from repro_torch.core.fmmu import engine
        return engine.force_wb(g, st)
    return _launch(g, st, MODE_WB, 0, False, checked)
