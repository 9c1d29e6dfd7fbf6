"""The FMMU packet engine's run loop as one launch: the CUDA kernel of
``csrc/fmmu_fsm.cu`` and its plain torch version (``core/fmmu/engine.py``).

The reference's ``run`` (``repro/core/fmmu/engine.py:671``) is one
compiled ``lax.while_loop`` over ``step``; a torch loop of steps on a
CUDA state would sync the host at every branch. Here the whole loop is
one kernel launch on one thread block: thread 0 runs the serial machine
and the block moves the 16 KB translation pages. The step count goes to
a device int32 that the caller reads once. ``flush_all``'s two helpers
are the kernel's other modes.

A CPU state takes the plain version; a CUDA state launches the kernel
or raises (``impl="ref"`` selects the plain version on any device). The
state is updated in place either way.
"""
from __future__ import annotations

import ctypes
import functools
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

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _I, _I, _I, _P, _P]

__all__ = ["fmmu_fsm_run", "fmmu_fsm_force_flush_one", "fmmu_fsm_force_wb",
           "LAUNCHES"]


def _geom(g: FMMUGeometry):
    """The kernel's Geom struct, in its field order."""
    vals = (g.cmt_sets, g.cmt_ways, g.cmt_entries, g.ctp_sets, g.ctp_ways,
            g.entries_per_tp, g.n_tvpns, g.dtl_entries, g.queue_cap,
            g.mshr_cap, g.ctp_mshr_cap, g.tppn_cap, S.fifo_cap(g),
            g.cmt_low(), g.ctp_low(), g.cmt_blocks, g.ctp_blocks,
            g.chunks_per_tp, g.pkt_width)
    return (ctypes.c_int * len(vals))(*vals)


def _check(g: FMMUGeometry, st: S.FMMUState) -> torch.device:
    """Raise unless every tensor of ``st`` is a contiguous int32 tensor
    of the shape ``init_state(g)`` gives, on one CUDA device."""
    if g.cmt_entries > MAX_ENTRIES or max(g.cmt_ways, g.ctp_ways) > MAX_WAYS:
        raise ValueError(f"fmmu_fsm: geometry past the kernel's limits "
                         f"(entries <= {MAX_ENTRIES}, ways <= {MAX_WAYS})")
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


def _launch(g: FMMUGeometry, st: S.FMMUState, mode: int, max_steps: int,
            auto_flash: bool) -> torch.Tensor:
    dev = _check(g, st)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(st))(*(t.data_ptr() for t in st))
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
                 auto_flash: bool = False, *, impl: Optional[str] = None
                 ) -> Union[int, torch.Tensor]:
    """``engine.run`` on ``st`` in place: the steps taken, as an int from
    the plain version or a device int32 (0-dim) from the kernel."""
    if _plain(st, impl):
        from repro_torch.core.fmmu import engine   # engine imports this
        return engine.run(g, st, max_steps, auto_flash)
    return _launch(g, st, MODE_RUN, max_steps, auto_flash)


def fmmu_fsm_force_flush_one(g: FMMUGeometry, st: S.FMMUState, *,
                             impl: Optional[str] = None) -> None:
    """``flush_all``'s DTL step on ``st`` in place."""
    if _plain(st, impl):
        from repro_torch.core.fmmu import engine
        engine.force_flush_one(g, st)
        return
    _launch(g, st, MODE_FLUSH_ONE, 0, False)


def fmmu_fsm_force_wb(g: FMMUGeometry, st: S.FMMUState, *,
                      impl: Optional[str] = None
                      ) -> Union[bool, torch.Tensor]:
    """``flush_all``'s CTP step on ``st`` in place: whether a block was
    written back (a device int32 from the kernel)."""
    if _plain(st, impl):
        from repro_torch.core.fmmu import engine
        return engine.force_wb(g, st)
    return _launch(g, st, MODE_WB, 0, False)
