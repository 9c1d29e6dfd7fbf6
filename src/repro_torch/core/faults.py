"""Deterministic, seedable fault-injection plane for the serving stack:
the port's own copy of ``repro/core/faults.py``.

Real NAND misbehaves: programs fail (bad blocks), channels stall, and
power can be cut mid-write. The serving layers above (``BlockPool``,
``KVPageManager``, ``ServeEngine``) are driven against this model.

A ``FaultPlan`` holds precomputed schedule arrays, one per axis. Bit i
of an axis is a function of ``(seed, axis, i)`` through a splitmix64
hash, so a plan replays from its integer seed alone, and the schedules
are bit-identical to the reference's for the same arguments (the
cross-package lockstep tests rely on it). A ``FaultPlane`` consumes a
plan at host commit points, through one monotone op counter per axis;
it never touches a tensor, so a run without a plane does exactly the
work it did before faults existed.

Axes:

* ``swap_fail``    — the i-th tier move (swap) fails before any state
  changes; the engine retries with capped exponential backoff and
  quarantines a slot whose swaps keep failing.
* ``program_fail`` — the i-th block program fails (a bad block); the
  pool retires the block and the manager re-drives the write through a
  CondUpdate map commit onto a same-channel replacement.
* ``alloc_fail``   — the i-th pool allocation reports a transient
  shortage (``PoolExhausted(transient=True)``); callers pause and retry.
* ``stall``        — per-channel brownout multipliers (>= 1.0): the
  engine divides a browned-out channel's advertised free blocks by it.
* ``crash``        — a sudden power-off at the i-th journaled commit,
  with ``crash_tear`` the share of that commit's bytes that reach disk
  (consumed by ``core.journal.Journal.append``; recovery is
  ``ServeEngine.recover``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

# schedule-axis tags folded into the hash (the reference's values)
AX_SWAP, AX_PROGRAM, AX_ALLOC, AX_STALL = 0, 1, 2, 3
AX_CRASH, AX_TEAR = 4, 5

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


class Crash(RuntimeError):
    """An injected sudden power-off, raised by the journal at a host
    commit point after an (optionally partial) record write. Everything
    in process memory is lost the instant it propagates: the engine is
    not stepped again, and recovery goes through
    ``ServeEngine.recover(path)``, which rebuilds state from the
    snapshot and journal on disk alone."""

    def __init__(self, seq: int, kind: str, torn: bool):
        super().__init__(
            f"injected power cut at journal seq={seq} ({kind}"
            f"{', torn record' if torn else ''})")
        self.seq = seq
        self.kind = kind
        self.torn = torn


class SwapFault(RuntimeError):
    """An injected swap failure, raised by ``KVPageManager._swap`` before
    any state changes: map, pools, page lists and free lists are as they
    were, so the caller may retry the same swap later."""

    def __init__(self, slot: int, direction: int, n_blocks: int):
        super().__init__(
            f"injected swap failure: slot={slot} direction={direction} "
            f"n_blocks={n_blocks}")
        self.slot = slot
        self.direction = direction
        self.n_blocks = n_blocks


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer; uint64 wraparound is the
    algorithm."""
    with np.errstate(over="ignore"):
        z = (x + _GOLDEN).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * _M1
        z = (z ^ (z >> np.uint64(27))) * _M2
        return z ^ (z >> np.uint64(31))


def _unit(seed: int, axis: int, n: int) -> np.ndarray:
    """n deterministic floats in [0, 1) for (seed, axis)."""
    with np.errstate(over="ignore"):
        base = _splitmix64(np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
                           ^ (np.uint64(axis) * _M2))
        idx = np.arange(n, dtype=np.uint64)
        bits = _splitmix64(base + idx * _GOLDEN)
    return (bits >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


class FaultPlan(NamedTuple):
    """Per-operation failure schedules (numpy); ``seed`` regenerates the
    plan through ``make_plan``. A ``FaultPlane``'s per-axis op counters
    index them with wraparound."""
    seed: int
    swap_fail: np.ndarray      # [H] bool — i-th swap op fails
    program_fail: np.ndarray   # [H] bool — i-th block program fails
    alloc_fail: np.ndarray     # [H] bool — i-th pool alloc is transient-dry
    stall: np.ndarray          # [C] float >= 1 — per-channel brownout
    crash: np.ndarray = np.zeros(0, bool)        # [H] bool
    # share of the crashing commit's bytes that land (1.0: the whole
    # record, the cut falls between commits; < 1.0: a torn tail)
    crash_tear: np.ndarray = np.zeros(0, float)  # [H] float in [0, 1]


def make_plan(seed: int, *, channels: int = 1,
              swap_fail_p: float = 0.0, program_fail_p: float = 0.0,
              alloc_fail_p: float = 0.0,
              stall: Optional[Sequence[float]] = None,
              crash_p: float = 0.0, crash_at: Optional[int] = None,
              horizon: int = 2048) -> FaultPlan:
    """A deterministic plan: bit i of axis a is ``hash(seed, a, i) < p``.
    ``crash_at`` pins a power cut at exactly the i-th journaled commit
    (it composes with ``crash_p``)."""
    assert horizon > 0
    st = (np.ones(channels, np.float64) if stall is None
          else np.asarray(stall, np.float64))
    assert st.shape == (channels,), (st.shape, channels)
    assert (st >= 1.0).all(), "stall multipliers are >= 1 (1 = healthy)"
    crash = _unit(seed, AX_CRASH, horizon) < crash_p
    if crash_at is not None:
        assert 0 <= crash_at < horizon, (crash_at, horizon)
        crash = crash.copy()
        crash[crash_at] = True
    return FaultPlan(
        seed=int(seed),
        swap_fail=_unit(seed, AX_SWAP, horizon) < swap_fail_p,
        program_fail=_unit(seed, AX_PROGRAM, horizon) < program_fail_p,
        alloc_fail=_unit(seed, AX_ALLOC, horizon) < alloc_fail_p,
        stall=st,
        crash=crash,
        crash_tear=_unit(seed, AX_TEAR, horizon))


class FaultPlane:
    """Host-side consumer of a ``FaultPlan``: one monotone op counter per
    axis, advanced at each commit point the axis models."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.ops = {"swap": 0, "program": 0, "alloc": 0, "crash": 0}
        self.fired = {"swap": 0, "program": 0, "alloc": 0, "crash": 0}

    def _next(self, axis: str, sched: np.ndarray) -> bool:
        i = self.ops[axis]
        self.ops[axis] = i + 1
        hit = bool(sched[i % len(sched)]) if len(sched) else False
        if hit:
            self.fired[axis] += 1
        return hit

    def swap_fails(self) -> bool:
        """Consume the next swap-op schedule entry."""
        return self._next("swap", self.plan.swap_fail)

    def program_fails(self) -> bool:
        """Consume the next block-program schedule entry."""
        return self._next("program", self.plan.program_fail)

    def alloc_fails(self) -> bool:
        """Consume the next pool-allocation schedule entry."""
        return self._next("alloc", self.plan.alloc_fail)

    def crash_next(self) -> Optional[float]:
        """Consume the next journaled-commit schedule entry: None when
        the process survives this commit, else the tear fraction in
        [0, 1] of the commit's bytes the journal writes before raising
        ``Crash``."""
        i = self.ops["crash"]
        hit = self._next("crash", self.plan.crash)
        if not hit:
            return None
        tear = self.plan.crash_tear
        return float(tear[i % len(tear)]) if len(tear) else 1.0

    def stall_vec(self, channels: int) -> np.ndarray:
        """Per-channel stall multipliers, broadcast to ``channels`` when
        the plan was built for one channel."""
        st = self.plan.stall
        if len(st) == channels:
            return st
        assert len(st) == 1, (len(st), channels)
        return np.full(channels, float(st[0]))

    def counts(self) -> dict:
        """Fired-fault counts per axis."""
        return dict(self.fired)

    def describe(self) -> str:
        p = self.plan
        return (f"FaultPlan(seed={p.seed}, "
                f"swap={int(p.swap_fail.sum())}/{len(p.swap_fail)}, "
                f"program={int(p.program_fail.sum())}/{len(p.program_fail)}, "
                f"alloc={int(p.alloc_fail.sum())}/{len(p.alloc_fail)}, "
                f"crash={int(p.crash.sum())}/{max(len(p.crash), 1)}, "
                f"stall={np.asarray(p.stall).tolist()})")


__all__ = ["Crash", "SwapFault", "FaultPlan", "FaultPlane", "make_plan"]
