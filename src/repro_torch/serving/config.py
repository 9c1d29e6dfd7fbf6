"""Typed serving-engine configuration: port of ``ServeConfig``,
``FaultPolicy`` and ``DurabilityConfig`` in ``repro/serving/config.py``.

The field names and defaults are the reference's. Every setting whose
machinery is not ported yet raises ``NotImplementedError`` at
construction — it is never ignored: the channel mesh across devices
(``use_mesh=True``), GC (``gc``) and prefix sharing (``prefix``).
``channels > 1`` shards the FMMU map across that many channels on one
device (``KVPageManager``). ``macro_k >= 2`` selects the K-step macro
decode path (``serving/macro.py``); 0 or 1 is single-step.
``n_host_blocks > 0`` adds the host tier: swap-pending slots become
masked lanes of the K-step runs under ``nonblocking_swap`` (else a round
with one falls back to a single step), and a slot pending for
``swap_patience`` boundaries forces its way back in.

``faults`` (``FaultPolicy``) holds the swap-retry and watchdog policy;
the fault plane itself is a ``ServeEngine`` argument, a stateful
schedule rather than configuration. ``durability``
(``DurabilityConfig``) arms the crash-consistent journal. The
reference's flat names for their fields (``max_swap_retries``,
``swap_backoff_cap``, ``watchdog_rounds``, ``journal_path``,
``snapshot_every``) are accepted as ``ServeConfig`` arguments too and
read back the nested values.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Swap-retry / watchdog policy. ``watchdog_rounds=None``: 8 *
    ``swap_patience`` with a fault plane attached, off without one."""
    max_swap_retries: int = 3
    swap_backoff_cap: int = 8
    watchdog_rounds: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    """Crash-consistency journaling: attach at ``journal_path`` (None:
    detached) and snapshot every ``snapshot_every``-th boundary."""
    journal_path: Optional[str] = None
    snapshot_every: int = 8


# flat alias -> (nested config field, its attribute); each is also a
# read-only property of ServeConfig
_ALIASES = {
    "max_swap_retries": ("faults", "max_swap_retries"),
    "swap_backoff_cap": ("faults", "swap_backoff_cap"),
    "watchdog_rounds": ("faults", "watchdog_rounds"),
    "journal_path": ("durability", "journal_path"),
    "snapshot_every": ("durability", "snapshot_every"),
}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    n_slots: int
    max_ctx: int
    n_device_blocks: Optional[int] = None
    n_host_blocks: int = 0
    eos_id: int = -1
    macro_k: int = 0
    nonblocking_swap: bool = True
    admit_tokens: Optional[int] = None
    swap_patience: int = 4
    channels: int = 1
    use_mesh: Optional[bool] = None
    faults: FaultPolicy = FaultPolicy()
    durability: DurabilityConfig = DurabilityConfig()
    gc: Optional[Any] = None
    prefix: Optional[Any] = None

    def __post_init__(self):
        unported = {
            "use_mesh (the channel mesh across devices)": bool(
                self.use_mesh),
            "gc (GC/CTP plane)": self.gc is not None,
            "prefix (prefix sharing)": self.prefix is not None,
        }
        bad = [name for name, on in unported.items() if on]
        if bad:
            raise NotImplementedError(
                "not ported to repro_torch yet: " + ", ".join(bad))
        if self.admit_tokens is not None and self.admit_tokens <= 0:
            raise ValueError(
                f"admit_tokens={self.admit_tokens}: a non-positive budget "
                "would never admit anything (pass None for unlimited)")


def _accept_aliases(init):
    """Wrap the generated ``__init__`` so that it also takes the flat
    aliases and applies them to their nested configs. ``replace`` passes
    fields only, so it never sees an alias."""
    @functools.wraps(init)
    def __init__(self, *args, **kw):
        flat = {k: kw.pop(k) for k in list(kw) if k in _ALIASES}
        init(self, *args, **kw)
        for alias, v in flat.items():
            sub, attr = _ALIASES[alias]
            object.__setattr__(self, sub, dataclasses.replace(
                getattr(self, sub), **{attr: v}))
    return __init__


ServeConfig.__init__ = _accept_aliases(ServeConfig.__init__)
for _alias, (_sub, _attr) in _ALIASES.items():
    setattr(ServeConfig, _alias, property(
        lambda self, s=_sub, a=_attr: getattr(getattr(self, s), a)))


__all__ = ["ServeConfig", "FaultPolicy", "DurabilityConfig"]
