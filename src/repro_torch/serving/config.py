"""Typed serving-engine configuration: port of ``ServeConfig``,
``GCConfig``, ``PrefixConfig``, ``FaultPolicy`` and ``DurabilityConfig``
in ``repro/serving/config.py``.

The field names and defaults are the reference's. A setting whose
machinery is not ported yet raises ``NotImplementedError`` at
construction — it is never ignored: the channel mesh across devices
(``use_mesh=True``). ``gc`` (``GCConfig``) arms the GC/CTP plane and
``prefix`` (``PrefixConfig``) copy-on-write prefix sharing; None leaves
each off, and the map state then carries no ``live`` / ``refcnt``
lane.
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
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GCConfig:
    """The GC/CTP plane.

    watermark: a victim walk runs after a round when some channel's
        free device blocks are below this.
    pages_per_boundary: the walk's relocation budget (COND_UPDATE lanes
        per walk).
    block_pages: pages per modeled erase block (``BlockPool
        .erase_blocks``), the reclaim granularity.
    prefetch: arm the CTP, which pulls the CMT segments the next K-step
        run's growth touches ahead of it."""
    watermark: int = 2
    pages_per_boundary: int = 8
    block_pages: int = 4
    prefetch: bool = False

    def __post_init__(self):
        assert self.watermark >= 1, self.watermark
        assert self.pages_per_boundary >= 1, self.pages_per_boundary
        assert self.block_pages >= 1, self.block_pages


@dataclasses.dataclass(frozen=True)
class PrefixConfig:
    """Copy-on-write prefix sharing: admission maps a prompt's cached
    prefix pages at the blocks that hold them (a refcount bump, no
    prefill for those pages); a slot's first write into a shared page
    relocates it first.

    min_tokens: prompts shorter than this are not shared.
    max_nodes: the radix tree's capacity (least recently matched nodes
        are pruned past it)."""
    min_tokens: int = 16
    max_nodes: int = 4096

    def __post_init__(self):
        assert self.min_tokens >= 1, self.min_tokens
        assert self.max_nodes >= 1, self.max_nodes


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
    gc: Optional[GCConfig] = None
    prefix: Optional[PrefixConfig] = None

    def __post_init__(self):
        if self.use_mesh:
            raise NotImplementedError(
                "not ported to repro_torch yet: use_mesh (the channel "
                "mesh across devices)")
        for name, cls in (("gc", GCConfig), ("prefix", PrefixConfig)):
            v = getattr(self, name)
            if v is not None and not isinstance(v, cls):
                raise TypeError(f"{name}: a {cls.__name__} or None, not "
                                f"{type(v).__name__}")
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


__all__ = ["ServeConfig", "GCConfig", "PrefixConfig", "FaultPolicy",
           "DurabilityConfig"]
