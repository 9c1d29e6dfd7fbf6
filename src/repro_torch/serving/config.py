"""Typed serving-engine configuration: port of ``ServeConfig`` in
``repro/serving/config.py``.

The field names and defaults are the reference's. Every setting whose
machinery is not ported yet raises ``NotImplementedError`` at
construction — it is never ignored: the channel mesh across devices
(``use_mesh=True``), GC (``gc``), prefix sharing (``prefix``) and
journaling (``journal_path``). ``channels > 1`` shards the FMMU map
across that many channels on one device (``KVPageManager``). The
fault plane is a ``ServeEngine`` argument and is rejected there; its
policy fields (``max_swap_retries``, ``swap_backoff_cap``,
``watchdog_rounds``) come with it. ``macro_k >= 2`` selects the K-step
macro decode path (``serving/macro.py``); 0 or 1 is single-step.
``n_host_blocks > 0`` adds the host tier: swap-pending slots become
masked lanes of the K-step runs under ``nonblocking_swap`` (else a round
with one falls back to a single step), and a slot pending for
``swap_patience`` boundaries forces its way back in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


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
    gc: Optional[Any] = None
    prefix: Optional[Any] = None
    journal_path: Optional[str] = None

    def __post_init__(self):
        unported = {
            "use_mesh (the channel mesh across devices)": bool(
                self.use_mesh),
            "gc (GC/CTP plane)": self.gc is not None,
            "prefix (prefix sharing)": self.prefix is not None,
            "journal_path (crash-consistency journal)":
                self.journal_path is not None,
        }
        bad = [name for name, on in unported.items() if on]
        if bad:
            raise NotImplementedError(
                "not ported to repro_torch yet: " + ", ".join(bad))
        if self.admit_tokens is not None and self.admit_tokens <= 0:
            raise ValueError(
                f"admit_tokens={self.admit_tokens}: a non-positive budget "
                "would never admit anything (pass None for unlimited)")
