"""Structured counter registry for host-side instrumentation: the
port's own copy of ``repro/core/counters.py``.

A cell is a one-element list, so call sites bump shared state with
``NAME[0] += 1`` while the registry enumerates every cell through
``snapshot()/reset()/delta()``. Beside the map and engine counters, each
CUDA kernel wrapper owns a ``kernel.<name>`` cell that it bumps once per
kernel launch and nowhere else, so a run can show which kernels carried
it (``launches()``).
"""
from __future__ import annotations

from typing import Dict, List, Optional


class Counters:
    """A named registry of mutable integer cells."""

    def __init__(self) -> None:
        self._cells: Dict[str, List[int]] = {}

    def cell(self, name: str) -> List[int]:
        """Get (or create at 0) the mutable cell for ``name``."""
        return self._cells.setdefault(name, [0])

    def snapshot(self) -> Dict[str, int]:
        return {k: int(v[0]) for k, v in self._cells.items()}

    def reset(self, name: Optional[str] = None) -> None:
        """Zero one counter (or all of them); aliases stay valid."""
        if name is not None:
            self.cell(name)[0] = 0
            return
        for v in self._cells.values():
            v[0] = 0

    def delta(self, base: Dict[str, int]) -> Dict[str, int]:
        return {k: int(v[0]) - int(base.get(k, 0))
                for k, v in self._cells.items()}

    def launches(self) -> Dict[str, int]:
        """Kernel launch counts by kernel name."""
        return {k[len("kernel."):]: int(v[0])
                for k, v in self._cells.items() if k.startswith("kernel.")}


COUNTERS = Counters()
