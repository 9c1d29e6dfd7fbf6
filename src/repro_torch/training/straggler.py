"""Straggler detection & mitigation hooks: the port's copy of
``repro/training/straggler.py`` (pure Python).

On real multi-host deployments each host reports its step wall-time; a
host whose EWMA-normalized time exceeds k·sigma is flagged, and the
trainer can (a) log+alert, (b) trigger elastic rescale without it, or
(c) skip-step by quorum. Single-process here: the monitor tracks the
local step-time distribution and the same thresholding logic, and the
tests inject synthetic delays (simulated slow hosts) to verify the
detector + the quorum policy."""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple


@dataclasses.dataclass
class StragglerEvent:
    step: int
    host: int
    step_time: float
    ewma: float
    threshold: float


class StragglerMonitor:
    """EWMA + variance tracker with k-sigma flagging."""

    def __init__(self, alpha: float = 0.1, k_sigma: float = 4.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.k = k_sigma
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.var: float = 0.0
        self.n = 0
        self.events: List[StragglerEvent] = []
        self._sum = 0.0

    def record(self, step: int, dt: float, host: int = 0) -> bool:
        """Returns True if this measurement is a straggler event."""
        self.n += 1
        self._sum += dt
        if self.ewma is None:
            self.ewma = dt
            return False
        sigma = math.sqrt(self.var) if self.var > 0 else self.ewma * 0.1
        threshold = self.ewma + self.k * sigma
        is_straggler = self.n > self.warmup and dt > threshold
        if is_straggler:
            self.events.append(StragglerEvent(step, host, dt, self.ewma,
                                              threshold))
        else:  # stragglers don't poison the baseline
            d = dt - self.ewma
            self.ewma += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler

    def mean(self) -> float:
        return self._sum / max(self.n, 1)


class QuorumPolicy:
    """Skip-step quorum: proceed when >= quorum fraction of hosts have
    reported; missing hosts' microbatches are redistributed (here:
    recorded) — the backup-worker pattern at step granularity."""

    def __init__(self, n_hosts: int, quorum: float = 0.95):
        self.n_hosts = n_hosts
        self.quorum = quorum
        self.skipped: List[Tuple[int, List[int]]] = []

    def decide(self, step: int, reported_hosts: List[int]) -> bool:
        ok = len(reported_hosts) >= math.ceil(self.quorum * self.n_hosts)
        if ok and len(reported_hosts) < self.n_hosts:
            missing = [h for h in range(self.n_hosts)
                       if h not in reported_hosts]
            self.skipped.append((step, missing))
        return ok
