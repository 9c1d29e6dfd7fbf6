"""Minimal discrete-event kernel + resource primitives for the SSD sim:
the port's own copy of ``repro/core/sim/events.py``."""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Callable, List, Optional, Tuple


class EventQueue:
    def __init__(self):
        self._h: List[Tuple[float, int, Callable]] = []
        self._seq = itertools.count()
        self.now = 0.0

    def at(self, t: float, fn: Callable):
        heapq.heappush(self._h, (max(t, self.now), next(self._seq), fn))

    def after(self, dt: float, fn: Callable):
        self.at(self.now + dt, fn)

    def run(self, until: Optional[float] = None) -> float:
        while self._h:
            t, _, fn = heapq.heappop(self._h)
            if until is not None and t > until:
                heapq.heappush(self._h, (t, next(self._seq), fn))
                self.now = until
                return self.now
            self.now = t
            fn()
        return self.now

    def __bool__(self):
        return bool(self._h)


class Server:
    """k identical units with a shared FIFO queue. Tracks busy time."""

    def __init__(self, ev: EventQueue, k: int, name: str = ""):
        self.ev = ev
        self.k = k
        self.name = name
        self.free = k
        self.q: deque = deque()
        self.busy_time = 0.0

    def request(self, dur: float, done: Callable):
        if self.free > 0:
            self.free -= 1
            self._start(dur, done)
        else:
            self.q.append((dur, done))

    def _start(self, dur: float, done: Callable):
        self.busy_time += dur

        def finish():
            if self.q:
                ndur, ndone = self.q.popleft()
                self._start(ndur, ndone)
            else:
                self.free += 1
            done()

        self.ev.after(dur, finish)

    def utilization(self, elapsed: float) -> float:
        return self.busy_time / max(elapsed * self.k, 1e-12)


class Pipe:
    """Serial bandwidth resource (one transfer at a time, FIFO)."""

    def __init__(self, ev: EventQueue, bytes_per_us: float, name: str = "",
                 op_overhead_us: float = 0.0):
        self.srv = Server(ev, 1, name)
        self.bpu = bytes_per_us
        self.ovh = op_overhead_us

    def transfer(self, nbytes: float, done: Callable):
        self.srv.request(nbytes / self.bpu + self.ovh, done)

    def utilization(self, elapsed: float) -> float:
        return self.srv.utilization(elapsed)
