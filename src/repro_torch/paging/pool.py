"""Physical KV block pool allocator (the serving BM analogue): the
port's own copy of the single-channel device tier of
``repro/paging/pool.py``.

The free list order is part of the state: the device-resident map
mirrors it, and the equivalence tests compare it with the reference
pool entry by entry. Host tier, channel striping, bad-block retirement
and GC allocation come with the slices that port them; ``exhausted_ch``
keeps the reference's per-channel layout at one channel.
"""
from __future__ import annotations

import dataclasses
from typing import List


class OutOfBlocks(RuntimeError):
    pass


@dataclasses.dataclass
class PoolStats:
    allocs: int = 0
    frees: int = 0
    peak_used: int = 0


class BlockPool:
    def __init__(self, n_device: int):
        self.n_device = n_device
        self.n_host = 0
        # first pop yields block 0, as in the reference pool
        self._free_dev: List[int] = list(range(n_device))[::-1]
        self.stats = PoolStats()
        # pool-exhaustion events per channel (the device-side sticky
        # oob flag folds in via KVPageManager.observe_exhaustion)
        self.exhausted_ch = [0]

    @property
    def free_device(self) -> int:
        return len(self._free_dev)

    def alloc(self, n: int) -> List[int]:
        if len(self._free_dev) < n:
            raise OutOfBlocks(
                f"need {n} device blocks, have {len(self._free_dev)}")
        out = [self._free_dev.pop() for _ in range(n)]
        self.stats.allocs += n
        self.stats.peak_used = max(self.stats.peak_used,
                                   self.n_device - len(self._free_dev))
        return out

    def note_exhausted(self, channel: int):
        self.exhausted_ch[channel] += 1

    def free(self, blocks: List[int]):
        self._free_dev.extend(blocks)
        self.stats.frees += len(blocks)
