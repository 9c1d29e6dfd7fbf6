"""Physical KV block pool allocator (the serving BM analogue): the
port's own copy of the single-channel path of ``repro/paging/pool.py``.

Two tiers: device blocks ``[0, n_device)``, read by the attention
kernels, and a host ("flash"-analogue) overflow tier for swapped-out
sequences, ids ``[HOST_BASE, HOST_BASE + n_host)``. As in the
reference, the host tier is rows ``[n_device, n_device + n_host)`` of
the same pool tensors (``host_row``); the FMMU map holds the tier-tagged
ids and CondUpdate arbitrates a swap against a relocation.

The free list order is part of the state: the device-resident map
mirrors it, and the equivalence tests compare it with the reference
pool entry by entry. Channel striping, bad-block retirement and GC
allocation come with the slices that port them; ``exhausted_ch`` keeps
the reference's per-channel layout at one channel.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.fmmu.types import HOST_BASE


class OutOfBlocks(RuntimeError):
    pass


@dataclasses.dataclass
class PoolStats:
    allocs: int = 0
    frees: int = 0
    swaps_out: int = 0
    swaps_in: int = 0
    peak_used: int = 0


class BlockPool:
    def __init__(self, n_device: int, n_host: int = 0):
        self.n_device = n_device
        self.n_host = n_host
        # first pop yields block 0 (HOST_BASE for the host tier), as in
        # the reference pool
        self._free_dev: List[int] = list(range(n_device))[::-1]
        self._free_host: List[int] = [HOST_BASE + i
                                      for i in range(n_host)][::-1]
        self.stats = PoolStats()
        # pool-exhaustion events per channel (the device-side sticky
        # oob flag folds in via KVPageManager.observe_exhaustion)
        self.exhausted_ch = [0]

    @staticmethod
    def is_host(block: int) -> bool:
        return block >= HOST_BASE

    def host_row(self, block: int) -> int:
        """Pool-tensor row backing a host-tier block id: the host region
        lives at rows [n_device, n_device + n_host)."""
        assert block >= HOST_BASE, block
        return self.n_device + (block - HOST_BASE)

    @property
    def free_device(self) -> int:
        return len(self._free_dev)

    @property
    def free_host(self) -> int:
        return len(self._free_host)

    def alloc(self, n: int, *, host: bool = False) -> List[int]:
        """Pop ``n`` blocks of one tier. A shortage raises before any
        pop and counts one exhaustion event, as in the reference."""
        free = self._free_host if host else self._free_dev
        if len(free) < n:
            self.note_exhausted(0)
            raise OutOfBlocks(
                f"need {n} {'host' if host else 'device'} blocks, "
                f"have {len(free)}")
        out = [free.pop() for _ in range(n)]
        self.stats.allocs += n
        self.stats.peak_used = max(self.stats.peak_used,
                                   self.n_device - len(self._free_dev))
        return out

    def note_exhausted(self, channel: int):
        self.exhausted_ch[channel] += 1

    def free(self, blocks: List[int]):
        """Push blocks back onto their tier's free list, in order."""
        for b in blocks:
            (self._free_host if self.is_host(b) else self._free_dev).append(b)
        self.stats.frees += len(blocks)
