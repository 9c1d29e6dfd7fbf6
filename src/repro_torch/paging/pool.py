"""Physical KV block pool allocator (the serving BM analogue): the
port's own copy of ``repro/paging/pool.py`` (both tiers, channel
striping).

Two tiers: device blocks ``[0, n_device)``, read by the attention
kernels, and a host ("flash"-analogue) overflow tier for swapped-out
sequences, ids ``[HOST_BASE, HOST_BASE + n_host)``. As in the
reference, the host tier is rows ``[n_device, n_device + n_host)`` of
the same pool tensors (``host_row``); the FMMU map holds the tier-tagged
ids and CondUpdate arbitrates a swap against a relocation.

Channel striping (``n_channels > 1``): both tiers stripe across the
channels, block b belonging to channel b mod C (host blocks by their
tier-local index), as the map stripes dlpns, so a page and the block
backing it live in one channel and each channel's device stack
(``batch.init_sharded_state``) mirrors one per-channel free list here.
At one channel the channel-0 list is the single flat list.

The free list order is part of the state: the device-resident map
mirrors it, and the equivalence tests compare it with the reference
pool entry by entry. Bad-block retirement and GC allocation come with
the slices that port them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core.fmmu.types import HOST_BASE


class OutOfBlocks(RuntimeError):
    """A pool shortage, raised before any pop; ``channel`` is the
    channel it is counted against."""

    def __init__(self, msg: str, *, channel: Optional[int] = None):
        super().__init__(msg)
        self.channel = channel


@dataclasses.dataclass
class PoolStats:
    allocs: int = 0
    frees: int = 0
    swaps_out: int = 0
    swaps_in: int = 0
    peak_used: int = 0


class BlockPool:
    def __init__(self, n_device: int, n_host: int = 0,
                 n_channels: int = 1):
        self.n_device = n_device
        self.n_host = n_host
        self.n_channels = n_channels
        # per-channel striped free lists; the first pop of channel c
        # yields its lowest block (c, or HOST_BASE + c), as in the
        # reference pool and the device stacks
        self._free_dev_ch: List[List[int]] = [
            [b for b in range(n_device) if b % n_channels == c][::-1]
            for c in range(n_channels)]
        self._free_host_ch: List[List[int]] = [
            [HOST_BASE + i for i in range(n_host)
             if i % n_channels == c][::-1]
            for c in range(n_channels)]
        self._free_dev = self._free_dev_ch[0]
        self._free_host = self._free_host_ch[0]
        self._rr = 0        # round-robin cursor of the channel-free alloc
        self.stats = PoolStats()
        # pool-exhaustion events per channel (the device-side sticky
        # oob flags fold in via KVPageManager.observe_exhaustion)
        self.exhausted_ch = [0] * n_channels

    @staticmethod
    def is_host(block: int) -> bool:
        return block >= HOST_BASE

    def channel_of(self, block: int) -> int:
        """Owner channel of a block id (tier-local index mod C)."""
        b = block - HOST_BASE if block >= HOST_BASE else block
        return b % self.n_channels

    def host_row(self, block: int) -> int:
        """Pool-tensor row backing a host-tier block id: the host region
        lives at rows [n_device, n_device + n_host)."""
        assert block >= HOST_BASE, block
        return self.n_device + (block - HOST_BASE)

    @property
    def free_device(self) -> int:
        return sum(len(ch) for ch in self._free_dev_ch)

    @property
    def free_host(self) -> int:
        return sum(len(ch) for ch in self._free_host_ch)

    def free_device_ch(self, c: int) -> int:
        return len(self._free_dev_ch[c])

    def free_host_ch(self, c: int) -> int:
        return len(self._free_host_ch[c])

    def _bump_alloc(self, n: int):
        self.stats.allocs += n
        self.stats.peak_used = max(self.stats.peak_used,
                                   self.n_device - self.free_device)

    def alloc(self, n: int, *, host: bool = False) -> List[int]:
        """Pop ``n`` blocks of one tier, whatever their channels:
        round-robin across the channels at C > 1 (the cursor persists
        across calls), so no caller drains one channel first. A
        shortage raises before any pop and counts one exhaustion event
        against the emptiest channel, as in the reference."""
        lists = self._free_host_ch if host else self._free_dev_ch
        have = sum(len(ch) for ch in lists)
        if have < n:
            c = min(range(self.n_channels), key=lambda i: len(lists[i]))
            self.note_exhausted(c)
            raise OutOfBlocks(
                f"need {n} {'host' if host else 'device'} blocks, "
                f"have {have}", channel=c)
        if self.n_channels == 1:
            out = [lists[0].pop() for _ in range(n)]
        else:
            out = []
            while len(out) < n:
                ch = lists[self._rr % self.n_channels]
                if ch:
                    out.append(ch.pop())
                self._rr += 1
        self._bump_alloc(n)
        return out

    def alloc_for(self, channels: Sequence[int], *,
                  host: bool = False) -> List[int]:
        """Pop one block from each named owner channel, in order (block
        i backs a page of channel ``channels[i]``): the channel-sharded
        allocation. Raises before any pop when one channel's list is
        short, even while others hold blocks."""
        lists = self._free_host_ch if host else self._free_dev_ch
        need = [0] * self.n_channels
        for c in channels:
            need[c] += 1
        for c, k in enumerate(need):
            if k > len(lists[c]):
                self.note_exhausted(c)
                raise OutOfBlocks(
                    f"need {k} {'host' if host else 'device'} blocks in "
                    f"channel {c}, have {len(lists[c])}", channel=c)
        out = [lists[c].pop() for c in channels]
        self._bump_alloc(len(out))
        return out

    def note_exhausted(self, channel: int):
        self.exhausted_ch[channel] += 1

    def free(self, blocks: List[int]):
        """Push blocks back onto their tier's list of their channel, in
        order."""
        for b in blocks:
            lists = self._free_host_ch if self.is_host(b) \
                else self._free_dev_ch
            lists[self.channel_of(b)].append(b)
        self.stats.frees += len(blocks)
