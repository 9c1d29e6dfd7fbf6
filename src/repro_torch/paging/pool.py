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
pool entry by entry, and ``state_dict``/``load_state`` carry it for the
journal's snapshots. Bad-block retirement (``retire``) removes a block
from service for good: ``free`` drops it. The GC walk groups each
channel's device blocks into modeled erase blocks (``erase_blocks``)
and pops its relocation destinations by value (``alloc_gc``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Set

from repro_torch.core.fmmu.types import HOST_BASE


class OutOfBlocks(RuntimeError):
    """A pool shortage, raised before any pop; ``channel`` is the
    channel it is counted against. ``transient`` marks a shortage the
    fault plane injected: the caller retries next round, and the
    engine's livelock guard does not treat it as terminal."""

    def __init__(self, msg: str, *, channel: Optional[int] = None,
                 transient: bool = False):
        super().__init__(msg)
        self.channel = channel
        self.transient = transient


class PoolExhausted(OutOfBlocks):
    """The typed pool-pressure error, raised where the reference raises
    its ``PoolExhausted``: a dry pool or channel (``alloc``,
    ``alloc_for``) and the fault plane's injected shortage
    (``transient=True``). A subclass of ``OutOfBlocks``, so every
    existing handler keeps working; new code matches on this type and
    consults ``transient``: the engine's livelock guard must not treat
    an injected shortage as terminal."""


@dataclasses.dataclass
class PoolStats:
    allocs: int = 0
    frees: int = 0
    swaps_out: int = 0
    swaps_in: int = 0
    peak_used: int = 0
    retired: int = 0          # bad blocks permanently removed


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
        # retired (bad) blocks never re-enter a free list; capacity
        # shrinks for good, like a block marked bad in the BBT
        self._retired: Set[int] = set()
        self.retired_ch = [0] * n_channels
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
            raise PoolExhausted(
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
                raise PoolExhausted(
                    f"need {k} {'host' if host else 'device'} blocks in "
                    f"channel {c}, have {len(lists[c])}", channel=c)
        out = [lists[c].pop() for c in channels]
        self._bump_alloc(len(out))
        return out

    def erase_blocks(self, channel: int,
                     block_pages: int) -> List[List[int]]:
        """The channel's whole erase blocks as lists of global device
        block ids (frames): erase block e groups the channel's
        tier-local frames [e*P, (e+1)*P), global ids
        c + C*(e*P + j). A trailing partial group is never a GC
        candidate. The one home of the grouping."""
        c_n, p = self.n_channels, block_pages
        assert p > 0
        n_local = (self.n_device - channel + c_n - 1) // c_n
        return [[channel + c_n * (e * p + j) for j in range(p)]
                for e in range(n_local // p)]

    def alloc_gc(self, channel: int, n: int, avoid=()) -> List[int]:
        """Pop up to ``n`` relocation destinations from a channel's
        device free list, skipping ``avoid`` (the victim's own frames),
        scanning from the tail (the end ``alloc`` pops) and removing
        the picked ids by value, so a journal replay that removes by id
        reproduces the list's content and order. Fewer (or none) when
        the channel lacks eligible blocks: GC never raises."""
        avoid = set(avoid)
        ch = self._free_dev_ch[channel]
        picked = [b for b in reversed(ch) if b not in avoid][:n]
        for b in picked:
            ch.remove(b)
        if picked:
            self._bump_alloc(len(picked))
        return picked

    def note_exhausted(self, channel: int, n: int = 1):
        """Count ``n`` pool-exhaustion events against ``channel``."""
        self.exhausted_ch[channel] += n

    def free(self, blocks: List[int]):
        """Push blocks back onto their tier's list of their channel, in
        order; a retired block is dropped instead."""
        n = 0
        for b in blocks:
            if b in self._retired:
                continue
            lists = self._free_host_ch if self.is_host(b) \
                else self._free_dev_ch
            lists[self.channel_of(b)].append(b)
            n += 1
        self.stats.frees += n

    def retire(self, blocks: Sequence[int]):
        """Remove blocks from service for good (bad-block retirement):
        the caller owns them (not on a free list) and has relocated
        their mappings; ``free`` drops them from now on."""
        for b in blocks:
            assert b not in self._retired, f"block {b} retired twice"
            self._retired.add(b)
            self.retired_ch[self.channel_of(b)] += 1
        self.stats.retired += len(blocks)

    def is_retired(self, block: int) -> bool:
        return block in self._retired

    def state_dict(self) -> dict:
        """The allocator's whole state as JSON-ready host data, in the
        reference's layout: free lists in order (the device mirror makes
        the order part of the state), the round-robin cursor, retirement
        and counters."""
        return {"free_dev_ch": [list(ch) for ch in self._free_dev_ch],
                "free_host_ch": [list(ch) for ch in self._free_host_ch],
                "rr": self._rr,
                "retired": sorted(self._retired),
                "retired_ch": list(self.retired_ch),
                "exhausted_ch": list(self.exhausted_ch),
                "stats": dataclasses.asdict(self.stats)}

    def load_state(self, d: dict):
        """Restore ``state_dict`` output exactly. The per-channel lists
        change in place: at one channel ``_free_dev``/``_free_host`` are
        channel 0's lists."""
        assert len(d["free_dev_ch"]) == self.n_channels
        for c in range(self.n_channels):
            self._free_dev_ch[c][:] = [int(b) for b in d["free_dev_ch"][c]]
            self._free_host_ch[c][:] = [int(b)
                                        for b in d["free_host_ch"][c]]
        self._rr = int(d["rr"])
        self._retired = set(int(b) for b in d["retired"])
        self.retired_ch = [int(n) for n in d["retired_ch"]]
        self.exhausted_ch = [int(n) for n in d["exhausted_ch"]]
        self.stats = PoolStats(**d["stats"])
