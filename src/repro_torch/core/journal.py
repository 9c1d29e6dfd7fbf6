"""Crash-consistent map journaling and sudden-power-off recovery (SPOR):
the port's own copy of ``repro/core/journal.py``, with the reference's
on-disk format byte for byte (frame layout, magic, CRC, record kind
tags, file names, snapshot names), so a journal written by either
package recovers in the other.

An FTL pairs its cached map with a persistence story, and so does the
serving map here, in three layers:

* **Journal** — an append-only log of sequence-numbered records, one
  per host commit point: ``KVPageManager.new_seq`` / ``extend_seqs`` /
  ``precommit_growth`` / ``reconcile_macro`` / ``free_seq`` / ``_swap``
  / ``retire_bad_blocks`` / ``gc_collect`` / ``cow_writes``, the
  sharing's admissions, pins and unpins (SHARE), and the engine's
  request events (submit, admit, finish, quarantine). It is host file
  I/O behind an ``if journal is not None`` guard: a run without a
  journal does no extra work.
* **Snapshot** — the host-authoritative serving state (page lists, both
  tiers' free lists in order, retired blocks, request and admission
  state), written every few scheduling rounds through tmp ->
  ``os.replace``: a snapshot is whole or absent.
* **OOB region** — before a commit's record is appended, the blocks it
  programs write their reverse-map metadata (``(dlpn, block)`` owner
  pairs and bad-block marks) to a separate append-only log, as NAND
  writes OOB data with each program. When the journal's tail is torn,
  replay stops at the last whole record and a scan of the one dangling
  OOB frame rebuilds that commit's mapping; a commit whose OOB frame
  itself tore never reached "flash" and is dropped.

A power cut (the ``crash`` axis of ``core.faults``) kills the process
at a commit point: ``Journal.append`` consults the plane, writes the
scheduled share of the commit's bytes and raises ``faults.Crash``.
Recovery (``replay`` -> ``ServeEngine.recover``) rebuilds latest
snapshot + records (+ OOB scan), then restarts every in-flight request
from its prompt, since its KV lived in volatile memory; greedy decode
is deterministic, so the resumed drain gives the uncrashed tokens.

Prefix sharing adds the mapping refcounts of share-managed blocks and
the radix tree's pins to the recovered truth (``Recovered.ref`` /
``pinned``): a shared block may sit in several page lists, and frees
go through the refcount gate (``_unref_give``), as the live manager's
``_unref``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core import faults as flt
from repro_torch.core.fmmu.types import HOST_BASE

# ------------------------------------------------------------- framing
# frame = MAGIC u32 | seq u64 | kind u8 | len u32 | payload | crc32 u32
# (crc over seq..payload). Truncation at any byte offset is detected: a
# short header, a short payload or a crc mismatch marks the tail torn.
_MAGIC = 0x4C4A524E                      # "NRJL"
_HDR = struct.Struct("<IQBI")            # magic, seq, kind, length
_CRC = struct.Struct("<I")

# record kinds (stable on-disk tags)
OOB = 0          # oob.log frames only: programmed-block reverse map
NEW_SEQ = 1      # map: fresh sequence admitted (slot, dl, blocks)
EXTEND = 2       # map: decode growth, batched (dl, blocks)
PRECOMMIT = 3    # map: sharded macro boundary pre-commit
RECONCILE = 4    # map: one-channel macro run's device pops, replayed
FREE = 5         # map: sequence freed (slot, blocks)
SWAP = 6         # map: tier move (slot, moving, fresh, pages after)
RETIRE = 7       # map: bad-block retirement relocation
SUBMIT = 8       # engine: request enqueued (rid, tokens, max_new)
ADMIT = 9        # engine: request admitted to a slot (rid, slot)
FINISH = 10      # engine: request completed (rid, out)
QUAR = 11        # engine: request quarantined + front-requeued (rid)
GC = 12          # map: GC victim-walk relocation (moves, returned)
SHARE = 13       # map: shared admission, or a tree pin / unpin
COW = 14         # map: copy-on-write relocation (moves, returned)

_KIND_NAMES = {OOB: "oob", NEW_SEQ: "new_seq", EXTEND: "extend",
               PRECOMMIT: "precommit", RECONCILE: "reconcile",
               FREE: "free", SWAP: "swap", RETIRE: "retire",
               SUBMIT: "submit", ADMIT: "admit", FINISH: "finish",
               QUAR: "quarantine", GC: "gc", SHARE: "share",
               COW: "cow"}

_JOURNAL = "journal.log"
_OOBLOG = "oob.log"
_SNAP_FMT = "snap_%012d.json"


class JournalError(RuntimeError):
    """Unrecoverable journal corruption (never raised for a torn tail:
    that is the normal SPOR case)."""


def _frame(seq: int, kind: int, payload: dict) -> bytes:
    body = json.dumps(payload, separators=(",", ":")).encode()
    hdr = _HDR.pack(_MAGIC, seq, kind, len(body))
    return hdr + body + _CRC.pack(zlib.crc32(hdr[4:] + body))


def read_frames(path: str) -> Tuple[List[Tuple[int, int, dict]], int, bool]:
    """Parse an append-only frame log: (frames up to the first
    incomplete or corrupt one, the byte where that intact prefix ends,
    torn: whether bytes follow it)."""
    frames: List[Tuple[int, int, dict]] = []
    if not os.path.exists(path):
        return frames, 0, False
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while True:
        if off + _HDR.size > len(data):
            break
        magic, seq, kind, ln = _HDR.unpack_from(data, off)
        end = off + _HDR.size + ln + _CRC.size
        if magic != _MAGIC or end > len(data):
            break
        body = data[off + _HDR.size:end - _CRC.size]
        (crc,) = _CRC.unpack_from(data, end - _CRC.size)
        if crc != zlib.crc32(data[off + 4:off + _HDR.size] + body):
            break
        frames.append((seq, kind, json.loads(body)))
        off = end
    return frames, off, off < len(data)


# ------------------------------------------------------------- journal
class Journal:
    """Write side: one per engine, beside the fault plane. ``append`` is
    the one host commit-point hook, and the crash axis is consumed
    there, so a journaled run crashes at exactly the commit points the
    plane models (a swap's record append is its commit point)."""

    def __init__(self, path: str, *,
                 faults: Optional["flt.FaultPlane"] = None,
                 resume: bool = False, keep_snapshots: int = 2):
        os.makedirs(path, exist_ok=True)
        self.dir = path
        self.faults = faults
        self.keep_snapshots = int(keep_snapshots)
        self.dead = False
        self.records = 0          # records appended by this instance
        self.commit_lanes = 0     # cumulative committed map-write lanes
        self.lanes_base = 0       # value at attach (integrity baseline)
        jpath = os.path.join(path, _JOURNAL)
        opath = os.path.join(path, _OOBLOG)
        if resume:
            # drop any torn tail (the replay before this resume folded
            # its commit in or dropped it), then number on past the disk
            frames, nbytes, _ = read_frames(jpath)
            oframes, onbytes, _ = read_frames(opath)
            for p, n in ((jpath, nbytes), (opath, onbytes)):
                if os.path.exists(p):
                    with open(p, "r+b") as f:
                        f.truncate(n)
            self.seq = max([s for s, _, _ in frames + oframes] or [0])
        else:
            for name in os.listdir(path):
                if (name in (_JOURNAL, _OOBLOG)
                        or name.startswith("snap_")):
                    os.remove(os.path.join(path, name))
            self.seq = 0
        self._jf = open(jpath, "ab")
        self._of = open(opath, "ab")

    def close(self):
        for f in (self._jf, self._of):
            try:
                f.close()
            except ValueError:
                pass

    def _write(self, f, data: bytes):
        f.write(data)
        f.flush()    # durable against the modeled process-kill power cut

    def append(self, kind: int, payload: dict,
               programmed: Sequence[Tuple[int, int]] = (),
               retired: Sequence[int] = ()) -> int:
        """Persist one host commit: the OOB frame first (``programmed``:
        the commit's (dlpn, block) pairs; ``retired``: its bad-block
        marks), then the record. A scheduled power cut writes ``tear``
        of the commit's (oob + record) bytes and raises
        ``faults.Crash``: a torn OOB frame means the commit never
        reached flash; a whole OOB frame with a torn or absent record is
        the OOB scan's case."""
        assert not self.dead, "journal used after an injected power cut"
        self.seq += 1
        programmed = [[int(d), int(b)] for d, b in programmed]
        retired = [int(b) for b in retired]
        payload = dict(payload)
        payload["lanes"] = payload.get("lanes", len(programmed))
        rec = _frame(self.seq, kind, payload)
        oob = b""
        if programmed or retired:
            oob = _frame(self.seq, OOB,
                         {"pairs": programmed, "retired": retired})
        tear = (self.faults.crash_next()
                if self.faults is not None else None)
        if tear is None:
            if oob:
                self._write(self._of, oob)
            self._write(self._jf, rec)
            self.records += 1
            self.commit_lanes += int(payload["lanes"])
            return self.seq
        total = len(oob) + len(rec)
        cut = max(0, min(total, int(round(tear * total))))
        if oob and cut:
            self._write(self._of, oob[:min(cut, len(oob))])
        if cut > len(oob):
            self._write(self._jf, rec[:cut - len(oob)])
        self.dead = True
        self.close()
        raise flt.Crash(self.seq, _KIND_NAMES.get(kind, str(kind)),
                        torn=cut < total)

    def snapshot(self, state: dict) -> str:
        """Atomically commit a snapshot covering records 1..seq (tmp ->
        replace: never torn); prune all but the newest
        ``keep_snapshots``."""
        assert not self.dead
        doc = {"seq": self.seq, "lanes": self.commit_lanes}
        doc.update(state)
        path = os.path.join(self.dir, _SNAP_FMT % self.seq)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
        os.replace(tmp, path)
        snaps = sorted(n for n in os.listdir(self.dir)
                       if n.startswith("snap_") and not n.endswith(".tmp"))
        for n in snaps[:-self.keep_snapshots]:
            os.remove(os.path.join(self.dir, n))
        return path


# ------------------------------------------------------------ recovery
@dataclasses.dataclass
class Recovered:
    """Replay output: the host-authoritative serving state as of the
    crash, plus diagnostics. ``KVPageManager.restore_mapping`` re-derives
    the device map from it (the map is a function of the page lists)."""
    cfg: dict
    seq_pages: Dict[int, List[int]]
    host_pages: Dict[int, int]
    free_dev_ch: List[List[int]]
    free_host_ch: List[List[int]]
    rr: int
    retired: Set[int]
    retired_ch: List[int]
    exhausted_ch: List[int]
    stats: dict
    queue: List[int]                 # rids, crash-time deque order
    ever_admitted: Set[int]
    active: Dict[int, int]           # rid -> slot, admission order
    done: Dict[int, List[int]]
    submits: Dict[int, Tuple[List[int], int]]
    rid: int
    boundary: int
    # prefix sharing: mapping refcounts of share-managed blocks and the
    # tree's pinned blocks (the free gate's truth; the tree's content
    # is volatile and never recovered)
    ref: Dict[int, int] = dataclasses.field(default_factory=dict)
    pinned: Set[int] = dataclasses.field(default_factory=set)
    # diagnostics
    snap_seq: int = 0
    last_seq: int = 0
    replayed: int = 0
    lanes: int = 0
    torn: bool = False
    oob_scan: bool = False

    def check(self):
        """Map-consistency invariants: every block lives in exactly one
        of {a free list, a page list, the retired set}; free lists
        respect channel striping; host-page counts match the page lists.
        Prefix sharing relaxes one clause: a share-managed block (in
        ``ref``) may sit in several page lists, its refcount equal to
        its mappers, and a pinned one with no mapper is the tree's.
        Raises JournalError on a violation."""
        c_n = self.cfg["channels"]
        n_dev, n_host = self.cfg["n_device"], self.cfg["n_host"]
        seen: Dict[int, str] = {}

        def claim(b, who):
            if b in seen:
                raise JournalError(
                    f"block {b} owned twice: {seen[b]} and {who}")
            seen[b] = who

        for c in range(c_n):
            for b in self.free_dev_ch[c]:
                if b % c_n != c or not 0 <= b < n_dev:
                    raise JournalError(f"dev block {b} in channel {c}")
                claim(b, f"free_dev[{c}]")
            for b in self.free_host_ch[c]:
                i = b - HOST_BASE
                if i % c_n != c or not 0 <= i < n_host:
                    raise JournalError(f"host block {b} in channel {c}")
                claim(b, f"free_host[{c}]")
        mappers: Dict[int, int] = {}
        for s, pages in self.seq_pages.items():
            for b in pages:
                if b in self.ref:
                    mappers[b] = mappers.get(b, 0) + 1
                    if mappers[b] == 1:
                        claim(b, f"slot{s}")
                else:
                    claim(b, f"slot{s}")
            hp = sum(b >= HOST_BASE for b in pages)
            if hp != self.host_pages.get(s, 0):
                raise JournalError(
                    f"slot {s}: host_pages {self.host_pages.get(s, 0)}"
                    f" != counted {hp}")
        for b, n in self.ref.items():
            if n != mappers.get(b, 0):
                raise JournalError(
                    f"shared block {b}: refcount {n} != "
                    f"{mappers.get(b, 0)} mapping slots")
            if b not in seen:
                if b not in self.pinned:
                    raise JournalError(
                        f"share-managed block {b} has no owner")
                claim(b, "pinned")      # the tree holds the last reference
        for b in self.retired:
            claim(b, "retired")
        every = ([b for b in range(n_dev)]
                 + [HOST_BASE + i for i in range(n_host)])
        missing = [b for b in every if b not in seen]
        if missing:
            raise JournalError(f"blocks unaccounted for: {missing}")

    def mapping(self) -> Dict[int, int]:
        """dlpn -> block of every mapped page."""
        mp = self.cfg["max_pages"]
        return {s * mp + i: b
                for s, pages in self.seq_pages.items()
                for i, b in enumerate(pages)}


def _fresh_shadow(cfg: dict) -> Recovered:
    c_n = cfg["channels"]
    return Recovered(
        cfg=cfg,
        seq_pages={}, host_pages={},
        free_dev_ch=[[b for b in range(cfg["n_device"])
                      if b % c_n == c][::-1] for c in range(c_n)],
        free_host_ch=[[HOST_BASE + i for i in range(cfg["n_host"])
                       if i % c_n == c][::-1] for c in range(c_n)],
        rr=0, retired=set(), retired_ch=[0] * c_n, exhausted_ch=[0] * c_n,
        stats={"allocs": 0, "frees": 0, "swaps_out": 0, "swaps_in": 0,
               "peak_used": 0, "retired": 0},
        queue=[], ever_admitted=set(), active={}, done={}, submits={},
        rid=0, boundary=0)


def _load_snapshot(sh: Recovered, doc: dict):
    sh.seq_pages = {int(s): list(p)
                    for s, p in doc["seq_pages"].items()}
    sh.host_pages = {int(s): int(n)
                     for s, n in doc["host_pages"].items()}
    sh.free_dev_ch = [list(ch) for ch in doc["free_dev_ch"]]
    sh.free_host_ch = [list(ch) for ch in doc["free_host_ch"]]
    sh.rr = int(doc["rr"])
    sh.retired = set(doc["retired"])
    sh.retired_ch = list(doc["retired_ch"])
    sh.exhausted_ch = list(doc["exhausted_ch"])
    sh.stats = dict(doc["stats"])
    # request bookkeeping is absent from a manager-only snapshot
    sh.queue = list(doc.get("queue", []))
    sh.ever_admitted = set(doc.get("ever_admitted", []))
    sh.active = {int(r): int(s) for r, s in doc.get("active", [])}
    sh.done = {int(r): list(o) for r, o in doc.get("done", {}).items()}
    sh.submits = {int(r): (list(t), int(m))
                  for r, (t, m) in doc.get("submits", {}).items()}
    sh.rid = int(doc.get("rid", 0))
    sh.boundary = int(doc.get("boundary", 0))
    sh.ref = {int(b): int(n) for b, n in doc.get("ref", {}).items()}
    sh.pinned = set(int(b) for b in doc.get("pinned", []))
    sh.lanes = int(doc.get("lanes", 0))


def _channel_of(cfg: dict, block: int) -> int:
    b = block - HOST_BASE if block >= HOST_BASE else block
    return b % cfg["channels"]


def _take(sh: Recovered, block: int, host: bool):
    lists = sh.free_host_ch if host else sh.free_dev_ch
    ch = lists[_channel_of(sh.cfg, block)]
    try:
        ch.remove(block)
    except ValueError:
        raise JournalError(
            f"replay popped block {block} that is not free")


def _peak(sh: Recovered):
    """``BlockPool._bump_alloc``'s peak, sampled right after an
    allocation's pops, before any frees of the same commit."""
    used = sh.cfg["n_device"] - sum(len(c) for c in sh.free_dev_ch)
    sh.stats["peak_used"] = max(sh.stats["peak_used"], used)


def _give(sh: Recovered, block: int) -> int:
    """Free one block as ``BlockPool.free`` does (a retired block is
    dropped). Returns 1 when it reached a free list."""
    if block in sh.retired:
        return 0
    host = block >= HOST_BASE
    lists = sh.free_host_ch if host else sh.free_dev_ch
    lists[_channel_of(sh.cfg, block)].append(block)
    return 1


def _unref_give(sh: Recovered, block: int) -> int:
    """Drop one mapping reference, as ``KVPageManager._unref``: a block
    outside ``ref`` frees at once; a share-managed one at zero
    references with no pin. Returns 1 when the block reached a free
    list (the live run's ``frees`` count)."""
    n = sh.ref.get(block)
    if n is not None:
        sh.ref[block] = n - 1
        if n - 1 > 0 or block in sh.pinned:
            return 0
        del sh.ref[block]
    return _give(sh, block)


def _apply(sh: Recovered, kind: int, p: dict):
    """Replay one whole record onto the shadow state. The free-list
    mutations remove exactly the ids the live pool popped, so the
    surviving list order matches the live pool's, which is what makes
    the allocator re-push after a restore exact."""
    mp = sh.cfg["max_pages"]
    if kind == NEW_SEQ:
        for b in p["blocks"]:
            _take(sh, b, host=False)
        _peak(sh)
        sh.seq_pages[p["slot"]] = list(p["blocks"])
        sh.stats["allocs"] += len(p["blocks"])
    elif kind in (EXTEND, PRECOMMIT, RECONCILE):
        for d, b in zip(p["dl"], p["blocks"]):
            _take(sh, b, host=False)
            sh.seq_pages[d // mp].append(b)
        _peak(sh)
        sh.stats["allocs"] += len(p["blocks"])
        if "rr" in p:
            sh.rr = p["rr"]
    elif kind == FREE:
        sh.seq_pages.pop(p["slot"], None)
        sh.host_pages.pop(p["slot"], None)
        # the refcount gate, per block in lane order, as the live free
        sh.stats["frees"] += sum(_unref_give(sh, b) for b in p["blocks"])
    elif kind == SWAP:
        for b in p["fresh"]:
            _take(sh, b, host=p["out"])
        _peak(sh)
        for b in p["moving"]:
            _give(sh, b)
        sh.seq_pages[p["slot"]] = list(p["pages"])
        sh.host_pages[p["slot"]] = p["hp"]
        key = "swaps_out" if p["out"] else "swaps_in"
        sh.stats[key] += len(p["moving"])
        sh.stats["frees"] += sum(b not in sh.retired
                                 for b in p["moving"])
        sh.stats["allocs"] += len(p["fresh"])
    elif kind == RETIRE:
        for b in p["popped"]:
            _take(sh, b, host=False)
            _peak(sh)    # the live run pops one candidate per alloc_for
        sh.stats["allocs"] += len(p["popped"])
        for b in p["retired"]:
            sh.retired.add(b)
            sh.retired_ch[_channel_of(sh.cfg, b)] += 1
        sh.stats["retired"] += len(p["retired"])
        for s, pages in p["pages"].items():
            sh.seq_pages[int(s)] = list(pages)
    elif kind == GC:
        # the live walk popped every destination first, then freed the
        # applied lanes' old frames and the stale lanes' destinations
        # ("returned"): takes before gives, in the same orders
        returned = p.get("returned", [])
        for _, _, new in p["moves"]:
            _take(sh, new, host=False)
        for b in returned:
            _take(sh, b, host=False)
        _peak(sh)
        sh.stats["allocs"] += len(p["moves"]) + len(returned)
        for d, _, new in p["moves"]:
            sh.seq_pages[d // mp][d % mp] = new
        sh.stats["frees"] += sum(_give(sh, old) for _, old, _ in p["moves"])
        sh.stats["frees"] += sum(_give(sh, b) for b in returned)
    elif kind == SHARE:
        op = p.get("op")
        if op is None:
            # shared admission: only the fresh tail left the free lists;
            # the leading n_shared blocks gain a mapping reference
            k = p["n_shared"]
            for b in p["blocks"][k:]:
                _take(sh, b, host=False)
            _peak(sh)
            sh.seq_pages[p["slot"]] = list(p["blocks"])
            sh.stats["allocs"] += len(p["blocks"]) - k
            for b in p["blocks"][:k]:
                sh.ref[b] = sh.ref.get(b, 0) + 1
        elif op == "pin":
            # the owner's block becomes share-managed (its one mapping)
            # and the tree holds it
            for b in p["blocks"]:
                sh.pinned.add(b)
                sh.ref.setdefault(b, 1)
        else:
            assert op == "unpin", op
            for b in p["blocks"]:
                sh.pinned.discard(b)
                if sh.ref.get(b, 0) <= 0:
                    sh.ref.pop(b, None)
                    sh.stats["frees"] += _give(sh, b)
    elif kind == COW:
        # as GC: destination pops first; the shared frame drops one
        # reference and frees only as its last
        returned = p.get("returned", [])
        for _, _, _, new in p["moves"]:
            _take(sh, new, host=False)
        for b in returned:
            _take(sh, b, host=False)
        _peak(sh)
        sh.stats["allocs"] += len(p["moves"]) + len(returned)
        for s, pg, old, new in p["moves"]:
            sh.seq_pages[s][pg] = new
            sh.stats["frees"] += _unref_give(sh, old)
        sh.stats["frees"] += sum(_give(sh, b) for b in returned)
    elif kind == SUBMIT:
        sh.submits[p["rid"]] = (list(p["tokens"]), p["max_new"])
        sh.queue.append(p["rid"])
        sh.rid = max(sh.rid, p["rid"] + 1)
    elif kind == ADMIT:
        if p["rid"] in sh.queue:
            sh.queue.remove(p["rid"])
        sh.active.pop(p["rid"], None)   # re-admission moves to the end
        sh.active[p["rid"]] = p["slot"]
        sh.ever_admitted.add(p["rid"])
        sh.boundary = max(sh.boundary, p.get("boundary", 0))
    elif kind == FINISH:
        sh.done[p["rid"]] = list(p["out"])
        sh.active.pop(p["rid"], None)
        sh.submits.pop(p["rid"], None)
    elif kind == QUAR:
        sh.active.pop(p["rid"], None)
        sh.queue.insert(0, p["rid"])
        sh.ever_admitted.add(p["rid"])
    else:
        raise JournalError(f"unknown journal record kind {kind}")
    sh.lanes += int(p.get("lanes", 0))


def _oob_scan(sh: Recovered, pairs: List[List[int]],
              retired: List[int]):
    """The SPOR torn-tail fallback: the dangling commit's record never
    landed, but its blocks' OOB metadata did. Its (dlpn, block) owners
    apply in dlpn order (a slot's pages stripe across channels, so
    channel order would see page holes); a displaced older owner returns
    to the free pool. Bad-block marks re-apply retirement, and also pull
    the block off its shadow free list when it is there: the live run
    popped schedule-failed replacement candidates before retiring them,
    which the shadow never saw. A shared admission's metadata-only
    lanes (a block already mapped, or held by the tree alone) take a
    mapping reference instead of a free block; a displaced owner drops
    one reference."""
    mp = sh.cfg["max_pages"]
    for b in retired:
        if b in sh.retired:
            continue
        lists = sh.free_host_ch if b >= HOST_BASE else sh.free_dev_ch
        ch = lists[_channel_of(sh.cfg, b)]
        if b in ch:
            ch.remove(b)
        sh.retired.add(b)
        sh.retired_ch[_channel_of(sh.cfg, b)] += 1
        sh.stats["retired"] += 1
    mapped = {b for ps in sh.seq_pages.values() for b in ps}
    taken = 0
    for d, b in sorted((int(d), int(b)) for d, b in pairs):
        slot, page = divmod(d, mp)
        pages = sh.seq_pages.setdefault(slot, [])
        if page > len(pages):
            raise JournalError(
                f"OOB owner (dlpn={d}) maps a hole at page {page}")
        if b in mapped or b in sh.ref:
            sh.ref[b] = sh.ref.get(b, 0) + 1
        else:
            _take(sh, b, host=b >= HOST_BASE)
            taken += 1
            mapped.add(b)
        if page == len(pages):
            pages.append(b)
        else:
            old = pages[page]
            pages[page] = b
            if old != b:
                _unref_give(sh, old)
        sh.host_pages[slot] = sum(x >= HOST_BASE for x in pages)
    sh.stats["allocs"] += taken


def latest_snapshot(path: str) -> Optional[dict]:
    snaps = sorted((n for n in os.listdir(path)
                    if n.startswith("snap_") and n.endswith(".json")),
                   reverse=True)
    for name in snaps:
        try:
            with open(os.path.join(path, name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            continue    # unreadable snapshot: fall back to the previous
    return None


def replay(path: str) -> Recovered:
    """Rebuild the crash-time serving state from disk: the latest
    snapshot, every whole record past it, then the OOB scan of the one
    dangling commit when the tail is torn or a record never landed (OOB
    frames precede their records, so at most one commit is newer than
    the journal). Ends with the map-consistency check: a tail commit is
    replayed fully or dropped cleanly, never a corrupt map."""
    snap = latest_snapshot(path)
    if snap is None:
        raise JournalError(f"no snapshot in {path}")
    sh = _fresh_shadow(snap["cfg"])
    _load_snapshot(sh, snap)
    sh.snap_seq = snap["seq"]

    frames, _, torn = read_frames(os.path.join(path, _JOURNAL))
    last = sh.snap_seq
    for seq, kind, p in frames:
        if seq <= sh.snap_seq:
            continue
        if seq != last + 1:
            raise JournalError(
                f"journal gap: record {seq} after {last}")
        _apply(sh, kind, p)
        sh.replayed += 1
        last = seq
    sh.torn = torn
    sh.last_seq = last

    oframes, _, otorn = read_frames(os.path.join(path, _OOBLOG))
    dangling = [(s, p) for s, k, p in oframes if s > last and k == OOB]
    if len(dangling) > 1:
        raise JournalError(
            f"multiple dangling OOB commits: {[s for s, _ in dangling]}")
    if dangling:
        seq, p = dangling[0]
        _oob_scan(sh, p["pairs"], p["retired"])
        sh.oob_scan = True
        sh.last_seq = seq
        sh.replayed += 1
    sh.torn = torn or otorn or sh.oob_scan

    # a FINISH that landed without its FREE strands a mapped slot with no
    # owning request: give the orphan's pages back. Only an engine
    # journal has request bookkeeping; a manager-only one owns no slots.
    if sh.active or sh.submits or sh.queue or sh.done or sh.ever_admitted:
        owned = set(sh.active.values())
        for slot in [s for s in sh.seq_pages if s not in owned]:
            for b in sh.seq_pages.pop(slot):
                sh.stats["frees"] += _unref_give(sh, b)
            sh.host_pages.pop(slot, None)
    sh.check()
    return sh


__all__ = ["Journal", "JournalError", "Recovered", "read_frames", "replay",
           "latest_snapshot", "NEW_SEQ", "EXTEND", "PRECOMMIT",
           "RECONCILE", "FREE", "SWAP", "RETIRE", "SUBMIT", "ADMIT",
           "FINISH", "QUAR", "GC", "SHARE", "COW", "OOB"]
