"""The port's copy-on-write prefix sharing against the JAX reference, on
the CPU.

Radix tree: page groups and chained-crc32 path keys equal the
reference's; matching, registering, a crc collision (a miss, never a
wrong share) and the LRU prune that frees an orphaned block leave the
port's manager in the reference manager's state (the tree, pins,
refcounts, COW sets, pool and map). The ``refcnt`` lane equals the JAX
manager's and a host recount after every op of random churn with
shared admissions at C in {1, 2, 4}. The refcount free gate, a
copy-on-write with a stale lane, and the SHARE / COW records: journals
byte-equal, replayed equal in both packages, the restored managers
equal. Recovery releases orphan pins.

Engine: the reference engine test's shape (page 8, 8 slots x 64 ctx, 4
requests with a 16-token common prefix, ``PrefixConfig(min_tokens=8)``)
in lockstep with the JAX engine single-step, at ``macro_k=4`` and at two
channels: the tokens equal the JAX engine's and sharing-off's, one
prefill, three shared admissions of six pages, copy-on-write moves.
Sharing off carries no refcnt lane and journals byte for byte what the
reference journals."""
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import journal as JJ  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.paging.kv_manager import KVPageManager as JKVM  # noqa: E402
from repro.paging.pool import OutOfBlocks as JOOB  # noqa: E402
from repro.serving import config as JC  # noqa: E402
from repro_torch.core import journal as TJ  # noqa: E402
from repro_torch.core.fmmu.types import UPDATE  # noqa: E402
from repro_torch.paging.kv_manager import KVPageManager as TKVM  # noqa: E402
from repro_torch.paging.pool import OutOfBlocks as TOOB  # noqa: E402
from repro_torch.serving import (PrefixConfig, ServeConfig,  # noqa: E402
                                 ServeEngine)
from test_torch_faults import (assert_journals_equal,  # noqa: E402
                               assert_managers_equal, lockstep, model_pair,
                               shared_jax_programs)  # noqa: F401

PAGE = 8
COMMON = list(range(1, 17))
PROMPTS = [COMMON + [100 + i] * 4 for i in range(4)]


@pytest.fixture(scope="module")
def llama():
    return model_pair("llama3.2-1b")


def managers(c_n=1, n_slots=6, max_pages=8, n_dev=32, n_host=8):
    """A port and a JAX page manager with the refcnt lane armed."""
    return (TKVM(n_slots, max_pages, n_dev, n_host, c_n, track_refs=True,
                 device="cpu"),
            JKVM(n_slots, max_pages, n_dev, n_host, c_n, track_refs=True))


def assert_sharing_equal(t, j, tag=""):
    """The managers, and the sharing plane's host state: tree (keys,
    blocks, exact prefixes, LRU order), pins, refcounts, COW sets."""
    assert_managers_equal(t, j, tag)
    assert list(t._nodes.items()) == list(j._nodes.items()), tag
    assert t._pinned == j._pinned, tag
    assert t._ref == j._ref, tag
    assert t._shared == j._shared, tag
    assert (t.shared_maps, t.cow_moves) == (j.shared_maps, j.cow_moves), tag


def ref_oracle(kvm) -> np.ndarray:
    """Mapping references per device block, recounted from the pages."""
    out = np.zeros(kvm.pool.n_device, np.int64)
    for pages in kvm.seq_pages.values():
        for b in pages:
            if not kvm.pool.is_host(b):
                out[b] += 1
    return out


def sharing_pair(pair, prefix, **cfg):
    """A port and a JAX engine of one configuration, with
    ``PrefixConfig(min_tokens=prefix)`` (None: sharing off) in each
    package's own config type."""
    jm, jp, tm, tp = pair
    te = ServeEngine(tm, tp, device="cpu", config=ServeConfig(
        **cfg, prefix=PrefixConfig(prefix) if prefix else None))
    je = JServeEngine(jm, jp, config=JC.ServeConfig.from_legacy(
        **cfg, prefix=JC.PrefixConfig(prefix) if prefix else None))
    return te, je


def both(t, j, fn):
    """``fn(kvm)`` on both managers; both raise alike or neither."""
    got = []
    for kvm in (t, j):
        try:
            got.append(fn(kvm))
        except (TOOB, JOOB):
            got.append("oob")
    assert got[0] == got[1] or (not isinstance(got[0], str)
                                and not isinstance(got[1], str)), got
    return got[0]


# --------------------------------------------------------- radix tree
def test_page_groups_and_path_keys_match_reference():
    rng = np.random.default_rng(0)
    for n in (1, 7, 8, 9, 16, 33, 200):
        toks = rng.integers(0, 1 << 20, n).tolist()
        for page in (1, 8, 16):
            groups = TKVM.page_groups(toks, page)
            assert groups == JKVM.page_groups(toks, page)
            assert TKVM._path_keys(groups) == JKVM._path_keys(groups)


def test_match_register_collision_and_prune_match_reference():
    """Register two prompts' pages, match prefixes of every length, a
    crc collision ends the match (the node's exact prefix differs), a
    tree capped at 3 nodes prunes least recently matched nodes and
    frees the blocks no slot maps any more."""
    t, j = managers()
    for kvm in (t, j):
        kvm.prefix_max_nodes = 3
    a = list(range(1, 25))
    b = list(range(1, 9)) + list(range(50, 66))
    for slot, toks in ((0, a), (1, b)):
        g = TKVM.page_groups(toks, PAGE)
        both(t, j, lambda k: k.new_seq(slot, len(g)))
        both(t, j, lambda k: k.register_prefix(slot, g))
        assert_sharing_equal(t, j, f"register {slot}")
    for toks in (a, b, a[:9], b[:20], [9] * 16):
        g = TKVM.page_groups(toks, PAGE)
        assert t.match_prefix(g) == [int(x) for x in j.match_prefix(g)]
        assert_sharing_equal(t, j, "match")
    # a collision: the node under a's depth-2 key holds another prefix
    g = TKVM.page_groups(a, PAGE)
    key = TKVM._path_keys(g)[1]
    for kvm in (t, j):
        if key in kvm._nodes:
            blk, _ = kvm._nodes[key]
            kvm._nodes[key] = (blk, ((0,) * 8, (0,) * 8))
    assert len(t.match_prefix(g)) == len(j.match_prefix(g)) <= 1
    # owner slots go: their pinned blocks stay, held by the tree
    for slot in (0, 1):
        both(t, j, lambda k: k.free_seq(slot))
        assert_sharing_equal(t, j, f"free {slot}")
    assert t._pinned
    # a new prompt's pins push the oldest nodes out: orphans freed
    c = list(range(200, 232))
    g = TKVM.page_groups(c, PAGE)
    both(t, j, lambda k: k.new_seq(2, len(g)))
    free0 = t.pool.free_device
    both(t, j, lambda k: k.register_prefix(2, g))
    assert_sharing_equal(t, j, "prune")
    assert len(t._nodes) == 3 and t.pool.free_device > free0


@pytest.mark.parametrize("c_n", [1, 2, 4])
def test_refcnt_lane_matches_jax_and_oracle(c_n):
    """Random churn of admissions (shared ones through match_prefix),
    prompt registrations, growth, copy-on-write, frees and swaps: after
    every op the refcnt lane equals the JAX manager's and the host
    recount, and the managers agree in everything."""
    t, j = managers(c_n)
    rng = random.Random(c_n)
    width = t.pool.n_device + t.pool.n_host + 1
    tpool = torch.arange(width * 2.0).reshape(width, 2)
    jpool = jnp.asarray(tpool.numpy())
    stems = [list(range(1, 17)), list(range(40, 56))]
    prompts = {}
    for step in range(70):
        free = [s for s in range(t.n_slots) if s not in t.seq_pages]
        busy = sorted(t.seq_pages)
        op = rng.random()
        if op < 0.35 and free:
            slot = free[0]
            toks = rng.choice(stems)[:rng.choice([8, 12, 16])] + \
                [rng.randint(60, 90) for _ in range(rng.randint(0, 9))]
            g = TKVM.page_groups(toks, PAGE)
            shared = t.match_prefix(g)
            assert shared == [int(x) for x in j.match_prefix(g)]
            n = max(len(g), len(shared))
            if both(t, j, lambda k: k.new_seq(slot, n, shared=shared)) \
                    != "oob":
                prompts[slot] = g
        elif op < 0.5 and busy:
            slot = rng.choice(busy)
            both(t, j, lambda k: k.register_prefix(slot, prompts[slot]))
        elif op < 0.62 and busy:
            slot = rng.choice(busy)
            if t.is_resident(slot) and len(t.seq_pages[slot]) < t.max_pages:
                both(t, j, lambda k: k.extend_seq(slot, 1))
        elif op < 0.75 and busy:
            fronts = {s: rng.randint(0, 2) for s in busy
                      if t.is_resident(s)}
            try:
                n = t.cow_writes(fronts, [tpool])
            except TOOB:
                n = "oob"
            try:
                [jpool], m = j.cow_writes(fronts, [jpool])
            except JOOB:
                m = "oob"
            assert n == m
        elif op < 0.88 and busy:
            slot = rng.choice(busy)
            both(t, j, lambda k: k.free_seq(slot))
            prompts.pop(slot, None)
        elif busy:
            slot = rng.choice(busy)
            fn = "swap_out" if t.is_resident(slot) else "swap_in"
            try:
                n = getattr(t, fn)(slot, [tpool])
            except TOOB:
                n = "oob"
            try:
                [jpool], m = getattr(j, fn)(slot, [jpool])
            except JOOB:
                m = "oob"
            assert n == m
        assert_sharing_equal(t, j, f"step {step}")
        np.testing.assert_array_equal(t.refcounts(), ref_oracle(t))
        np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    assert t.shared_maps > 0 and t.cow_moves > 0


# ------------------------------------------ free gate, COW, journals
@pytest.mark.parametrize("c_n", [1, 2])
def test_free_gate_stale_cow_and_journals(c_n, tmp_path):
    """Journaled managers in both packages: an owner registers, two
    slots share its prefix, the owner frees (its shared blocks stay
    out of the pool), a copy-on-write finds one lane stale (its page was
    remapped behind its back: the guard refuses it and its destination
    returns), the sharers free. The journals are byte-equal; each
    replays in both packages to equal shadows, and the restored managers
    equal each other."""
    t, j = managers(c_n)
    dirs = [str(tmp_path / n) for n in ("t", "j")]
    for kvm, d, mod in ((t, dirs[0], TJ), (j, dirs[1], JJ)):
        kvm.journal = mod.Journal(d)
        kvm.journal.snapshot(kvm.snapshot_state())
    g = TKVM.page_groups(list(range(1, 21)), PAGE)
    both(t, j, lambda k: k.new_seq(0, len(g)))
    both(t, j, lambda k: k.register_prefix(0, g))
    shared = t.match_prefix(g)
    j.match_prefix(g)
    for slot in (1, 2):
        both(t, j, lambda k: k.new_seq(slot, len(shared), shared=shared))
    both(t, j, lambda k: k.free_seq(0))
    assert not any(b in t.pool._free_dev_ch[t.pool.channel_of(b)]
                   for b in shared)
    assert_sharing_equal(t, j, "gate")
    # slot 1's page 1 is remapped behind the COW's back
    dl = 1 * t.max_pages + 1
    for kvm in (t, j):
        kvm._xlate(UPDATE, [dl], [t.pool.n_device - 1])
    got = both(t, j, lambda k: k.cow_writes({1: 0, 2: 0}) if k is t
               else k.cow_writes({1: 0, 2: 0})[1])
    assert got == 2 * len(shared) - 1        # all but the stale lane
    assert t.seq_pages[1][1] == shared[1]    # the stale page stays put
    assert_sharing_equal(t, j, "cow")
    for slot in (1, 2):
        both(t, j, lambda k: k.free_seq(slot))
    t.journal.close()
    j.journal.close()
    assert_journals_equal(*dirs)
    kinds = [k for _, k, _ in TJ.read_frames(
        os.path.join(dirs[0], "journal.log"))[0]]
    assert {TJ.SHARE, TJ.COW, TJ.FREE} <= set(kinds)
    recs = [mod.replay(d) for mod in (TJ, JJ) for d in dirs]
    for r in recs[1:]:
        for f in ("seq_pages", "free_dev_ch", "stats", "ref", "pinned",
                  "retired", "lanes"):
            assert getattr(r, f) == getattr(recs[0], f), f
    t2, j2 = managers(c_n)
    t2.restore_mapping(recs[0])
    j2.restore_mapping(recs[3])
    assert_managers_equal(t2, j2, "restored")


def test_recovery_releases_orphan_pins(tmp_path):
    """A snapshot taken while the tree pins blocks no slot maps: the
    replay carries the refcounts and pins, and ``restore_mapping``
    releases every pin, the orphans going back to the pool in sorted
    order, in both packages alike."""
    t, j = managers()
    g = TKVM.page_groups(list(range(1, 25)), PAGE)
    for kvm in (t, j):
        kvm.new_seq(0, len(g))
        kvm.register_prefix(0, g)
        kvm.new_seq(1, 2, shared=kvm.match_prefix(g)[:2])
        kvm.free_seq(0)
    snaps = []
    for kvm, mod, name in ((t, TJ, "t"), (j, JJ, "j")):
        jr = mod.Journal(str(tmp_path / name))
        jr.snapshot(kvm.snapshot_state())
        jr.close()
        snaps.append(mod.replay(str(tmp_path / name)))
    assert snaps[0].ref == snaps[1].ref and snaps[0].ref
    assert snaps[0].pinned == snaps[1].pinned == set(t._pinned)
    t2, j2 = managers()
    t2.restore_mapping(snaps[0])
    j2.restore_mapping(snaps[1])
    assert_managers_equal(t2, j2, "restored")
    orphan = [b for b in t._pinned if b not in t.seq_pages[1]]
    assert orphan and all(b in t2.pool._free_dev for b in orphan)
    assert t2._ref == {int(b): int(n) for b, n in j2._ref.items()}


# ------------------------------------------------------------- engine
@pytest.mark.parametrize("macro_k,channels", [(0, 1), (4, 1), (4, 2)],
                         ids=["single_step", "macro_k4", "channels2"])
def test_engine_prefix_sharing_in_lockstep(llama, macro_k, channels):
    """The reference engine test's shape: the port's engine in lockstep
    with the JAX engine (same slots, pages, counters every round) with
    sharing on; the tokens equal sharing-off's; one prefill, three
    shared admissions of two pages each, copy-on-write moves; the map
    states equal, the refcnt lane included."""
    cfg = dict(n_slots=8, max_ctx=64, macro_k=macro_k, channels=channels)
    te, je = sharing_pair(llama, None, **cfg)
    off, _ = lockstep(te, je, PROMPTS, max_new=4)
    assert te.kvm.state.refcnt is None
    assert te.metrics["shared_admits"] == te.metrics["cow_moves"] == 0
    te, je = sharing_pair(llama, 8, **cfg)
    got, want = lockstep(te, je, PROMPTS, max_new=4)
    assert got == want == off
    m = te.metrics
    assert (m["prefills"], m["shared_admits"], m["shared_pages"]) == \
        (1, 3, 6)
    assert m["cow_moves"] > 0
    assert_managers_equal(te.kvm, je.kvm, "end")


def test_sharing_off_journals_like_the_reference(llama, tmp_path):
    """With ``prefix=None`` the map state has no refcnt lane and a
    journaled run of the shared-prompt workload writes, byte for byte,
    the reference's journal; with sharing on the journals (SHARE
    admissions and pins, COW records) are byte-equal too."""
    for prefix in (None, 8):
        te, je = sharing_pair(llama, prefix, n_slots=8, max_ctx=64,
                              macro_k=4)
        dirs = [str(tmp_path / f"{n}{prefix is None}") for n in "tj"]
        te.attach_journal(dirs[0], snapshot_every=3)
        je.attach_journal(dirs[1], snapshot_every=3)
        lockstep(te, je, PROMPTS, max_new=4)
        te.journal.close()
        je.journal.close()
        assert_journals_equal(*dirs)
        kinds = {k for _, k, _ in TJ.read_frames(
            os.path.join(dirs[0], "journal.log"))[0]}
        assert (TJ.SHARE in kinds) is (prefix is not None)
        assert (TJ.COW in kinds) is (prefix is not None)
        assert (te.kvm.state.refcnt is None) is (prefix is None)


def test_smoke_prefix_schedule_replays_alike():
    """``serve_prefix``'s workloads replayed on the CPU at 1 layer in
    both packages (``chip_smoke.prefix_prompts``, page 16, 8 slots x
    2048 ctx, macro_k=8, ``PrefixConfig(min_tokens=16)``): (a) one
    prefill, 7 shared admissions of 448 pages; (b) the copy-on-write
    moves ``chip_smoke.PREFIX_COW_MOVES``, in both alike."""
    from test_torch_gc import load_smoke, smoke_engines
    smoke = load_smoke()
    for part in (0, 1):
        cfg, te, je = smoke_engines(
            smoke, 16, t=dict(prefix=PrefixConfig(min_tokens=16)),
            j=dict(prefix=JC.PrefixConfig(min_tokens=16)))
        prompts = smoke.prefix_prompts(cfg)[part]
        for eng in (te, je):
            for p in prompts:
                eng.submit(p, max_new=32)
            eng.run()
        keys = ("prefills", "shared_admits", "shared_pages", "cow_moves")
        got = {k: te.metrics[k] for k in keys}
        assert got == {k: je.metrics[k] for k in keys}
        if part == 0:
            assert (got["prefills"], got["shared_admits"],
                    got["shared_pages"]) == (1, 7, 448)
        else:
            assert got["cow_moves"] == smoke.PREFIX_COW_MOVES


def test_gc_and_sharing_oversubscribed_with_a_journal_in_lockstep(
        llama, tmp_path):
    """The smoke's 2-layer parity shape (``chip_smoke.PARITY_CONFIG``:
    the reference chaos GC shape at two channels, prompts that share, a
    2-node tree) with GC, sharing and a journal armed, the port's engine
    in lockstep with the JAX engine: the tokens, metrics and journals
    (byte for byte) equal, and the walk, the sharing and the
    copy-on-write all ran."""
    from test_torch_gc import load_smoke
    from repro_torch.serving import GCConfig
    smoke = load_smoke()
    jm, jp, tm, tp = llama
    dirs = [str(tmp_path / n) for n in "tj"]
    te = ServeEngine(tm, tp, device="cpu", config=ServeConfig(
        **smoke.PARITY_CONFIG, journal_path=dirs[0],
        gc=GCConfig(**smoke.PARITY_GC),
        prefix=PrefixConfig(min_tokens=8, max_nodes=2)))
    je = JServeEngine(jm, jp, config=JC.ServeConfig.from_legacy(
        **smoke.PARITY_CONFIG, journal_path=dirs[1],
        gc=JC.GCConfig(**smoke.PARITY_GC),
        prefix=JC.PrefixConfig(min_tokens=8, max_nodes=2)))
    got, want = lockstep(te, je, smoke.PARITY_PROMPTS, max_new=16)
    assert got == want
    m = te.metrics
    assert m["gc_moves"] and m["shared_admits"] and m["cow_moves"]
    assert m["swaps_out"]
    te.journal.close()
    je.journal.close()
    assert_journals_equal(*dirs)


def test_copy_on_write_after_a_preemption(llama):
    """The reference chaos GC shape itself (12 device blocks, watermark
    3) at two channels: a copy-on-write runs short of blocks, preempts a
    slot to the host tier and retries. The port's pools are updated in
    place, so the retry moves the right rows and the tokens equal an
    engine with both planes off. (The reference engine fails here: its
    retry passes the pool buffers the preemption's swap donated.)"""
    from test_torch_gc import load_smoke
    from repro_torch.serving import GCConfig
    from repro_torch.serving import engine as TE
    smoke = load_smoke()
    _, _, tm, tp = llama
    cfg = dict(smoke.PARITY_CONFIG, n_device_blocks=12)
    outs, cow_preempts = [], []
    preempt = TE.ServeEngine._preempt
    for planes in (True, False):
        eng = ServeEngine(tm, tp, device="cpu", config=ServeConfig(
            **cfg, gc=GCConfig(3, 8, 2, prefetch=True) if planes else None,
            prefix=PrefixConfig(min_tokens=8, max_nodes=2) if planes
            else None))

        def spy(exclude, eng=eng):
            cow_preempts.append(exclude)
            return preempt(eng, exclude)
        eng._preempt = spy
        rids = [eng.submit(list(p), max_new=16)
                for p in smoke.PARITY_PROMPTS]
        done = eng.run()
        outs.append([done[r] for r in rids])
        if planes:
            assert eng.metrics["cow_moves"] and eng.metrics["gc_moves"]
            assert -1 in cow_preempts          # the COW's preemption
    assert outs[0] == outs[1]
