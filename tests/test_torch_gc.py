"""The port's GC/CTP plane against the JAX reference, on the CPU.

The ``live`` lane equals the JAX manager's and a numpy recount after
every op of random new / extend / free / swap / ``precommit_growth``
churn at C in {1, 2, 4}, the whole map state bit-identical and the pool
rows equal to a numpy oracle. ``gc_collect`` makes the reference's walk
(victims, moves, free-list order, map state, pool rows, GC records byte
for byte) under a budget, with a stale lane skipped and beside a
swap-pending slot. ``erase_blocks`` / ``alloc_gc`` equal the reference
pool's. ``prefetch_segments`` probes, hits and misses as the
reference's and forgets a reused slot's segments. Engines at the
reference chaos GC shape (4 slots, 12 + 24 blocks, macro_k=4, watchdog
16, ``GCConfig(3, 8, 2, prefetch=True)``) run in lockstep with the JAX
engine; a crash on the first GC record recovers the same in both. With
``gc=None`` the map carries no lane and the engine makes the map calls
it makes with an idle GC plane. The commit kernel's lane cap stays
8192."""
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import faults as JF  # noqa: E402
from repro.core import journal as JJ  # noqa: E402
from repro.core.fmmu.types import UPDATE  # noqa: E402
from repro.paging import kv_manager as JKM  # noqa: E402
from repro.paging.kv_manager import KVPageManager as JKVM  # noqa: E402
from repro.paging.pool import BlockPool as JPool  # noqa: E402
from repro.paging.pool import OutOfBlocks as JOOB  # noqa: E402
from repro.serving import config as JC  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.core import journal as TJ  # noqa: E402
from repro_torch.core.fmmu import batch as TB  # noqa: E402
from repro_torch.paging import kv_manager as TKM  # noqa: E402
from repro_torch.paging.kv_manager import KVPageManager as TKVM  # noqa: E402
from repro_torch.paging.pool import BlockPool  # noqa: E402
from repro_torch.paging.pool import OutOfBlocks as TOOB  # noqa: E402
from repro_torch.serving import GCConfig, ServeConfig, ServeEngine  # noqa: E402
from test_torch_faults import (assert_journals_equal,  # noqa: E402
                               assert_managers_equal, lockstep, model_pair,
                               shared_jax_programs)  # noqa: F401

# the reference chaos GC shape (tests/chaos/test_chaos_crash.py)
GC_SHAPE = dict(n_slots=4, max_ctx=64, n_device_blocks=12,
                n_host_blocks=24, macro_k=4, swap_patience=2,
                watchdog_rounds=16)
GC_PROMPTS = [list(range(1 + i, 20 + i)) for i in range(6)]
MAX_NEW = 10


@pytest.fixture(scope="module")
def llama():
    return model_pair("llama3.2-1b")


def managers(c_n=1, n_dev=32, n_host=8, max_pages=8):
    """A port and a JAX page manager with the live lane armed."""
    return (TKVM(6, max_pages, n_dev, n_host, c_n, track_live=True,
                 device="cpu"),
            JKVM(6, max_pages, n_dev, n_host, c_n, track_live=True))


def live_oracle(kvm) -> np.ndarray:
    """Live pages per device block, recounted from the page lists."""
    lv = np.zeros(kvm.pool.n_device, np.int64)
    for pages in kvm.seq_pages.values():
        for b in pages:
            if not kvm.pool.is_host(b):
                lv[b] += 1
    return lv


def move_rows(shadow, pool, pre, post):
    """The numpy oracle of a relocation: every page whose block changed
    carries its row from the old block's row to the new block's."""
    def row(b):
        return pool.host_row(b) if BlockPool.is_host(b) else b
    for s, old in pre.items():
        for a, b in zip(old, post.get(s, [])):
            if a != b:
                shadow[row(b)] = shadow[row(a)]


def pages_of(kvm):
    return {s: [int(b) for b in p] for s, p in kvm.seq_pages.items()}


class Pair:
    """Both managers, each with one pool tensor whose rows start equal,
    and the numpy oracle of those rows."""

    def __init__(self, t, j):
        self.t, self.j = t, j
        width = t.pool.n_device + t.pool.n_host + 1
        self.tpool = torch.arange(width * 3.0).reshape(width, 3)
        self.jpool = jnp.asarray(self.tpool.numpy())
        self.shadow = self.tpool.numpy().copy()

    def op(self, name, *args, moves_rows=False, **kw):
        """``name`` on both managers (rows through the pools when
        ``moves_rows``): both raise OutOfBlocks alike or return alike."""
        pre = pages_of(self.t)
        try:
            if moves_rows:
                got = getattr(self.t, name)(*args, pools=[self.tpool], **kw)
            else:
                got = getattr(self.t, name)(*args, **kw)
        except TOOB:
            got = "oob"
        try:
            if moves_rows:
                want = getattr(self.j, name)(*args, pools=[self.jpool], **kw)
                [self.jpool] = want[0]
                want = want[1:] if len(want) > 2 else want[1]
            else:
                want = getattr(self.j, name)(*args, **kw)
        except JOOB:
            want = "oob"
        if got != "oob" and moves_rows:
            move_rows(self.shadow, self.t.pool, pre, pages_of(self.t))
        assert (got == "oob") == (want == "oob"), name
        self.check(name)
        return got, want

    def check(self, tag):
        assert_managers_equal(self.t, self.j, tag)
        np.testing.assert_array_equal(self.t.live_counts(),
                                      live_oracle(self.t), tag)
        np.testing.assert_array_equal(self.tpool.numpy(),
                                      np.asarray(self.jpool), tag)
        np.testing.assert_array_equal(self.tpool.numpy(), self.shadow, tag)


def fragment(p: Pair, rng, rounds=12):
    """Admission and free churn that leaves fragmented erase blocks."""
    for _ in range(rounds):
        free = [s for s in range(p.t.n_slots) if s not in p.t.seq_pages]
        if free and rng.random() < 0.7:
            p.op("new_seq", rng.choice(free), rng.randint(2, 6))
        elif p.t.seq_pages:
            p.op("free_seq", rng.choice(sorted(p.t.seq_pages)))


# --------------------------------------------------------- live lane
@pytest.mark.parametrize("c_n", [1, 2, 4])
def test_live_lane_matches_jax_and_oracle_under_churn(c_n):
    """45 random new / extend / free / swap / precommit_growth ops: the
    live lane equals the JAX manager's and the recount after each, the
    map states and pools equal (``Pair.check``)."""
    p = Pair(*managers(c_n))
    rng = random.Random(100 + c_n)
    for step in range(45):
        t = p.t
        free = [s for s in range(t.n_slots) if s not in t.seq_pages]
        busy = sorted(t.seq_pages)
        op = rng.random()
        if op < 0.3 and free:
            p.op("new_seq", rng.choice(free), rng.randint(1, 4))
        elif op < 0.5 and busy:
            s = rng.choice(busy)
            if t.is_resident(s) and len(t.seq_pages[s]) < t.max_pages:
                p.op("extend_seq", s, 1)
        elif op < 0.62 and busy:
            seq = [s for s in busy if t.is_resident(s)
                   and len(t.seq_pages[s]) < t.max_pages - 1]
            if seq:
                p.op("precommit_growth", sorted(seq + seq[:1]))
        elif op < 0.77 and busy:
            p.op("free_seq", rng.choice(busy))
        elif busy:
            s = rng.choice(busy)
            p.op("swap_out" if t.is_resident(s) else "swap_in", s,
                 moves_rows=True)


# ------------------------------------------------------------ the walk
@pytest.mark.parametrize("c_n", [1, 2, 4])
def test_gc_collect_matches_jax(c_n, tmp_path):
    """Journaled managers, fragmented by churn, then walks under a
    budget of 1 page and of 64, with rows: the same moves and victims,
    map states, free lists, pool rows (against the oracle), and GC
    records byte for byte. A map-only walk matches too."""
    p = Pair(*managers(c_n))
    dirs = [str(tmp_path / n) for n in "tj"]
    for kvm, d, mod in ((p.t, dirs[0], TJ), (p.j, dirs[1], JJ)):
        kvm.journal = mod.Journal(d)
        kvm.journal.snapshot(kvm.snapshot_state())
    rng = random.Random(7 + c_n)
    moved = 0
    for rnd in range(4):
        fragment(p, rng)
        for budget in (1, 64):
            got, want = p.op("gc_collect", moves_rows=True, block_pages=4,
                             budget=budget)
            assert got == tuple(want), (got, want)
            assert got[0] <= budget
            moved += got[0]
        assert p.t.victims_ch == p.j.victims_ch
        assert p.t.gc_moves == p.j.gc_moves == moved
    assert moved > 0 and sum(p.t.victims_ch) > 0
    fragment(p, rng)
    got = p.t.gc_collect(block_pages=4, budget=64)
    assert got == p.j.gc_collect(block_pages=4, budget=64)[1:]
    assert_managers_equal(p.t, p.j, "map-only")
    for kvm in (p.t, p.j):
        kvm.journal.close()
    assert_journals_equal(*dirs)
    assert TJ.GC in {k for _, k, _ in TJ.read_frames(
        os.path.join(dirs[0], "journal.log"))[0]}
    recs = [TJ.replay(dirs[0]), JJ.replay(dirs[1])]
    assert recs[0].seq_pages == recs[1].seq_pages
    assert recs[0].free_dev_ch == recs[1].free_dev_ch
    assert recs[0].stats == recs[1].stats
    t2, j2 = managers(c_n)
    t2.restore_mapping(recs[0])
    j2.restore_mapping(recs[1])
    assert_managers_equal(t2, j2, "restored")
    np.testing.assert_array_equal(t2.live_counts(), p.t.live_counts())


def test_gc_stale_lane_skipped_like_the_reference(tmp_path):
    """A dlpn remapped behind the walk's back (its live read pinned to
    the pre-remap lane): the guard refuses that lane in both packages,
    its destination returns, the victim is not counted; the GC records
    are byte-equal."""
    p = Pair(*managers(1, n_dev=16, n_host=0))
    dirs = [str(tmp_path / n) for n in "tj"]
    for kvm, d, mod in ((p.t, dirs[0], TJ), (p.j, dirs[1], JJ)):
        kvm.journal = mod.Journal(d)
        kvm.journal.snapshot(kvm.snapshot_state())
    for slot, n in ((0, 2), (1, 2), (2, 4)):
        p.op("new_seq", slot, n)
    p.op("free_seq", 1)
    lv = p.t.live_counts()
    live_frame = 0
    dl = 0 * p.t.max_pages + 0
    for kvm in (p.t, p.j):
        kvm._xlate(UPDATE, [dl], [15])
        kvm.live_counts = lambda: lv       # the pre-remap read
    free0 = p.t.pool.free_device
    got = p.t.gc_collect([p.tpool], block_pages=4, budget=8)
    [p.jpool], *want = p.j.gc_collect([p.jpool], block_pages=4, budget=8)
    assert got == tuple(want) == (1, 0)
    assert p.t.seq_pages[0][0] == live_frame
    assert p.t.pool.free_device == free0
    assert_managers_equal(p.t, p.j, "stale")
    for kvm in (p.t, p.j):
        kvm.journal.close()
    assert_journals_equal(*dirs)
    rec = [m.replay(d) for m, d in ((TJ, dirs[0]), (JJ, dirs[1]))]
    assert rec[0].free_dev_ch == rec[1].free_dev_ch


@pytest.mark.parametrize("c_n", [1, 2])
def test_gc_walk_passes_over_a_swap_pending_slot(c_n):
    """A swap-out dispatched with ``check=False``, then a walk, then the
    swap back in: the pending slot's host blocks are untouched by the
    walk, its rows come back, both packages alike."""
    p = Pair(*managers(c_n, n_dev=32, n_host=16))
    fragment(p, random.Random(11 + c_n))
    if 0 not in p.t.seq_pages:
        p.op("new_seq", 0, 4)
    rows = [p.tpool[b].clone() for b in p.t.seq_pages[0]]
    p.op("swap_out", 0, moves_rows=True, check=False)
    pending = list(p.t.seq_pages[0])
    assert all(BlockPool.is_host(b) for b in pending)
    p.op("gc_collect", moves_rows=True, block_pages=4, budget=64)
    assert p.t.seq_pages[0] == pending
    p.op("swap_in", 0, moves_rows=True, check=True)
    for r, b in zip(rows, p.t.seq_pages[0]):
        assert torch.equal(p.tpool[b], r)


@pytest.mark.parametrize("c_n", [1, 2, 4])
def test_erase_blocks_and_alloc_gc_match_the_reference_pool(c_n):
    """The grouping of every channel at several erase-block sizes, and
    150 random alloc / free / alloc_gc (with a victim to avoid) ops:
    the same picks and ``state_dict`` after each."""
    t, j = BlockPool(30, 4, c_n), JPool(30, 4, c_n)
    for c in range(c_n):
        for bp in (1, 2, 3, 4, 7):
            assert t.erase_blocks(c, bp) == j.erase_blocks(c, bp)
    rng = random.Random(c_n)
    held = []
    for step in range(150):
        op = rng.choice(["alloc", "free", "gc"])
        if op == "alloc" and t.free_device:
            n = rng.randint(1, min(3, t.free_device))
            got = t.alloc(n)
            assert got == j.alloc(n)
            held += got
        elif op == "free" and held:
            rng.shuffle(held)
            t.free(held[:2])
            j.free(held[:2])
            held = held[2:]
        else:
            c = rng.randrange(c_n)
            frames = rng.choice(t.erase_blocks(c, 2) or [[]])
            n = rng.randint(0, 4)
            got = t.alloc_gc(c, n, avoid=frames)
            assert got == j.alloc_gc(c, n, avoid=frames)
            assert not set(got) & set(frames)
            held += got
        assert t.state_dict() == j.state_dict(), step


# ---------------------------------------------------------------- CTP
@pytest.mark.parametrize("c_n", [1, 2, 4])
def test_prefetch_segments_like_the_reference(c_n):
    """One LOOKUP commit per new frontier (the representatives of the
    unseen segments), nothing for a seen one, the hit / miss accounting
    and map state of the reference; a freed slot's segments are
    forgotten, so a reused slot's prefetch probes (and misses) again."""
    t, j = managers(c_n)
    ent = t.geom.cmt_entries
    for dl in (np.arange(2 * ent), np.arange(2 * ent),
               np.arange(3 * ent + 5)):
        x0, y0 = TKM.XLATE_CALLS[0], JKM.XLATE_CALLS[0]
        assert t.prefetch_segments(dl) == j.prefetch_segments(dl)
        assert TKM.XLATE_CALLS[0] - x0 == JKM.XLATE_CALLS[0] - y0
        assert (t.prefetch_hits, t.prefetch_misses) == \
            (j.prefetch_hits, j.prefetch_misses)
        assert_managers_equal(t, j, "prefetch")
    dl = np.asarray(t._dlpns(0, 4))
    for kvm in (t, j):
        kvm.prefetch_segments(dl)
        kvm.new_seq(0, 4)
        kvm.free_seq(0)
    # re-cool the CMT (write-through: dropping valid bits loses nothing)
    t.state.fmmu.valid.zero_()
    fm = j.state.fmmu
    j.state = j.state._replace(fmmu=fm._replace(
        valid=jnp.zeros_like(fm.valid)))
    m0 = t.prefetch_misses
    assert t.prefetch_segments(dl) == j.prefetch_segments(dl) > 0
    assert t.prefetch_misses == j.prefetch_misses > m0
    assert_managers_equal(t, j, "reuse")
    t.reset()
    j.reset()
    assert t.prefetch_segments(dl) == j.prefetch_segments(dl) > 0


# ------------------------------------------------------------- engine
def gc_pair(pair, gc, **cfg):
    """A port and a JAX engine of one configuration with the GC plane
    ``gc`` (GCConfig arguments; None: off) in each package's type."""
    jm, jp, tm, tp = pair
    te = ServeEngine(tm, tp, device="cpu", config=ServeConfig(
        **cfg, gc=GCConfig(*gc) if gc else None))
    je = JServeEngine(jm, jp, config=JC.ServeConfig.from_legacy(
        **cfg, gc=JC.GCConfig(*gc) if gc else None))
    return te, je


@pytest.mark.parametrize("c_n", [1, 2])
def test_engine_gc_in_lockstep_at_the_chaos_shape(llama, c_n):
    """The reference chaos GC shape in both packages, stepped in
    lockstep (slots, pages, counters every round): the same tokens, the
    walk moves pages, the map states (live lane included) equal."""
    te, je = gc_pair(llama, (3, 8, 2, True), channels=c_n, **GC_SHAPE)
    got, want = lockstep(te, je, GC_PROMPTS, max_new=MAX_NEW)
    assert got == want
    assert te.metrics["gc_moves"] > 0 and te.metrics["gc_walks"] > 0
    st = te.kvm.hit_stats()
    assert st.as_dict() == je.kvm.hit_stats().as_dict()
    assert st.prefetch_hits + st.prefetch_misses > 0
    assert_managers_equal(te.kvm, je.kvm, "end")


def test_crash_on_the_gc_record_recovers_alike(llama, tmp_path):
    """A journaled run at the chaos GC shape finds its first GC record;
    a second run crashes exactly there in both packages: the journals
    are equal at the crash, both recover alike and drain to the
    uncrashed tokens, and the journals are equal after."""
    te, je = gc_pair(llama, (3, 8, 2, True), **GC_SHAPE)
    ref = lockstep(te, je, GC_PROMPTS, max_new=MAX_NEW)[0]
    d = str(tmp_path / "find")
    te.reset(None)
    te.attach_journal(d, snapshot_every=4)
    for p in GC_PROMPTS:
        te.submit(list(p), max_new=MAX_NEW)
    te.run()
    frames = TJ.read_frames(os.path.join(d, "journal.log"))[0]
    at = next(i for i, (_, k, _) in enumerate(frames) if k == TJ.GC)
    dirs = [str(tmp_path / n) for n in "tj"]
    planes = (TF.FaultPlane(TF.make_plan(0, crash_at=at, horizon=4096)),
              JF.FaultPlane(JF.make_plan(0, crash_at=at, horizon=4096)))
    durable = []
    for eng, plane, dd, crash in ((te, planes[0], dirs[0], TF.Crash),
                                  (je, planes[1], dirs[1], JF.Crash)):
        eng.reset(plane)
        eng.attach_journal(dd, snapshot_every=4)
        with pytest.raises(crash):
            for p in GC_PROMPTS:
                eng.submit(list(p), max_new=MAX_NEW)
            eng.run()
    assert_journals_equal(*dirs)
    for eng, dd in ((te, dirs[0]), (je, dirs[1])):
        durable.append(eng.recover(dd))
    info = [dict(e.last_recovery) for e in (te, je)]
    for i in info:
        i.pop("recover_s")
    assert info[0] == info[1] and durable[0] == durable[1]
    outs = []
    for eng, dur in ((te, durable[0]), (je, durable[1])):
        done = eng.run()
        outs.append({**dur, **done})
    assert outs[0] == outs[1]
    assert [outs[0][r] for r in sorted(outs[0])] == ref
    for eng in (te, je):
        eng.journal.close()
    assert_journals_equal(*dirs)


def test_gc_off_carries_no_lane_and_makes_the_same_map_calls(llama):
    """``gc=None``: no live lane, no GC counters move, no host read of
    the plane; its map calls, routed lanes and every map tensor equal an
    engine whose GC plane is armed but idle (watermark 1 on an ample
    pool, no prefetch), whose only difference is the live lane."""
    runs = []
    for gc in (None, (1, 8, 2, False)):
        te, _ = gc_pair(llama, gc, n_slots=4, max_ctx=64, macro_k=4)
        x0, h0 = TKM.XLATE_CALLS[0], TKM.HOST_READS[0]
        rids = [te.submit(list(p), max_new=MAX_NEW) for p in GC_PROMPTS]
        done = te.run()
        runs.append((te, [done[r] for r in rids],
                     TKM.XLATE_CALLS[0] - x0, TKM.HOST_READS[0] - h0))
    (off, toks0, x_off, h_off), (idle, toks1, x_idle, _) = runs
    assert off.kvm.state.live is None and off.kvm.state.refcnt is None
    assert idle.kvm.state.live is not None
    assert toks0 == toks1 and x_off == x_idle and h_off == 0
    assert off.metrics["gc_walks"] == idle.metrics["gc_walks"] == 0
    np.testing.assert_array_equal(off.kvm.channel_lanes,
                                  idle.kvm.channel_lanes)
    for a, b in zip(TB.state_tensors(off.kvm.state),
                    TB.state_tensors(idle.kvm.state._replace(live=None))):
        assert torch.equal(a, b)


def test_map_stats_fields_and_lane_cap():
    """``MapStats`` has the reference's fields in its order, and
    ``flash_programs`` sums host writes, swap-ins, GC moves and COW
    copies; the commit kernel's lane cap is still 8192 (the count lanes
    live in registers, not in shared memory)."""
    import dataclasses
    from repro_torch.kernels import fmmu_commit as fc
    assert [f.name for f in dataclasses.fields(TKM.MapStats)] == \
        [f.name for f in dataclasses.fields(JKM.MapStats)]
    t, j = managers(2)
    for kvm in (t, j):
        kvm.new_seq(0, 3)
    assert t.hit_stats().as_dict() == j.hit_stats().as_dict()
    assert fc.LANE_CAP == 8192


def load_smoke():
    """``chip_smoke.py`` as a module (its constants and workloads)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def smoke_engines(smoke, page, **cfg):
    """A 1-layer port engine and a 1-layer JAX engine of the smoke's
    slot grid (8 slots x 2048 ctx, macro_k=8) at page ``page``: the
    schedules the smoke's phases run, which do not depend on the widths
    or the weights (no EOS)."""
    import dataclasses
    import jax
    from repro.configs import get_arch as j_get_arch
    from repro.configs import smoke_config as j_smoke
    from repro.models import Runtime as JRuntime
    from repro.models import build_model as j_build
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import Runtime, build_model
    tcfg = dataclasses.replace(smoke_config(get_arch("llama3.2-1b")),
                               n_layers=1)
    jcfg = dataclasses.replace(j_smoke(j_get_arch("llama3.2-1b")),
                               n_layers=1)
    tm = build_model(tcfg, Runtime(compute_dtype=torch.float32,
                                   param_dtype=torch.float32,
                                   page_size=page), device="cpu")
    jm = j_build(jcfg, JRuntime(compute_dtype=jnp.float32,
                                param_dtype=jnp.float32, remat="none",
                                page_size=page))
    te = ServeEngine(tm, tm.init(torch.Generator().manual_seed(0)),
                     device="cpu", config=ServeConfig(
                         n_slots=8, max_ctx=2048, macro_k=smoke.MACRO_K,
                         **cfg.get("t", {})))
    je = JServeEngine(jm, jm.init(jax.random.key(0)),
                      config=JC.ServeConfig.from_legacy(
                          n_slots=8, max_ctx=2048, macro_k=smoke.MACRO_K,
                          **cfg.get("j", {})))
    return tcfg, te, je


def test_smoke_gc_schedule_replays_alike():
    """``serve_gc``'s schedule (the llama prompts on 128 device + 256
    host blocks with ``chip_smoke.GC_CONFIG``) replayed on the CPU at 1
    layer in both packages: the same walks, moves and victims, equal to
    ``chip_smoke.GC_REPLAY``, and the same map counters."""
    smoke = load_smoke()
    kw = dict(smoke.SWAP_CONFIG)
    cfg, te, je = smoke_engines(
        smoke, 16, t=dict(kw, gc=GCConfig(**smoke.GC_CONFIG)),
        j=dict(kw, gc=JC.GCConfig(**smoke.GC_CONFIG)))
    prompts = smoke.serve_prompts(cfg, smoke.MODELS["llama3.2-1b"]["lens"])
    for eng in (te, je):
        for p in prompts:
            eng.submit(p, max_new=32)
        eng.run()
    got = {k: te.metrics[k] for k in smoke.GC_REPLAY}
    assert got == {k: je.metrics[k] for k in smoke.GC_REPLAY} == \
        smoke.GC_REPLAY
    assert te.kvm.hit_stats().as_dict() == je.kvm.hit_stats().as_dict()
