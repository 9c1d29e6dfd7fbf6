"""The port's fault plane against the JAX reference, on the CPU.

Plane: ``make_plan`` gives the reference's schedules bit for bit over a
sweep of seeds and arguments, and a ``FaultPlane`` consumes them alike.

Pool: ``BlockPool`` retire / free / ``state_dict`` / ``load_state`` equal
the reference pool's after every operation of a random script.

Page manager: at one and two channels, under a plan with swap, program
and alloc faults and with a journal, random new / extend / free / swap /
``precommit_growth`` / device-side growth (one channel) /
``retire_bad_blocks`` (with pool rows) interleavings leave the port's
manager bit-identical to the JAX one after every operation (map state,
free lists in order, page lists, residency, retired blocks, the pool's
whole state), the port's pool rows equal a numpy row oracle's and the
JAX pool's, the same faults raise on both sides, and the two journals
are equal byte for byte.

Engine: the reference chaos shape (4 slots x 64 ctx, 12 device + 24
host blocks, macro_k=4, swap_patience=2, watchdog_rounds=16) at one and
two channels, with a journal, stepped in lockstep with the JAX engine
under seeded plans: after every round the same slots, pages and
metrics; at the end the fault-free tokens, the same map counters and
journals equal byte for byte. A plan that fails most swaps quarantines.
With no plane and no journal, and with a zero-probability plane, the
outputs, the map calls (``XLATE_CALLS``) and the routed lanes equal the
JAX engine's. A mamba2 engine whose K-step run hits a program fault
raises (the reference reads ``caches["pool_k"]``, which it lacks)."""
import functools
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.core import faults as JF  # noqa: E402
from repro.core import journal as JJ  # noqa: E402
from repro.core.fmmu import batch as JB  # noqa: E402
from repro.models import Runtime as JRuntime  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.paging import kv_manager as JKM  # noqa: E402
from repro.paging.kv_manager import KVPageManager as JKVM  # noqa: E402
from repro.paging.pool import BlockPool as JPool  # noqa: E402
from repro.paging.pool import OutOfBlocks as JOOB  # noqa: E402
from repro.serving import config as JC  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.core import journal as TJ  # noqa: E402
from repro_torch.core.fmmu import batch as TB  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.paging import kv_manager as TKM  # noqa: E402
from repro_torch.paging.kv_manager import KVPageManager as TKVM  # noqa: E402
from repro_torch.paging.pool import BlockPool  # noqa: E402
from repro_torch.paging.pool import OutOfBlocks as TOOB  # noqa: E402
from repro_torch.serving import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serving import config as TC  # noqa: E402

PAGE = 8
# the reference chaos harness's workload and shape (tests/chaos/)
PROMPTS = [list(range(3 + 11 * i, 10 + 11 * i)) for i in range(6)]
MAX_NEW = 10
CHAOS = dict(n_slots=4, max_ctx=64, n_device_blocks=12, n_host_blocks=24,
             macro_k=4, swap_patience=2, watchdog_rounds=16)


# ------------------------------------------------------------ helpers
def assert_state_equal(t_state, j_state, tag=""):
    """Every leaf of two ServingMapStates: same values and dtype."""
    for name in t_state._fields:
        tv, jv = getattr(t_state, name), getattr(j_state, name)
        if name == "fmmu":
            assert_state_equal(tv, jv, f"{tag}.fmmu")
        elif tv is None or jv is None:
            assert tv is None and jv is None, f"{tag}.{name}"
        else:
            jn = np.asarray(jv)
            assert tv.numpy().dtype == jn.dtype, f"{tag}.{name}"
            np.testing.assert_array_equal(tv.numpy(), jn,
                                          err_msg=f"{tag}.{name}")


def assert_managers_equal(t, j, tag=""):
    """Map state, the pool's whole state (free lists in order, cursor,
    retirement, counters), page lists, residency."""
    assert_state_equal(t.state, j.state, tag)
    assert t.pool.state_dict() == j.pool.state_dict(), tag
    assert t.seq_pages == {s: [int(b) for b in p]
                           for s, p in j.seq_pages.items()}, tag
    assert t._host_pages == j._host_pages, tag


def assert_journals_equal(t_dir, j_dir):
    """The two journal directories hold the same files, byte for byte
    (journal, OOB log and snapshots), and the same frames."""
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
    for name in os.listdir(t_dir):
        with open(os.path.join(t_dir, name), "rb") as a, \
                open(os.path.join(j_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    for name in ("journal.log", "oob.log"):
        assert TJ.read_frames(os.path.join(t_dir, name)) == \
            JJ.read_frames(os.path.join(j_dir, name))


def planes(seed, **kw):
    """The same plan as a port plane and a JAX plane."""
    return (TF.FaultPlane(TF.make_plan(seed, **kw)),
            JF.FaultPlane(JF.make_plan(seed, **kw)))


def chaos_schedule(seed: int, channels: int) -> dict:
    """The reference chaos harness's seed -> plan parameters."""
    rng = np.random.default_rng(seed)
    stall = np.ones(channels)
    if rng.random() < 0.5:
        stall[rng.integers(channels)] = rng.uniform(2.0, 6.0)
    return dict(channels=channels,
                swap_fail_p=float(rng.uniform(0, 0.25)),
                program_fail_p=float(rng.uniform(0, 0.2)),
                alloc_fail_p=float(rng.uniform(0, 0.2)),
                stall=stall.tolist())


@pytest.fixture(scope="module", autouse=True)
def shared_jax_programs():
    """JAX page managers and engines of one configuration share their
    compiled programs (see ``test_torch_swap.py``), so the cases trace
    each shape once. A manager's own jits (the sharded commit, the
    retranslation, the allocator push, the swap / retirement / GC / COW
    closures) are functions of its geometry, channels, mesh and slot
    grid alone, so managers with the same ones share them too."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JB, "make_jitted",
               functools.lru_cache(maxsize=None)(JB.make_jitted))
    kvm_shared = {}
    kvm_init = JKVM.__init__

    def shared_kvm_init(self, *args, **kwargs):
        kvm_init(self, *args, **kwargs)
        key = (self.geom, self.channels, self.mesh is None, self.n_slots,
               self.max_pages)
        programs = kvm_shared.setdefault(key, {})
        for name in ("_serve_sharded", "_retrans_fn", "_set_alloc",
                     "_swap_jits"):
            if not hasattr(self, name):
                continue
            if name in programs:
                setattr(self, name, programs[name])
            else:
                programs[name] = getattr(self, name)
    mp.setattr(JKVM, "__init__", shared_kvm_init)
    shared = {}
    init = JServeEngine.__init__

    def shared_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        key = (id(self.m), self.page, self.n_slots, self.max_pages,
               self.scratch_block, self.macro_k, self.eos_id,
               self.channels, self.kvm.geom)
        programs = shared.setdefault(key, {})
        for name in ("_decode", "_prefill", "_macro", "_macro_simple",
                     "_macro_sh", "_macro_sh_simple"):
            if name in programs:
                setattr(self, name, programs[name])
            else:
                programs[name] = getattr(self, name)
        self.kvm._swap_jits = shared.setdefault(("swap",) + key, {})
    mp.setattr(JServeEngine, "__init__", shared_init)
    yield
    mp.undo()


def model_pair(arch):
    """The smoke config of ``arch`` in f32 in both packages, the port's
    weights from the reference's initialisation."""
    jm = j_build(j_smoke(j_get_arch(arch)),
                 JRuntime(compute_dtype=jnp.float32, param_dtype=jnp.float32,
                          remat="none", page_size=PAGE))
    cfg = smoke_config(get_arch(arch))
    tm = build_model(cfg, Runtime(compute_dtype=torch.float32,
                                  param_dtype=torch.float32, page_size=PAGE),
                     device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def llama():
    return model_pair("llama3.2-1b")


def engine_pair(pair, **cfg):
    """A port engine and a JAX engine of one configuration; the fault
    plane and journal come with ``reset`` / ``attach_journal``."""
    jm, jp, tm, tp = pair
    te = ServeEngine(tm, tp, config=ServeConfig(**cfg), device="cpu")
    je = JServeEngine(jm, jp, config=JC.ServeConfig.from_legacy(**cfg))
    return te, je


def lockstep(te, je, prompts=PROMPTS, max_new=MAX_NEW):
    """Submit ``prompts`` to both engines and step them round by round:
    after every round the same requests in the same slots with the same
    pages, residency, context lengths and metrics. Returns the two
    engines' outputs in submission order."""
    rids = [(te.submit(list(p), max_new=max_new),
             je.submit(list(p), max_new=max_new)) for p in prompts]
    done_t, done_j = {}, {}
    for rnd in range(4000):
        more = te.step(done_t)
        assert more == je.step(done_j), rnd
        assert {r.rid: r.slot for r in te.active.values()} == \
            {r.rid: r.slot for r in je.active.values()}, rnd
        assert [r.rid for r in te.queue] == [r.rid for r in je.queue], rnd
        assert te.kvm.seq_pages == {s: [int(b) for b in p] for s, p in
                                    je.kvm.seq_pages.items()}, rnd
        assert te.kvm._host_pages == je.kvm._host_pages, rnd
        np.testing.assert_array_equal(te.ctx_lens, je.ctx_lens)
        assert te.metrics == {k: je.metrics[k] for k in te.metrics}, rnd
        if not more:
            break
    assert not te.active and not te.queue
    return ([done_t[a] for a, _ in rids], [done_j[b] for _, b in rids])


# --------------------------------------------------------------- plane
def test_make_plan_bit_identical_to_reference():
    """Every schedule array of ``make_plan`` equals the reference's over
    a sweep of seeds and arguments (crash pins and stall vectors
    included), and the two planes consume them alike."""
    rng = np.random.default_rng(0)
    for seed in [0, 1, 7, 1234, 2**31 - 1, 2**63 + 5, 2**64 - 1] + \
            [int(x) for x in rng.integers(0, 2**62, 8)]:
        for kw in (dict(),
                   dict(swap_fail_p=0.2, program_fail_p=0.1,
                        alloc_fail_p=0.05, crash_p=0.03),
                   dict(channels=3, stall=[1.0, 2.5, 4.0], crash_at=17,
                        program_fail_p=0.5, horizon=64),
                   dict(swap_fail_p=1.0, horizon=1)):
            t, j = TF.make_plan(seed, **kw), JF.make_plan(seed, **kw)
            assert t.seed == j.seed
            for name in t._fields[1:]:
                a, b = getattr(t, name), getattr(j, name)
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            tp, jp = TF.FaultPlane(t), JF.FaultPlane(j)
            for i in range(80):
                axis = ("swap_fails", "program_fails", "alloc_fails",
                        "crash_next")[i % 4]
                assert getattr(tp, axis)() == getattr(jp, axis)()
            assert tp.counts() == jp.counts()
            assert tp.describe() == jp.describe()
            c = len(t.stall)
            np.testing.assert_array_equal(tp.stall_vec(c), jp.stall_vec(c))


# ---------------------------------------------------------------- pool
@pytest.mark.parametrize("channels", [1, 2])
def test_pool_retire_free_state_dict_against_reference(channels):
    """200 random alloc / alloc_for / free / retire / note_exhausted
    operations: the port's pool and the reference's raise alike and
    hold the same ``state_dict`` after each; ``free`` skips retired
    blocks; ``load_state`` of a dump is exact and keeps the one-channel
    list aliases."""
    rng = random.Random(channels)
    t, j = BlockPool(12, 8, channels), JPool(12, 8, channels)
    held = []
    for step in range(200):
        op = rng.choice(["alloc", "alloc_host", "alloc_for", "free",
                         "retire", "note"])
        arg = (held[:2] if op == "free" else
               [b for b in held if not BlockPool.is_host(b)][:1])
        raised, outs = [], []
        for p in (t, j):
            try:
                if op in ("alloc", "alloc_host"):
                    outs.append(p.alloc(1 + step % 3,
                                        host=op == "alloc_host"))
                elif op == "alloc_for":
                    outs.append(p.alloc_for([(step + i) % channels
                                             for i in range(1 + step % 2)]))
                elif op == "free":
                    p.free(arg)
                elif op == "retire":
                    p.retire(arg)
                    p.free(arg)            # a retired block is dropped
                else:
                    p.note_exhausted(step % channels, 1 + step % 2)
            except (TOOB, JOOB) as e:
                raised.append((type(e).__name__, e.channel))
        assert len(raised) in (0, 2), (step, op, raised)
        if outs and not raised:
            assert outs[0] == outs[1], (step, op)
            held += outs[0]
        if op in ("free", "retire"):
            held = [b for b in held if b not in arg]
        assert t.state_dict() == j.state_dict(), (step, op)
        assert [t.is_retired(b) for b in range(12)] == \
            [j.is_retired(b) for b in range(12)]
    assert t.stats.retired > 0
    dump = t.state_dict()
    fresh = BlockPool(12, 8, channels)
    fresh.load_state(dump)
    assert fresh.state_dict() == dump
    if channels == 1:
        assert fresh._free_dev is fresh._free_dev_ch[0]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("where", ["pool", "manager", "transient"])
def test_pool_exhausted_raised_like_the_reference(channels, where):
    """Both packages driven dry (a pool's aggregate and per-channel
    pops; a page manager's admissions) and under an injected allocation
    fault raise their own ``PoolExhausted`` alike: the same message,
    ``channel`` and ``transient``, each caught by ``except
    OutOfBlocks``."""
    from repro.paging.pool import PoolExhausted as JPE
    from repro_torch.paging.pool import PoolExhausted as TPE

    def drive(pool_cls, kvm_cls, plane, oob, exhausted):
        seen = []

        def attempt(fn, *args, **kw):
            try:
                fn(*args, **kw)
            except oob as e:
                assert isinstance(e, exhausted), type(e)
                seen.append((str(e), e.channel, e.transient))
        if where == "pool":
            p = pool_cls(6, 2, channels)
            for n in (4, 3, 2):
                attempt(p.alloc, n)
            attempt(p.alloc, 1, host=True)
            attempt(p.alloc, 2, host=True)
            attempt(p.alloc_for, [channels - 1] * 3)
        else:
            kw = {"device": "cpu"} if kvm_cls is TKVM else {}
            kvm = kvm_cls(4, 6, 20, 12, channels=channels,
                          faults=plane if where == "transient" else None,
                          **kw)
            for slot in range(4):
                attempt(kvm.new_seq, slot, 6)
        return seen

    tp, jp = planes(3, channels=channels, alloc_fail_p=1.0)
    got = drive(BlockPool, TKVM, tp, TOOB, TPE)
    want = drive(JPool, JKVM, jp, JOOB, JPE)
    assert got == want and got, (got, want)
    assert all(tr == (where == "transient") for _, _, tr in got)


# -------------------------------------------------------- page manager
def _oracle_move(shadow, pool, pre_pages, post_pages):
    """Replay one relocation's row moves on a numpy shadow of the pool:
    a page whose block id changed carries its row from the old block's
    row to the new one's (host blocks at ``pool.host_row``)."""
    def row(b):
        return pool.host_row(b) if BlockPool.is_host(b) else b
    src = [row(a) for a, b in zip(pre_pages, post_pages) if a != b]
    dst = [row(b) for a, b in zip(pre_pages, post_pages) if a != b]
    shadow[dst] = shadow[src]


@pytest.mark.parametrize("channels,seed", [(1, 21), (2, 22)])
def test_manager_under_faults_bit_identical_to_jax(channels, seed,
                                                   tmp_path):
    """150 random operations on both managers under one plan (swap 0.2,
    program 0.2, alloc 0.1), each with a journal: new / extend / free /
    swap_out / swap_in / precommit_growth, device-side growth replayed
    by ``reconcile_macro`` (one channel), and ``retire_bad_blocks`` of a
    mapped page with the pool rows. The same ops raise (OutOfBlocks,
    SwapFault) on both sides, and after every op the managers agree in
    everything (``assert_managers_equal``) and the pool rows equal the
    oracle's and the JAX pool's. Every axis fires, blocks retire, and
    the journals are equal byte for byte."""
    rng = random.Random(seed)
    n_slots, max_pages, n_dev, n_host = 4, 6, 20, 12
    tp, jp = planes(seed, channels=channels, swap_fail_p=0.2,
                    program_fail_p=0.2, alloc_fail_p=0.1)
    t = TKVM(n_slots, max_pages, n_dev, n_host, channels, faults=tp,
             device="cpu")
    j = JKVM(n_slots, max_pages, n_dev, n_host, channels=channels,
             faults=jp)
    dirs = {}
    for kvm, mod, name in ((t, TJ, "t"), (j, JJ, "j")):
        dirs[name] = str(tmp_path / name)
        kvm.journal = mod.Journal(dirs[name])
        kvm.journal.snapshot(kvm.snapshot_state())
    n_rows = n_dev + n_host + 1
    pool = torch.arange(n_rows * 3.0).reshape(n_rows, 3)
    jpool = jnp.asarray(pool.numpy())
    shadow = pool.numpy().copy()
    grow_fn = jax.jit(functools.partial(JB.serving_grow, j.geom),
                      donate_argnums=(0,))
    live = set()
    for step in range(150):
        ops = ["new"] if len(live) < n_slots else []
        if live:
            ops += ["extend", "free", "swap_out", "swap_in", "precommit",
                    "retire"] + (["macro"] if channels == 1 else [])
        op = rng.choice(ops)
        raised = []
        for kvm in (t, j):
            try:
                if op == "new":
                    slot = min(s for s in range(n_slots) if s not in live)
                    kvm.new_seq(slot, 1 + step % 3)
                elif op == "extend":
                    slot = sorted(live)[step % len(live)]
                    room = max_pages - len(kvm.seq_pages[slot])
                    if room and kvm.is_resident(slot):
                        kvm.extend_seq(slot, 1 + step % room)
                elif op == "free":
                    kvm.free_seq(sorted(live)[step % len(live)])
                elif op in ("swap_out", "swap_in"):
                    slot = sorted(live)[step % len(live)]
                    if kvm is t:
                        pre = list(t.seq_pages[slot])
                        getattr(t, op)(slot, [pool], check=step % 2 == 0)
                        _oracle_move(shadow, t.pool, pre, t.seq_pages[slot])
                    else:
                        [jpool], _ = getattr(j, op)(slot, [jpool],
                                                    check=step % 2 == 0)
                elif op == "precommit":
                    slots = [s for s in sorted(live) if kvm.is_resident(s)
                             and len(kvm.seq_pages[s]) < max_pages]
                    kvm.precommit_growth(slots)
                elif op == "retire":
                    cands = [(s * max_pages + i, b) for s in sorted(live)
                             for i, b in enumerate(kvm.seq_pages[s])
                             if not BlockPool.is_host(int(b))]
                    if not cands:
                        continue
                    bad = [cands[step % len(cands)]]
                    if kvm is t:
                        slot = bad[0][0] // max_pages
                        pre = list(t.seq_pages[slot])
                        t.retire_bad_blocks(bad, pools=[pool])
                        _oracle_move(shadow, t.pool, pre, t.seq_pages[slot])
                    else:
                        [jpool], _ = j.retire_bad_blocks(bad, pools=[jpool])
                else:   # growth on the device, replayed at the boundary
                    slots = [s for s in sorted(live) if kvm.is_resident(s)
                             and len(kvm.seq_pages[s]) < max_pages]
                    if not slots or kvm.pool.free_device < len(slots):
                        continue
                    kvm.sync_allocator()
                    grow = np.ones(len(slots), bool)
                    dl = np.asarray([s * max_pages + len(kvm.seq_pages[s])
                                     for s in slots], np.int32)
                    if kvm is t:
                        TB.serving_grow_(t.geom, t.state,
                                         torch.from_numpy(grow),
                                         torch.from_numpy(dl))
                    else:
                        j.state, _, _ = grow_fn(j.state, grow, dl)
                    kvm.reconcile_macro(list(slots))
            except (TOOB, JOOB, TF.SwapFault, JF.SwapFault) as e:
                raised.append((type(e).__name__,
                               getattr(e, "transient", None)))
        assert len(raised) in (0, 2), (step, op, raised)
        assert len({r for r, _ in raised}) <= 2 and \
            len({tr for _, tr in raised}) <= 1, (step, op, raised)
        if op == "new" and not raised:
            live.add(min(s for s in range(n_slots) if s not in live))
        elif op == "free":
            live.discard(sorted(live)[step % len(live)])
        tag = f"C={channels} seed {seed} step {step} ({op})"
        assert_managers_equal(t, j, tag)
        np.testing.assert_array_equal(pool.numpy(), shadow, tag)
        np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool), tag)
    st, jst = t.hit_stats(), j.hit_stats()
    for f in st.as_dict():
        assert st[f] == jst[f], f
    assert st["swap_faults"] and st["program_faults"] and st["alloc_faults"]
    assert st["retired_blocks"] > 0
    t.journal.close()
    j.journal.close()
    assert_journals_equal(dirs["t"], dirs["j"])
    rec_t, rec_j = TJ.replay(dirs["t"]), JJ.replay(dirs["j"])
    assert rec_t.mapping() == rec_j.mapping() == {
        s * max_pages + i: b for s, p in t.seq_pages.items()
        for i, b in enumerate(p)}
    assert sorted(rec_t.retired) == sorted(t.pool._retired)


def test_swap_fault_raises_before_any_change():
    """A scheduled swap failure raises ``SwapFault`` with the map state,
    pool and page lists untouched; the retry (next schedule bit clear)
    succeeds."""
    plan = TF.FaultPlan(seed=0, swap_fail=np.array([True, False]),
                        program_fail=np.zeros(2, bool),
                        alloc_fail=np.zeros(2, bool), stall=np.ones(1))
    t = TKVM(2, 4, 8, 8, faults=TF.FaultPlane(plan), device="cpu")
    t.new_seq(0, 3)
    pool = torch.zeros((17, 2))
    before = ([x.clone() for x in TB.state_tensors(t.state)],
              t.pool.state_dict(), dict(t.seq_pages))
    with pytest.raises(TF.SwapFault):
        t.swap_out(0, [pool])
    for a, b in zip(TB.state_tensors(t.state), before[0]):
        assert torch.equal(a, b)
    assert (t.pool.state_dict(), t.seq_pages) == before[1:]
    assert t.swap_out(0, [pool]) == 3


# ------------------------------------------------------------- engines
@pytest.mark.parametrize("channels,seeds", [(1, (100, 103)),
                                            (2, (101, 1003))])
def test_engine_lockstep_under_faults(llama, channels, seeds, tmp_path):
    """The reference chaos shape under the reference harness's seeded
    plans, journaled: the port's engine and the JAX engine stay in
    lockstep round by round (``lockstep``), give the fault-free tokens,
    the same map counters, and journals equal byte for byte; the
    device's committed lanes equal the journal's on both. Then a plan
    that fails most swaps (0.7, ``max_swap_retries`` 2) quarantines
    slots and still gives the fault-free tokens."""
    te, je = engine_pair(llama, channels=channels, **CHAOS)
    oracle, want = lockstep(te, je)
    assert oracle == want
    fired = {"swap": 0, "program": 0, "alloc": 0}
    runs = [chaos_schedule(s, channels) for s in seeds] + [
        dict(channels=channels, swap_fail_p=0.7, program_fail_p=0.1,
             alloc_fail_p=0.1)]
    for i, (seed, kw) in enumerate(zip(seeds + (7,), runs)):
        tp, jp = planes(seed, **kw)
        te.reset(tp)
        je.reset(jp)
        if i == len(runs) - 1:
            te.max_swap_retries = je.max_swap_retries = 2
        d_t, d_j = str(tmp_path / f"t{i}"), str(tmp_path / f"j{i}")
        te.attach_journal(d_t, snapshot_every=4)
        je.attach_journal(d_j, snapshot_every=4)
        got, got_j = lockstep(te, je)
        assert got == got_j == oracle, (seed, kw)
        st, jst = te.kvm.hit_stats(), je.kvm.hit_stats()
        for f in st.as_dict():
            assert st[f] == jst[f], f
        for k in fired:
            fired[k] += tp.counts()[k]
        assert te.journal_lane_check() and je.journal_lane_check()
        te.journal.close()
        je.journal.close()
        assert_journals_equal(d_t, d_j)
    assert te.metrics["quarantines"] > 0
    assert all(fired.values()), fired
    te.reset(None)
    je.reset(None)


def test_off_paths_commit_alike(llama, tmp_path):
    """With no plane and no journal the port's engine makes the JAX
    engine's map calls (``XLATE_CALLS``) and routes the same lanes per
    channel, with the same outputs; a zero-probability plane with a
    journal changes none of it (the stand-in for the reference's
    jaxpr-identity tests: the off paths do no extra map work)."""
    te, je = engine_pair(llama, channels=2, **CHAOS)
    counts = []
    for plane in (None, "zero"):
        tp, jp = planes(99, channels=2) if plane else (None, None)
        te.reset(tp)
        je.reset(jp)
        if plane:
            te.attach_journal(str(tmp_path / "t"))
            je.attach_journal(str(tmp_path / "j"))
        x_t, x_j = TKM.XLATE_CALLS[0], JKM.XLATE_CALLS[0]
        got, want = lockstep(te, je)
        assert got == want
        counts.append((got, TKM.XLATE_CALLS[0] - x_t,
                       te.kvm.channel_lanes.tolist()))
        assert counts[-1][1:] == (JKM.XLATE_CALLS[0] - x_j,
                                  je.kvm.channel_lanes.tolist())
    assert counts[0] == counts[1]
    assert te.faults.counts() == {"swap": 0, "program": 0, "alloc": 0,
                                  "crash": 0}
    te.reset(None)
    je.reset(None)


def test_mamba_macro_retirement_raises():
    """A mamba2 engine's K-step run whose pops hit a program fault
    raises where the reference would read ``caches["pool_k"]``: it has
    no KV pool to move the written rows in."""
    _, _, tm, tp = model_pair("mamba2-1.3b")
    eng = ServeEngine(tm, tp, config=ServeConfig(n_slots=2, max_ctx=64,
                                                 macro_k=4), device="cpu")
    eng.reset(TF.FaultPlane(TF.make_plan(3, program_fail_p=1.0)))
    for p in ([1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5]):
        eng.submit(p, max_new=6)
    with pytest.raises(NotImplementedError, match="mamba"):
        eng.run()


# --------------------------------------------------------------- config
def test_serve_config_fault_policy_and_durability():
    """``FaultPolicy`` / ``DurabilityConfig`` default like the
    reference's; the flat aliases set and read the nested fields;
    ``replace`` of a nested config is not undone by an alias; GC,
    prefix sharing and the mesh still raise."""
    import dataclasses
    assert TC.FaultPolicy() == TC.FaultPolicy(**dataclasses.asdict(
        JC.FaultPolicy()))
    assert dataclasses.asdict(TC.DurabilityConfig()) == \
        dataclasses.asdict(JC.DurabilityConfig())
    cfg = ServeConfig(n_slots=2, max_ctx=32, journal_path="j",
                      snapshot_every=3, max_swap_retries=5,
                      swap_backoff_cap=2, watchdog_rounds=9)
    want = JC.ServeConfig.from_legacy(
        n_slots=2, max_ctx=32, journal_path="j", snapshot_every=3,
        max_swap_retries=5, swap_backoff_cap=2, watchdog_rounds=9)
    assert dataclasses.asdict(cfg.faults) == dataclasses.asdict(want.faults)
    assert dataclasses.asdict(cfg.durability) == \
        dataclasses.asdict(want.durability)
    assert (cfg.journal_path, cfg.snapshot_every, cfg.max_swap_retries,
            cfg.swap_backoff_cap, cfg.watchdog_rounds) == ("j", 3, 5, 2, 9)
    moved = dataclasses.replace(cfg, durability=TC.DurabilityConfig("k"))
    assert moved.journal_path == "k" and moved.snapshot_every == 8
    # GC and prefix sharing are ported: beside a journal they are
    # accepted with the reference's defaults; the mesh still raises
    for name, cls in (("gc", "GCConfig"), ("prefix", "PrefixConfig")):
        got = getattr(ServeConfig(n_slots=2, max_ctx=32, journal_path="j",
                                  **{name: getattr(TC, cls)()}), name)
        assert dataclasses.asdict(got) == \
            dataclasses.asdict(getattr(JC, cls)())
    with pytest.raises(NotImplementedError):
        ServeConfig(n_slots=2, max_ctx=32, journal_path="j", use_mesh=True)
