"""The port's channel-sharded FMMU map against the JAX reference, on the
CPU.

Map: the reference's oracle sweep (``fmmu_lockstep.sharded_lockstep``:
random mixed LOOKUP / UPDATE / COND_UPDATE batches with duplicate and
overflowing keys, inactive lanes) drives the port's plain sharded commit
beside JAX ``translate_sharded`` for C in {1, 2, 4, 8}: every state
tensor, output and ok mask bit-identical after each batch, and the
interleaved table equal to the port's own one-channel
``translate_serving`` table. ``grow_sharded`` pops each lane's block
from its owner channel, and a dry channel fails and flags only its own
lanes.

Pool and page manager: ``BlockPool(n_channels=2)`` pops and frees as the
reference pool does and raises a channel's shortage before any pop; a
``KVPageManager(channels=2)`` stays bit-identical to the JAX manager
(``use_mesh=False``) after every operation of random new / extend /
free / swap / ``precommit_growth`` interleavings: state tensors,
per-channel free lists, block tables, retranslation and
``channel_lanes``.

Engine: the smoke llama config in float32 with the reference's
initialisation, ``channels=2``, stepped in lockstep with the JAX engine
single-step and at ``macro_k=4`` (a mid-run retirement, chunk-prefilled
forced lanes, and the reference's oversubscribed shape: 0 fallbacks,
swaps both ways); the
tokens equal the one-channel engine's; the sharded K-step runs equal
single steps on non-retiring runs; the reference's macro counter
contract; and a mamba2 engine at two channels."""
import functools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import fmmu_lockstep  # noqa: E402
from fmmu_lockstep import sharded_geometries  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.core.fmmu import batch as JB  # noqa: E402
from repro.models import Runtime as JRuntime  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.paging.kv_manager import KVPageManager as JKVM  # noqa: E402
from repro.paging.pool import BlockPool as JPool  # noqa: E402
from repro.paging.pool import OutOfBlocks as JOOB  # noqa: E402
from repro.serving.config import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.fmmu import batch as TB  # noqa: E402
from repro_torch.core.fmmu.types import FMMUGeometry  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.paging import kv_manager as TKM  # noqa: E402
from repro_torch.paging.kv_manager import KVPageManager as TKVM  # noqa: E402
from repro_torch.paging.pool import BlockPool  # noqa: E402
from repro_torch.paging.pool import OutOfBlocks as TOOB  # noqa: E402
from repro_torch.serving import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

PAGE = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _geom(jg) -> FMMUGeometry:
    return FMMUGeometry(**{f: getattr(jg, f)
                           for f in FMMUGeometry.__dataclass_fields__})


def _assert_state_equal(t_state, j_state, tag=""):
    """Every leaf of two (possibly channel-stacked) map states: same
    values and dtype."""
    for name in t_state._fields:
        tv, jv = getattr(t_state, name), getattr(j_state, name)
        if name == "fmmu":
            _assert_state_equal(tv, jv, f"{tag}.fmmu")
        elif tv is None or jv is None:
            assert tv is None and jv is None, f"{tag}.{name}"
        else:
            jn = np.asarray(jv)
            assert tv.numpy().dtype == jn.dtype, f"{tag}.{name}"
            np.testing.assert_array_equal(tv.numpy(), jn,
                                          err_msg=f"{tag}.{name}")


@pytest.fixture(scope="module", autouse=True)
def shared_jax_programs():
    """JAX page managers and engines of one configuration share their
    compiled programs: a manager's sharded commit, retranslation,
    allocator re-push and swap jits are functions of its geometry and
    grid; an engine's decode, prefill and K-step programs of the model
    and the configuration. The cases pay for tracing each shape once."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JB, "make_jitted",
               functools.lru_cache(maxsize=None)(JB.make_jitted))
    shared = {}
    kvm_init = JKVM.__init__

    def shared_kvm_init(self, *args, **kwargs):
        kvm_init(self, *args, **kwargs)
        key = ("kvm", self.geom, self.channels, self.n_slots,
               self.max_pages)
        progs = shared.setdefault(key, {})
        for name in ("_xlate_graph", "_serve_sharded", "_retrans_fn",
                     "_set_alloc", "_swap_jits"):
            if not hasattr(self, name):
                continue
            if name in progs:
                setattr(self, name, progs[name])
            else:
                progs[name] = getattr(self, name)
    mp.setattr(JKVM, "__init__", shared_kvm_init)
    eng_init = JServeEngine.__init__

    def shared_eng_init(self, *args, **kwargs):
        eng_init(self, *args, **kwargs)
        key = (id(self.m), self.page, self.n_slots, self.max_pages,
               self.scratch_block, self.macro_k, self.eos_id,
               self.channels, self.kvm.geom)
        progs = shared.setdefault(key, {})
        for name in ("_decode", "_prefill", "_macro", "_macro_simple",
                     "_macro_sh", "_macro_sh_simple"):
            if name in progs:
                setattr(self, name, progs[name])
            else:
                progs[name] = getattr(self, name)
    mp.setattr(JServeEngine, "__init__", shared_eng_init)
    yield
    mp.undo()


# ------------------------------------------------------------ the map
@functools.lru_cache(maxsize=None)
def _jitted(fn, *static):
    return jax.jit(functools.partial(fn, *static))


class _PortBeside:
    """Stands in for ``fmmu_lockstep.FB`` inside ``sharded_lockstep``:
    every call goes to the JAX module, and the sharded and one-channel
    serving commits run the port's plain versions on the same inputs
    beside it, held bit-identical after every batch."""

    def __init__(self):
        self.port = {}
        self.batches = 0

    def __getattr__(self, name):
        return getattr(JB, name)

    def init_serving_state(self, g, *a, **kw):
        self.port["one"] = (_geom(g), TB.init_serving_state(
            _geom(g), device="cpu"))
        return JB.init_serving_state(g, *a, **kw)

    def init_sharded_state(self, g, c_n, *a, **kw):
        self.port["sharded"] = (_geom(g), TB.init_sharded_state(
            _geom(g), c_n, device="cpu"))
        return JB.init_sharded_state(g, c_n, *a, **kw)

    def translate_serving(self, g, ms, *lanes):
        res = _jitted(JB.translate_serving, g)(ms, *lanes)
        tg, tms = self.port["one"]
        self.port["one"] = (tg, TB.translate_serving(
            tg, tms, *(_t(x) for x in lanes))[0])
        return res

    def translate_sharded(self, g, c_n, ms, *lanes):
        jms, jout, jok = _jitted(JB.translate_sharded, g, c_n)(ms, *lanes)
        tg, tms = self.port["sharded"]
        tms, out, ok = TB.translate_sharded(tg, c_n, tms,
                                            *(_t(x) for x in lanes))
        self.port["sharded"] = (tg, tms)
        tag = f"C={c_n} batch {self.batches}"
        _assert_state_equal(tms, jms, tag)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout), tag)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok), tag)
        one = self.port["one"][1]
        n = one.table.shape[0]
        np.testing.assert_array_equal(
            TB.dense_table(tms, n).numpy(), one.table.numpy(), tag)
        self.batches += 1
        return jms, jout, jok


@pytest.mark.parametrize("channels", [1, 2, 4, 8])
def test_translate_sharded_lockstep_bit_identical_to_jax(channels,
                                                         monkeypatch):
    """The reference's sharded oracle sweep with the port beside JAX:
    after every batch every state tensor, output and ok mask equals JAX
    ``translate_sharded``'s, and the interleaved table equals the port's
    one-channel ``translate_serving`` table."""
    beside = _PortBeside()
    monkeypatch.setattr(fmmu_lockstep, "FB", beside)
    res = fmmu_lockstep.sharded_lockstep(3, channels, n_batches=20)
    assert res.startswith("OK"), res
    assert beside.batches == 20


def test_grow_sharded_pops_owner_channel_and_flags_dry_channel():
    """Each growth lane pops from its dlpn's owner channel; a dry
    channel fails only its own lanes and raises only its own oob flag;
    bit-identical to JAX ``grow_sharded`` (state, blocks, ok, table)."""
    c_n = 2
    _, jg = sharded_geometries(c_n)
    g = _geom(jg)
    tms = TB.init_sharded_state(g, c_n, n_device_blocks=4, device="cpu")
    jms = JB.init_sharded_state(jg, c_n, n_device_blocks=4)
    _assert_state_equal(tms, jms, "init")
    for grow, dl, want_blocks, want_oob in (
            ([True, True, True], [0, 1, 2], [0, 1, 2], [False, False]),
            ([True, False, True], [4, 6, 3], [-1, -1, 3], [True, False])):
        grow, dl = np.asarray(grow), np.asarray(dl, np.int32)
        tms, blocks, ok = TB.grow_sharded(g, c_n, tms, _t(grow), _t(dl))
        jms, jblocks, jok = JB.grow_sharded(jg, c_n, jms, jnp.asarray(grow),
                                            jnp.asarray(dl))
        _assert_state_equal(tms, jms, f"grow {dl}")
        np.testing.assert_array_equal(blocks.numpy(), np.asarray(jblocks))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        assert blocks.tolist() == want_blocks
        assert TB.oob_vec(tms).tolist() == want_oob
    assert TB.dense_table(tms, 8).tolist() == [0, 1, 2, 3, -1, -1, -1, -1]


def test_sharded_state_helpers_bit_identical_to_jax():
    """``init_sharded_state`` (both tiers striped, [C] lanes),
    ``set_allocator_sharded``, ``mark_swap_sharded`` and the in-place
    ``mark_swap_`` on a stacked state (the flip lands in every channel's
    copy), ``interleave_table`` and ``commit_seq_vec``."""
    c_n = 4
    _, jg = sharded_geometries(c_n)
    g = _geom(jg)
    tms = TB.init_sharded_state(g, c_n, 10, 6, n_lanes=3, device="cpu")
    jms = JB.init_sharded_state(jg, c_n, 10, 6, n_lanes=3)
    _assert_state_equal(tms, jms, "init")
    pool = JPool(10, 6, n_channels=c_n)
    for c in range(c_n):
        n = int(tms.free_n[c])
        assert tms.free_stack[c, :n].tolist() == pool._free_dev_ch[c]
        assert tms.host_stack[c, :int(tms.host_n[c])].tolist() == \
            pool._free_host_ch[c]
    dev = np.full((c_n, 3), -1, np.int32)
    dev[:, 0] = [7, 5, 6, 3]
    host = np.zeros((c_n, 2), np.int32)
    args = (dev, np.int32([1, 1, 1, 1]), host, np.int32([0, 0, 0, 0]),
            np.asarray([False, True, False]))
    tms = TB.set_allocator_sharded(tms, *args)
    jms = JB.set_allocator_sharded(jms, *args)
    _assert_state_equal(tms, jms, "set_allocator")
    for lane, pending in ((2, True), (1, False)):
        t2 = TB.mark_swap_sharded(tms, lane, pending)
        jms = JB.mark_swap_sharded(jms, lane, pending)
        _assert_state_equal(t2, jms, f"mark {lane}")
        TB.mark_swap_(tms, lane, pending)
        _assert_state_equal(tms, jms, f"mark_ {lane}")
    table = np.arange(c_n * 5, dtype=np.int32).reshape(c_n, 5)
    np.testing.assert_array_equal(
        TB.interleave_table(_t(table), 17).numpy(),
        np.asarray(JB.interleave_table(jnp.asarray(table), 17)))
    np.testing.assert_array_equal(
        TB.interleave_table(_t(table[0]), 3).numpy(), table[0, :3])
    np.testing.assert_array_equal(TB.commit_seq_vec(tms).numpy(),
                                  np.asarray(JB.commit_seq_vec(jms)))


# ------------------------------------------------------------ the pool
def test_pool_channels_pop_and_free_like_the_reference():
    """Random alloc (round-robin) / alloc_for / free on both pools, both
    tiers: the same blocks in the same order, the same per-channel
    lists and exhaustion counts; a channel's shortage raises before any
    pop (``OutOfBlocks.channel`` names it)."""
    rng = random.Random(4)
    t, j = BlockPool(9, 6, n_channels=2), JPool(9, 6, n_channels=2)
    held = []
    for step in range(200):
        op = rng.choice(["alloc", "alloc_for", "free"])
        host = rng.random() < 0.3
        n = rng.randint(1, 3)
        chans = [rng.randrange(2) for _ in range(n)]
        drop = held[:rng.randint(0, len(held))]
        got = []
        for pool, oob in ((t, TOOB), (j, JOOB)):
            try:
                if op == "alloc":
                    got.append(pool.alloc(n, host=host))
                elif op == "alloc_for":
                    got.append(pool.alloc_for(chans, host=host))
                else:
                    pool.free(drop)
                    got.append(drop)
            except oob as e:
                got.append(("raised", e.channel))
        assert got[0] == got[1], (step, op, got)
        if op == "free":
            held = held[len(got[0]):]
        elif got[0][0] != "raised":
            held += got[0]
        assert t._free_dev_ch == j._free_dev_ch, step
        assert t._free_host_ch == j._free_host_ch, step
        assert t.exhausted_ch == j.exhausted_ch, step
        assert (t.free_device, t.free_host) == (j.free_device, j.free_host)
    assert sum(t.exhausted_ch) > 0
    t = BlockPool(4, 0, n_channels=2)
    assert t.alloc_for([0, 1, 0]) == [0, 1, 2]
    with pytest.raises(TOOB) as e:
        t.alloc_for([1, 0])                  # channel 0 dry
    assert e.value.channel == 0 and t.free_device == 1
    t.free([2])
    assert t._free_dev_ch == [[2], [3]] and t.channel_of(3) == 1


# ------------------------------------------------------- page manager
def _assert_managers_equal(t, j, tag=""):
    _assert_state_equal(t.state, j.state, tag)
    assert t.pool._free_dev_ch == j.pool._free_dev_ch, tag
    assert t.pool._free_host_ch == j.pool._free_host_ch, tag
    assert t.seq_pages == {s: [int(b) for b in p]
                           for s, p in j.seq_pages.items()}, tag
    assert t._host_pages == j._host_pages, tag
    assert t.pool.exhausted_ch == j.pool.exhausted_ch, tag
    np.testing.assert_array_equal(t.channel_lanes, j.channel_lanes, tag)
    np.testing.assert_array_equal(t.free_device_vec(), j.free_device_vec())


def test_kvm_channels_random_interleavings_bit_identical_to_jax():
    """100 random operations on a two-channel port manager and the JAX
    one: new / extend / free / swap_out / swap_in (check on or off) and
    ``precommit_growth`` (the sharded K-step boundary). After every
    operation the managers agree in every state tensor, per-channel
    free list, page list, residency count and ``channel_lanes``, and the
    pool rows equal JAX's; every 15 operations the block tables, the
    retranslation and the re-pushed stacks (with ``host_pages_vec``)
    agree too."""
    rng = random.Random(7)
    n_slots, max_pages, n_dev, n_host = 4, 6, 16, 10
    t = TKVM(n_slots, max_pages, n_dev, n_host, channels=2, device="cpu")
    j = JKVM(n_slots, max_pages, n_dev, n_host, channels=2, use_mesh=False)
    _assert_managers_equal(t, j, "init")
    n_rows = n_dev + n_host + 1
    pool = torch.arange(n_rows * 3.0).reshape(n_rows, 3)
    jpool = jnp.asarray(pool.numpy())
    live = set()
    seen = set()
    for step in range(100):
        ops = ["new"] if len(live) < n_slots else []
        if live:
            ops += ["extend", "free", "swap_out", "swap_in", "pre"]
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
                    if room:
                        kvm.extend_seq(slot, 1 + step % room)
                elif op == "free":
                    kvm.free_seq(sorted(live)[step % len(live)])
                elif op == "pre":
                    slots = [s for s in sorted(live) if kvm.is_resident(s)
                             and len(kvm.seq_pages[s]) <= max_pages - 2]
                    if slots:
                        kvm.precommit_growth(slots + slots[:1])
                else:
                    slot = sorted(live)[step % len(live)]
                    check = step % 2 == 0
                    if kvm is t:
                        getattr(t, op)(slot, [pool], check=check)
                    else:
                        [jpool], _ = getattr(j, op)(slot, [jpool],
                                                    check=check)
            except (TOOB, JOOB) as e:
                raised.append(type(e).__name__)
        assert len(raised) in (0, 2), (step, op, raised)
        if not raised:
            seen.add(op)
        if op == "new" and not raised:
            live.add(min(s for s in range(n_slots) if s not in live))
        elif op == "free":
            live.discard(sorted(live)[step % len(live)])
        tag = f"step {step} ({op})"
        _assert_managers_equal(t, j, tag)
        np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool), tag)
        if step % 15 == 14:
            tables = t.block_tables().numpy()
            np.testing.assert_array_equal(tables,
                                          np.asarray(j.block_tables()))
            again = t.retranslate_tables().numpy()
            np.testing.assert_array_equal(again, tables)
            np.testing.assert_array_equal(again,
                                          np.asarray(j.retranslate_tables()))
            for kvm in (t, j):
                kvm.sync_allocator()
            _assert_managers_equal(t, j, tag)
            for s in live:
                np.testing.assert_array_equal(t.host_pages_vec(s),
                                              j.host_pages_vec(s))
    assert seen >= {"new", "extend", "free", "swap_out", "swap_in", "pre"}
    assert (t.channel_lanes > 0).all()
    assert t.pool.stats.swaps_out and t.pool.stats.swaps_in
    st, jst = t.hit_stats(), j.hit_stats()
    for f in st.as_dict():
        assert st[f] == jst[f], f


def test_kvm_channels_swap_pending_in_every_channel_and_one_commit():
    """A swap on a two-channel manager flips the residency lane in both
    channels' copies and is one map call of two probes (one per
    channel); ``reconcile_macro`` refuses to run at C > 1."""
    t = TKVM(n_slots=3, max_pages=4, n_device_blocks=8, n_host_blocks=8,
             channels=2, device="cpu")
    t.new_seq(0, 3)
    pool = torch.zeros((17, 2))
    x0, p0 = TKM.XLATE_CALLS[0], TB.PROBE_CALLS[0]
    assert t.swap_out(0, [pool]) == 3
    assert (TKM.XLATE_CALLS[0] - x0, TB.PROBE_CALLS[0] - p0) == (1, 2)
    assert t.state.swap_pending.tolist() == [[True, False, False]] * 2
    assert t.swap_in(0, [pool]) == 3
    assert not t.state.swap_pending.any()
    with pytest.raises(AssertionError, match="reconcile_macro"):
        t.reconcile_macro([0])


# ------------------------------------------------------------ engines
def _pair(arch):
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
def models():
    return {"llama3.2-1b": _pair("llama3.2-1b"),
            "mamba2-1.3b": _pair("mamba2-1.3b")}


METRICS = ("prefills", "decode_steps", "preemptions", "generated",
           "macro_steps", "macro_fallbacks", "swaps_out", "swaps_in")
# the reference tests' shapes (tests/test_sharded_map.py): a 7-token
# prompt x 10 and a 23-token one x 7 (retiring mid-run at K=4); four
# 8-token prompts x 24 on 10 device blocks and 24 host blocks
RETIRING_REQS = [(range(1, 8), 10), (range(50, 73), 7)]
OVERSUB = dict(n_slots=4, max_ctx=64, n_device_blocks=10, n_host_blocks=24,
               macro_k=4, swap_patience=2)
OVERSUB_REQS = [(range(1 + 20 * i, 9 + 20 * i), 24) for i in range(4)]


def _port_engine(pair, **cfg):
    _, _, tm, tp = pair
    return ServeEngine(tm, tp, config=ServeConfig(**cfg), device="cpu")


def _serve(eng, reqs):
    rids = [eng.submit(list(t), max_new=n) for t, n in reqs]
    done = eng.run()
    return [done[r] for r in rids]


def _lockstep(pair, reqs, **cfg):
    """The port's and the JAX engine round by round; after every round
    the same slots, pages, per-channel free lists, residency, context
    lengths, per-channel growth needs and counters. Returns (port
    tokens, JAX tokens, port engine, JAX engine)."""
    jm, jp, _, _ = pair
    te = _port_engine(pair, **cfg)
    je = JServeEngine(jm, jp, config=JServeConfig(**cfg))
    rids = [(te.submit(list(t), max_new=n), je.submit(list(t), max_new=n))
            for t, n in reqs]
    done_t, done_j = {}, {}
    for rnd in range(10_000):
        more = te.step(done_t)
        assert more == je.step(done_j), rnd
        assert {r.rid: r.slot for r in te.active.values()} == \
            {r.rid: r.slot for r in je.active.values()}, rnd
        assert te.kvm.seq_pages == {s: [int(b) for b in p] for s, p in
                                    je.kvm.seq_pages.items()}, rnd
        assert te.kvm.pool._free_dev_ch == je.kvm.pool._free_dev_ch, rnd
        assert te.kvm._host_pages == je.kvm._host_pages, rnd
        np.testing.assert_array_equal(te.ctx_lens, je.ctx_lens)
        for r in te.active.values():
            np.testing.assert_array_equal(te._growth_need_ch(r.slot),
                                          je._growth_need_ch(r.slot))
        assert {k: te.metrics[k] for k in METRICS} == \
            {k: je.metrics[k] for k in METRICS}, rnd
        if not more:
            break
    return ([done_t[a] for a, _ in rids], [done_j[b] for _, b in rids],
            te, je)


@pytest.mark.parametrize("macro_k", [0, 4])
def test_sharded_engine_identical_to_jax_and_one_channel(models, macro_k):
    """channels=2, single-step and at macro_k=4 (the 23-token request
    retires mid-run): the JAX engine's tokens, pages, free lists and
    map state round by round, and the one-channel engine's tokens."""
    pair = models["llama3.2-1b"]
    cfg = dict(n_slots=2, max_ctx=64, macro_k=macro_k)
    got, want, te, je = _lockstep(pair, RETIRING_REQS, channels=2, **cfg)
    assert got == want
    _assert_state_equal(te.kvm.state, je.kvm.state)
    np.testing.assert_array_equal(te.kvm.channel_lanes,
                                  je.kvm.channel_lanes)
    if macro_k:
        assert te.metrics["macro_steps"] > 0
        assert te.metrics["macro_fallbacks"] == 0
    assert got == _serve(_port_engine(pair, **cfg), RETIRING_REQS)


def test_sharded_forced_lanes_identical_to_jax(models):
    """Chunked admission at two channels (``admit_tokens=12``: the 33-
    and 20-token prompts stream through the K-step runs as forced
    lanes, the 5-token request retires mid-run): the JAX engine's
    tokens and map state round by round, and the one-channel engine's
    tokens."""
    pair = models["llama3.2-1b"]
    cfg = dict(n_slots=4, max_ctx=128, macro_k=4, admit_tokens=12)
    reqs = [(range(1, 34), 6), (range(90, 95), 3), (range(40, 46), 13),
            (range(60, 80), 10)]
    got, want, te, je = _lockstep(pair, reqs, channels=2, **cfg)
    assert got == want
    assert te.metrics["chunked_prefills"] > 0
    assert te.metrics["macro_fallbacks"] == 0
    _assert_state_equal(te.kvm.state, je.kvm.state)
    assert got == _serve(_port_engine(pair, **cfg), reqs)


def test_sharded_oversubscribed_zero_fallbacks_identical_to_jax(models):
    """About 2x oversubscription on a two-channel engine: every round
    stays on the sharded K-step path (0 fallbacks), swaps go both ways,
    and the tokens, counters and final map state equal the JAX
    engine's; the tokens equal uncontended one-channel runs'."""
    pair = models["llama3.2-1b"]
    got, want, te, je = _lockstep(pair, OVERSUB_REQS, channels=2,
                                  **OVERSUB)
    assert got == want
    assert te.metrics["macro_fallbacks"] == 0
    assert te.metrics["swaps_out"] > 0 and te.metrics["swaps_in"] > 0
    _assert_state_equal(te.kvm.state, je.kvm.state)
    st, jst = te.kvm.hit_stats(), je.kvm.hit_stats()
    for f in st.as_dict():
        assert st[f] == jst[f], f
    assert got == _serve(_port_engine(pair, **dict(OVERSUB, macro_k=0)),
                         OVERSUB_REQS)


def test_sharded_macro_equals_single_steps(models):
    """Non-retiring runs (budgets of multiples of K): the two-channel
    K-step path equals single steps in tokens, block tables, page lists,
    per-channel free lists and committed map lanes, and the re-pushed
    device stacks mirror the free lists."""
    pair = models["llama3.2-1b"]
    reqs = [(range(1, 8), 8), (range(30, 53), 8)]

    def run(macro_k):
        eng = _port_engine(pair, n_slots=2, max_ctx=64, macro_k=macro_k,
                           channels=2)
        return _serve(eng, reqs), eng
    got_s, eng_s = run(0)
    got_m, eng_m = run(4)
    assert eng_m.metrics["macro_steps"] > 0
    assert got_s == got_m
    for eng in (eng_s, eng_m):
        assert eng.kvm.seq_pages == {}
    assert eng_s.kvm.pool._free_dev_ch == eng_m.kvm.pool._free_dev_ch
    assert eng_s._device_lanes() == eng_m._device_lanes() > 0
    np.testing.assert_array_equal(eng_s.kvm.block_tables().numpy(),
                                  eng_m.kvm.block_tables().numpy())
    eng_m.kvm.sync_allocator()
    st = eng_m.kvm.state
    for c in range(2):
        n = int(st.free_n[c])
        assert n == eng_m.kvm.pool.free_device_ch(c)
        assert st.free_stack[c, :n].tolist() == eng_m.kvm.pool._free_dev_ch[c]


def test_sharded_macro_counter_contract(models):
    """Per K tokens in sharded steady state: one macro dispatch, one host
    sync, at most one map call (and so at most C probes), no allocator
    re-sync, no retranslation, no fallback; the routed lanes split
    about evenly over the channels."""
    eng = _port_engine(models["llama3.2-1b"], n_slots=2, max_ctx=256,
                       macro_k=8, channels=2)
    eng.min_page_bucket = 32
    eng.submit(list(range(1, 9)), max_new=10 ** 6)
    eng.submit(list(range(20, 28)), max_new=10 ** 6)
    done: dict = {}
    for _ in range(2):
        eng.step(done)
    grew = 0
    for _ in range(6):
        d0, s0 = TE.MACRO_DISPATCHES[0], TE.HOST_SYNCS[0]
        x0, f0, a0 = (TKM.XLATE_CALLS[0], TKM.FULL_TABLE_CALLS[0],
                      TKM.ALLOC_SYNCS[0])
        p0, n0 = TB.PROBE_CALLS[0], eng.metrics["decode_steps"]
        eng.step(done)
        assert eng.metrics["decode_steps"] - n0 == 8
        assert TE.MACRO_DISPATCHES[0] - d0 == 1
        assert TE.HOST_SYNCS[0] - s0 == 1
        assert TKM.XLATE_CALLS[0] - x0 <= 1
        assert TB.PROBE_CALLS[0] - p0 == 2 * (TKM.XLATE_CALLS[0] - x0)
        assert TKM.FULL_TABLE_CALLS[0] - f0 == 0
        assert TKM.ALLOC_SYNCS[0] - a0 == 0
        grew += TKM.XLATE_CALLS[0] - x0
    assert grew > 0
    assert eng.metrics["macro_fallbacks"] == 0
    lanes = eng.kvm.channel_lanes
    assert lanes.min() >= lanes.sum() // 4, lanes


def test_mamba2_engine_at_two_channels_identical_to_jax(models):
    """mamba2 (attention-free: its pages still grow through the map) at
    channels=2 and macro_k=4: the JAX engine's tokens and map state."""
    pair = models["mamba2-1.3b"]
    reqs = [(range(1, 12), 6), (range(50, 87), 5)]
    got, want, te, je = _lockstep(pair, reqs, n_slots=2, max_ctx=64,
                                  macro_k=4, channels=2)
    assert got == want
    assert te.metrics["macro_steps"] > 0
    _assert_state_equal(te.kvm.state, je.kvm.state)


def test_serve_config_channels_and_use_mesh():
    """``channels > 1`` builds a sharded engine config, with a journal
    too; ``use_mesh=True`` (the channel mesh across devices) still
    raises, as do the other unported planes; the defaults are the
    reference's."""
    assert ServeConfig(n_slots=2, max_ctx=32, channels=4).channels == 4
    assert ServeConfig(n_slots=2, max_ctx=32).use_mesh is \
        JServeConfig(n_slots=2, max_ctx=32).use_mesh
    for kw in (dict(use_mesh=True), dict(channels=2, use_mesh=True),
               dict(channels=2, journal_path="j.log", prefix=object())):
        with pytest.raises(NotImplementedError):
            ServeConfig(n_slots=2, max_ctx=32, **kw)
    assert ServeConfig(n_slots=2, max_ctx=32, channels=2,
                       journal_path="j.log").journal_path == "j.log"
