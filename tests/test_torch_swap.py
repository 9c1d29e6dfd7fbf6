"""The port's host tier and non-blocking swap pipeline against the JAX
reference, on the CPU.

Page manager: a swap-out / swap-in round trip moves the pool rows as a
numpy oracle replays them (the page whose block id changed carries its
row from the old block's row to the new one's; host blocks at
``pool.host_row``), and random interleavings of new / extend / free /
swap_out / swap_in / device-side growth leave every map state tensor,
both pool free lists, ``seq_pages`` and the residency counts
bit-identical to the JAX manager's after every operation. A swap is one
map call, and with ``check=False`` reads nothing back.

Engine: the smoke llama config in float32 with the reference's
initialisation (``convert.params_from_jax``), stepped in lockstep with
the JAX engine at the reference tests' oversubscribed shape (4 slots,
10 device blocks, 24 host blocks, ``macro_k=4``, ``swap_patience=2``),
with ``nonblocking_swap`` off, and at its preemption shape
(single-step): after every round the same slots, pages, residency and
counters; at the end the same tokens and map state. A mamba2 engine
with a host tier gives the JAX engine's tokens; swapping one of its
slots raises (the reference cannot swap an attention-free model: it
reads ``caches["pool_k"]``)."""
import functools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.core.fmmu import batch as JB  # noqa: E402
from repro.models import Runtime as JRuntime  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.paging.kv_manager import KVPageManager as JKVM  # noqa: E402
from repro.paging.pool import OutOfBlocks as JOOB  # noqa: E402
from repro.serving.config import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.fmmu import batch as TB  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.paging import kv_manager as TKM  # noqa: E402
from repro_torch.paging.kv_manager import KVPageManager as TKVM  # noqa: E402
from repro_torch.paging.pool import BlockPool  # noqa: E402
from repro_torch.paging.pool import OutOfBlocks as TOOB  # noqa: E402
from repro_torch.serving import ServeConfig, ServeEngine  # noqa: E402

PAGE = 8


# ------------------------------------------------------------ helpers
def _assert_state_equal(t_state, j_state, tag=""):
    """Every leaf of two ServingMapStates: same values and dtype."""
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


def _assert_managers_equal(t, j, tag=""):
    """Map state, both free lists in order, page lists, residency."""
    _assert_state_equal(t.state, j.state, tag)
    assert t.pool._free_dev == j.pool._free_dev, tag
    assert t.pool._free_host == j.pool._free_host, tag
    assert t.seq_pages == {s: [int(b) for b in p]
                           for s, p in j.seq_pages.items()}, tag
    assert t._host_pages == j._host_pages, tag
    assert t.pool.exhausted_ch == j.pool.exhausted_ch, tag
    assert (t.pool.stats.swaps_out, t.pool.stats.swaps_in) == \
        (j.pool.stats.swaps_out, j.pool.stats.swaps_in), tag


def _oracle_apply_swap(shadow, pool, pre_pages, post_pages):
    """Replay one swap's tier moves on a numpy shadow of the pool: a
    page whose block id changed moved tiers, its row travelling from
    the old block's row to the new block's row."""
    def row(b):
        return pool.host_row(b) if BlockPool.is_host(b) else b
    src = [row(a) for a, b in zip(pre_pages, post_pages) if a != b]
    dst = [row(b) for a, b in zip(pre_pages, post_pages) if a != b]
    shadow[dst] = shadow[src]


@pytest.fixture(scope="module", autouse=True)
def shared_jax_programs():
    """JAX page managers and engines of one configuration share their
    compiled programs (a manager's jitted map commits are a function of
    its geometry alone; an engine's decode, prefill and K-step programs
    of the model and the configuration in ``_program_key``), so the
    cases pay for tracing each shape once."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JB, "make_jitted",
               functools.lru_cache(maxsize=None)(JB.make_jitted))
    shared = {}
    init = JServeEngine.__init__

    def shared_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        key = (id(self.m), self.page, self.n_slots, self.max_pages,
               self.scratch_block, self.macro_k, self.eos_id,
               self.channels, self.kvm.geom)
        programs = shared.setdefault(key, {})
        for name in ("_decode", "_prefill", "_macro", "_macro_simple"):
            if name in programs:
                setattr(self, name, programs[name])
            else:
                programs[name] = getattr(self, name)
        swaps = shared.setdefault(("swap",) + key, {})
        self.kvm._swap_jits = swaps
    mp.setattr(JServeEngine, "__init__", shared_init)
    yield
    mp.undo()


# ------------------------------------------------------- page manager
def test_swap_round_trip_moves_rows_like_the_oracle():
    """swap_out then swap_in of a 3-page slot: the pool rows equal the
    numpy oracle's after each, the residency lane flips with the data,
    the map state equals the JAX manager's, and the incremental table
    equals a from-scratch retranslation."""
    t = TKVM(n_slots=2, max_pages=4, n_device_blocks=4, n_host_blocks=4,
             device="cpu")
    j = JKVM(n_slots=2, max_pages=4, n_device_blocks=4, n_host_blocks=4)
    _assert_managers_equal(t, j, "init")
    t.new_seq(0, 3)
    j.new_seq(0, 3)
    pool = torch.arange((4 + 4 + 1) * 5.0).reshape(9, 5)
    jpool = jnp.asarray(pool.numpy())
    shadow = pool.numpy().copy()
    for out in (True, False):
        pre = list(t.seq_pages[0])
        fn = t.swap_out if out else t.swap_in
        assert fn(0, [pool]) == 3
        [jpool], _ = (j.swap_out if out else j.swap_in)(0, [jpool])
        assert bool(t.state.swap_pending[0]) is out
        assert t.is_resident(0) is not out
        _oracle_apply_swap(shadow, t.pool, pre, t.seq_pages[0])
        np.testing.assert_array_equal(pool.numpy(), shadow)
        np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool))
        _assert_managers_equal(t, j, f"out={out}")
    np.testing.assert_array_equal(t.block_tables().numpy(),
                                  t.retranslate_tables().numpy())


@pytest.mark.parametrize("seed", [11, 12])
def test_random_interleavings_bit_identical_to_jax(seed):
    """120 random operations on both managers: new / extend / free /
    swap_out / swap_in (check on or off) and device-side growth
    (``serving_grow`` + ``reconcile_macro``, the K-step run's path). After
    every operation the two managers agree in everything
    (``_assert_managers_equal``) and the port's pool rows equal the numpy
    oracle's; every 15 operations the table equals a retranslation and
    the re-pushed device stacks equal the free lists."""
    rng = random.Random(seed)
    n_slots, max_pages, n_dev, n_host = 4, 6, 16, 10
    t = TKVM(n_slots, max_pages, n_dev, n_host, device="cpu")
    j = JKVM(n_slots, max_pages, n_dev, n_host)
    n_rows = n_dev + n_host + 1
    pool = torch.arange(n_rows * 3.0).reshape(n_rows, 3)
    jpool = jnp.asarray(pool.numpy())
    shadow = pool.numpy().copy()
    grow_fn = jax.jit(functools.partial(JB.serving_grow, j.geom),
                      donate_argnums=(0,))
    live = set()
    for step in range(120):
        ops = ["new"] if len(live) < n_slots else []
        if live:
            ops += ["extend", "free", "swap_out", "swap_in", "macro"]
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
                    slot = sorted(live)[step % len(live)]
                    kvm.free_seq(slot)
                elif op in ("swap_out", "swap_in"):
                    slot = sorted(live)[step % len(live)]
                    check = step % 2 == 0
                    if kvm is t:
                        pre = list(t.seq_pages[slot])
                        getattr(t, op)(slot, [pool], check=check)
                        _oracle_apply_swap(shadow, t.pool, pre,
                                           t.seq_pages[slot])
                    else:
                        [jpool], _ = getattr(j, op)(slot, [jpool],
                                                    check=check)
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
                        _, ok = TB.serving_grow_(t.geom, t.state,
                                                 torch.from_numpy(grow),
                                                 torch.from_numpy(dl))
                    else:
                        j.state, _, ok = grow_fn(j.state, grow, dl)
                    assert bool(np.asarray(ok).all())
                    kvm.reconcile_macro(list(slots))
            except (TOOB, JOOB) as e:
                raised.append(type(e).__name__)
        assert len(raised) in (0, 2), (step, op, raised)
        if op == "new" and not raised:
            live.add(min(s for s in range(n_slots) if s not in live))
        elif op == "free":
            live.discard(sorted(live)[step % len(live)])
        tag = f"seed {seed} step {step} ({op})"
        _assert_managers_equal(t, j, tag)
        np.testing.assert_array_equal(pool.numpy(), shadow, tag)
        np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool), tag)
        if step % 15 == 14:
            for kvm in (t, j):
                np.testing.assert_array_equal(
                    np.asarray(kvm.block_tables()),
                    np.asarray(kvm.retranslate_tables()))
                kvm.sync_allocator()
            _assert_managers_equal(t, j, tag)
            st = t.state
            assert int(st.free_n) == t.pool.free_device
            assert int(st.host_n) == t.pool.free_host
            np.testing.assert_array_equal(st.free_stack[:int(st.free_n)],
                                          np.asarray(t.pool._free_dev))
            np.testing.assert_array_equal(st.host_stack[:int(st.host_n)],
                                          np.asarray(t.pool._free_host))
            np.testing.assert_array_equal(
                st.swap_pending.numpy(),
                [not t.is_resident(s) for s in range(n_slots)])
    assert t.pool.stats.swaps_out and t.pool.stats.swaps_in


def test_swap_pending_lane_tracks_residency():
    """Set by swap_out, cleared by swap_in, and refreshed from the host's
    tier bookkeeping by ``sync_allocator`` after a host-side free of a
    swapped-out slot (bit-identical to the JAX manager throughout)."""
    t = TKVM(n_slots=3, max_pages=4, n_device_blocks=8, n_host_blocks=8,
             device="cpu")
    j = JKVM(n_slots=3, max_pages=4, n_device_blocks=8, n_host_blocks=8)
    pool = torch.zeros((17, 2))
    jpool = jnp.zeros((17, 2))
    for kvm in (t, j):
        kvm.new_seq(0, 2)
        kvm.new_seq(1, 2)

    def lanes():
        return t.state.swap_pending.tolist()
    assert lanes() == [False, False, False]
    for op, slot, want in (("swap_out", 1, [False, True, False]),
                           ("swap_out", 0, [True, True, False]),
                           ("swap_in", 1, [True, False, False])):
        getattr(t, op)(slot, [pool])
        [jpool], _ = getattr(j, op)(slot, [jpool])
        assert lanes() == want
        assert t.is_resident(slot) is (op == "swap_in")
    for kvm in (t, j):
        kvm.free_seq(0)
        assert kvm._alloc_dirty
        kvm.sync_allocator()
    assert lanes() == [False, False, False]
    _assert_managers_equal(t, j)


def test_mark_swap_bit_identical_to_jax():
    """``mark_swap`` (functional: the input state keeps its lane) and
    ``mark_swap_`` (in place) flip one residency lane as JAX's
    ``mark_swap`` does, on a state with a host tier."""
    from repro.core.fmmu.types import small_geometry as j_small
    from repro_torch.core.fmmu.types import small_geometry
    g, jg = small_geometry(), j_small()
    ts = TB.init_serving_state(g, 6, 4, n_host_blocks=5, device="cpu")
    js = JB.init_serving_state(jg, 6, 5, 4)
    _assert_state_equal(ts, js, "init")
    for lane, pending in ((1, True), (3, True), (1, False), (3, True)):
        before = ts.swap_pending.clone()
        ts2 = TB.mark_swap(ts, lane, pending)
        assert torch.equal(ts.swap_pending, before)
        js = JB.mark_swap(js, lane, pending)
        _assert_state_equal(ts2, js, f"lane {lane}")
        TB.mark_swap_(ts, lane, pending)
        _assert_state_equal(ts, js, f"lane {lane} in place")


def test_swap_is_one_map_call_and_check_false_reads_nothing_back(
        monkeypatch):
    """A swap is exactly one map call (``XLATE_CALLS`` += 1) and one map
    commit; with ``check=False`` no tensor is read back on the host
    (``Tensor.__bool__``/``item``/``tolist`` raise inside it), with
    ``check=True`` one guard read. ``hit_stats`` shows the tier
    activity, equal to the JAX manager's."""
    t = TKVM(n_slots=2, max_pages=4, n_device_blocks=4, n_host_blocks=4,
             device="cpu")
    j = JKVM(n_slots=2, max_pages=4, n_device_blocks=4, n_host_blocks=4)
    t.new_seq(0, 3)
    j.new_seq(0, 3)
    pool = torch.zeros((9, 2))
    jpool = jnp.zeros((9, 2))
    reads = []

    def read(self, *a):
        reads.append(self.shape)
        raise AssertionError("a swap with check=False read a tensor back")
    for check in (False, True):
        x0, c0 = TKM.XLATE_CALLS[0], TB.PROBE_CALLS[0]
        with monkeypatch.context() as mp:
            for name in ("item", "tolist"):
                mp.setattr(torch.Tensor, name, read)
            if not check:
                mp.setattr(torch.Tensor, "__bool__", read)
            assert t.swap_out(0, [pool], check=check) == 3
        assert TKM.XLATE_CALLS[0] - x0 == 1
        assert TB.PROBE_CALLS[0] - c0 == 1
        assert not reads
        [jpool], _ = j.swap_out(0, [jpool], check=check)
        st = t.hit_stats()
        assert st["swaps_out"] == 3 * (1 + check)
        assert st["host_resident_slots"] == 1
        assert t.swap_in(0, [pool], check=check) == 3
        [jpool], _ = j.swap_in(0, [jpool], check=check)
        st, jst = t.hit_stats(), j.hit_stats()
        assert st["host_resident_slots"] == 0
        for f in st.as_dict():
            assert st[f] == jst[f], f
    assert st["swaps_in"] == 6 and st["flash_programs"] == 3 + 6


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


# the reference tests' shapes (tests/test_serving.py): four 8-token
# prompts x 24 new tokens (4 pages each, 16 in all) on 10 device blocks;
# two prompts of 24 and 20 tokens on 6 device blocks, single-step
OVERSUB = dict(n_slots=4, max_ctx=64, n_device_blocks=10, n_host_blocks=24,
               macro_k=4, swap_patience=2)
OVERSUB_REQS = [(range(1 + 20 * i, 9 + 20 * i), 24) for i in range(4)]
PREEMPT = dict(n_slots=2, max_ctx=48, n_device_blocks=6, n_host_blocks=8)
PREEMPT_REQS = [(range(1, 25), 4), (range(30, 50), 4)]
METRICS = ("prefills", "decode_steps", "preemptions", "generated",
           "macro_steps", "macro_fallbacks", "swaps_out", "swaps_in")


def _lockstep(pair, reqs, **cfg):
    """Run the port's and the JAX engine round by round; after every
    round both hold the same requests in the same slots with the same
    pages, residency, context lengths, worst-case growth and counters.
    Returns (port tokens, JAX tokens, port engine, JAX engine)."""
    jm, jp, tm, tp = pair
    te = ServeEngine(tm, tp, config=ServeConfig(**cfg), device="cpu")
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
        assert te.kvm._host_pages == je.kvm._host_pages, rnd
        np.testing.assert_array_equal(te.ctx_lens, je.ctx_lens)
        for r in te.active.values():
            assert te._growth_need(r.slot) == je._growth_need(r.slot)
        assert {k: te.metrics[k] for k in METRICS} == \
            {k: je.metrics[k] for k in METRICS}, rnd
        if not more:
            break
    return ([done_t[a] for a, _ in rids], [done_j[b] for _, b in rids],
            te, je)


def _assert_engines_end_equal(te, je):
    _assert_managers_equal(te.kvm, je.kvm)
    assert te.scratch_block == je.scratch_block
    for name in ("pool_k", "pool_v"):
        assert te.caches[name].shape == je.caches[name].shape


def test_oversubscribed_macro_engine_identical_to_jax(models):
    """About 2x oversubscription under the non-blocking pipeline: every
    round stays on the K-step path (0 fallbacks), swaps go both ways,
    at least two slots rotate through the host tier, and the tokens,
    counters and final map state equal the JAX engine's."""
    got, want, te, je = _lockstep(models["llama3.2-1b"], OVERSUB_REQS,
                                  **OVERSUB)
    assert got == want
    assert te.metrics["macro_fallbacks"] == 0
    assert te.metrics["swaps_out"] > 0 and te.metrics["swaps_in"] > 0
    assert te.kvm.pool.stats.swaps_out >= 2 * 4
    _assert_engines_end_equal(te, je)
    st, jst = te.kvm.hit_stats(), je.kvm.hit_stats()
    for f in st.as_dict():
        assert st[f] == jst[f], f


def test_blocking_swap_falls_back_with_the_same_tokens(models):
    """``nonblocking_swap=False``: the same workload falls back to single
    steps (which swap their slots back in and preempt, reading the guard
    back), with the JAX engine's counters and tokens, and the tokens of
    the non-blocking run."""
    pair = models["llama3.2-1b"]
    got, want, te, je = _lockstep(pair, OVERSUB_REQS,
                                  **dict(OVERSUB, nonblocking_swap=False))
    assert got == want
    assert te.metrics["macro_fallbacks"] > 0
    nb, _, _, _ = _lockstep(pair, OVERSUB_REQS, **OVERSUB)
    assert got == nb
    _assert_engines_end_equal(te, je)


def test_preemption_single_step_identical_to_jax(models):
    """Single-step at the reference's preemption shape: admission and
    page growth run out of device blocks and preempt a victim to the
    host tier; the tokens, preemption and swap counts equal the JAX
    engine's, and the tokens equal a solo run that never swapped."""
    pair = models["llama3.2-1b"]
    got, want, te, je = _lockstep(pair, PREEMPT_REQS, **PREEMPT)
    assert got == want
    assert te.metrics["preemptions"] >= 1
    _assert_engines_end_equal(te, je)
    _, _, tm, tp = pair
    solo = ServeEngine(tm, tp, config=ServeConfig(n_slots=1, max_ctx=48),
                       device="cpu")
    rid = solo.submit(list(PREEMPT_REQS[0][0]), max_new=4)
    assert solo.run()[rid] == got[0]


def test_mamba2_engine_with_a_host_tier_identical_to_jax(models):
    """mamba2 with a host tier (the scratch block past both tiers) at
    macro_k=4: the JAX engine's tokens and map state. The pool holds
    the working set, so nothing swaps; an undersized pool would swap,
    which the port refuses for a model with mamba layers (its SSM state
    would advance while paused) and the reference cannot do (KeyError
    on ``caches["pool_k"]``)."""
    pair = models["mamba2-1.3b"]
    cfg = dict(n_slots=2, max_ctx=64, n_host_blocks=8, macro_k=4)
    reqs = [(range(1, 12), 6), (range(50, 87), 5)]
    got, want, te, je = _lockstep(pair, reqs, **cfg)
    assert got == want
    assert te.scratch_block == je.scratch_block == 2 * 8 + 8
    assert te.metrics["swaps_out"] == 0
    _assert_state_equal(te.kvm.state, je.kvm.state)
    _, _, tm, tp = pair
    small = ServeEngine(tm, tp, config=ServeConfig(**dict(OVERSUB)),
                        device="cpu")
    for t, n in OVERSUB_REQS:
        small.submit(list(t), max_new=n)
    with pytest.raises(NotImplementedError, match="mamba"):
        small.run()


def test_serve_config_accepts_the_host_tier():
    cfg = ServeConfig(n_slots=2, max_ctx=32, n_host_blocks=4,
                      nonblocking_swap=False, swap_patience=3)
    assert (cfg.n_host_blocks, cfg.nonblocking_swap, cfg.swap_patience) == \
        (4, False, 3)
    j = JServeConfig(n_slots=2, max_ctx=32)
    assert (ServeConfig(n_slots=2, max_ctx=32).nonblocking_swap,
            ServeConfig(n_slots=2, max_ctx=32).swap_patience) == \
        (j.nonblocking_swap, j.swap_patience)
