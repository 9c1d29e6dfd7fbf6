"""The port's K-step macro decode path against the JAX engine's
(``macro_k=4``) on smoke_config in float32, with the reference's
initialisation loaded through ``convert.params_from_jax``. In each case
the greedy tokens equal the JAX macro engine's and the port's own
single-step tokens, every ``ServingMapState`` tensor is bit-identical
to the JAX engine's after the run, and after ``sync_allocator`` the
device free stack equals the host pool's free list. The cases: growth
that crosses a page boundary inside a run (simple variant), a budget
that retires a slot mid-run (full variant), EOS retirement, a dry pool
that falls back to single steps, chunked admission through forced
lanes, and a mamba2 model. Also the steady-state host-cost counters:
one dispatch and one host sync per K tokens, no host-side map call, no
full-table retranslation, no allocator re-sync."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.core.fmmu import batch as JB  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import Runtime as JRuntime  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving.config import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.counters import COUNTERS  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.paging import kv_manager as TKM  # noqa: E402
from repro_torch.serving import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import macro as TM  # noqa: E402

PAGE = 8
K = 4


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


# the JAX engine's compiled programs and what their traces read of it
_PROGRAMS = ("_decode", "_prefill", "_macro", "_macro_simple")


def _program_key(eng):
    return (id(eng.m), eng.page, eng.n_slots, eng.max_pages,
            eng.scratch_block, eng.macro_k, eng.eos_id, eng.channels,
            eng.kvm.geom)


@pytest.fixture(scope="module", autouse=True)
def shared_jax_programs():
    """Every JAX engine and page manager jits its own programs, so each
    case paid for tracing and compiling them again. Here engines of one
    configuration share one set: a page manager's jitted map commits are
    a function of its geometry alone (``make_jitted``), and an engine's
    decode, prefill and K-step programs read only the model and the
    configuration in ``_program_key`` when they are traced."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JB, "make_jitted",
               functools.lru_cache(maxsize=None)(JB.make_jitted))
    shared = {}
    init = JServeEngine.__init__

    def shared_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        programs = shared.setdefault(_program_key(self), {})
        for name in _PROGRAMS:
            if name in programs:
                setattr(self, name, programs[name])
            else:
                programs[name] = getattr(self, name)
    mp.setattr(JServeEngine, "__init__", shared_init)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def models():
    return {"llama3.2-1b": _pair("llama3.2-1b"),
            "mamba2-1.3b": _pair("mamba2-1.3b")}


def _run_port(pair, reqs, **cfg):
    _, _, tm, tp = pair
    eng = ServeEngine(tm, tp, config=ServeConfig(**cfg), device="cpu")
    rids = [eng.submit(list(t), max_new=n) for t, n in reqs]
    done = eng.run()
    return [done[r] for r in rids], eng


def _run_jax(pair, reqs, **cfg):
    jm, jp, _, _ = pair
    eng = JServeEngine(jm, jp, config=JServeConfig(**cfg))
    rids = [eng.submit(list(t), max_new=n) for t, n in reqs]
    done = eng.run()
    return [done[r] for r in rids], eng


def _assert_map_equal(t_state, j_state):
    for name in t_state._fields:
        tv, jv = getattr(t_state, name), getattr(j_state, name)
        if name == "fmmu":
            _assert_map_equal(tv, jv)
        elif tv is None or jv is None:
            assert tv is None and jv is None, name
        else:
            jn = np.asarray(jv)
            assert tv.numpy().dtype == jn.dtype, name
            np.testing.assert_array_equal(tv.numpy(), jn, err_msg=name)


def _eos_case(pair):
    """Requests and an eos_id that the second request emits at its
    third token or later (and not before), found from a single-step run
    without EOS: the slot retires mid-run."""
    reqs = [(range(1, 8), 9), (range(50, 73), 9)]
    out, _ = _run_port(pair, reqs, n_slots=2, max_ctx=64)
    seq = out[1]
    eos = next(t for i, t in enumerate(seq) if i >= 2 and t not in seq[:i]
               and t not in out[0][:i + 1])
    return reqs, dict(eos_id=int(eos))


CASES = {
    # 7-token prompts, page 8: each slot's second page is popped and
    # committed at step 1 of the first run; budgets of 1 + 2K keep every
    # run in the simple variant
    "crossing_simple": ("llama3.2-1b",
                        [(range(1, 8), 1 + 2 * K), (range(20, 27), 1 + 2 * K)],
                        dict()),
    # the 23-token request has 2 tokens of budget left in its second
    # run and retires at step 1 of a full-variant run
    "budget_full": ("llama3.2-1b", [(range(50, 73), 7), (range(1, 8), 12)],
                    dict()),
    "eos": ("llama3.2-1b", None, None),
    # 3 blocks: both prompts take 1; the worst-case K-step growth does
    # not fit, so rounds fall back to single steps (which pause a slot)
    "dry_pool": ("llama3.2-1b", [(range(1, 9), 6), (range(30, 38), 12)],
                 dict(n_device_blocks=3)),
    # admit_tokens=8: the 23-token prompt is prefilled 8 tokens at a time
    # and its remainder streams through the runs as forced lanes
    "chunked": ("llama3.2-1b", [(range(50, 73), 5), (range(1, 12), 5)],
                dict(admit_tokens=8)),
    "mamba2": ("mamba2-1.3b", [(range(1, 12), 6), (range(50, 87), 5)],
               dict()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_macro_engine_identical_to_jax(models, case, monkeypatch):
    arch, reqs, extra = CASES[case]
    pair = models[arch]
    if case == "eos":
        reqs, extra = _eos_case(pair)
    cfg = dict(n_slots=2, max_ctx=64, **extra)
    variants = []          # (simple, forced) of every K-step run
    run_eager = TM.run_eager

    def spy(eng, buf, simple, forced, pages):
        variants.append((simple, forced))
        return run_eager(eng, buf, simple, forced, pages)
    monkeypatch.setattr(TM, "run_eager", spy)
    got, te = _run_port(pair, reqs, macro_k=K, **cfg)
    assert len(variants) == te.metrics["macro_steps"]
    want, je = _run_jax(pair, reqs, macro_k=K, **cfg)
    assert got == want
    single, _ = _run_port(pair, reqs, **cfg)
    assert got == single
    assert te.metrics["macro_steps"] == je.metrics["macro_steps"] > 0
    assert te.metrics["macro_fallbacks"] == je.metrics["macro_fallbacks"]
    assert te.metrics["decode_steps"] == je.metrics["decode_steps"]
    _assert_map_equal(te.kvm.state, je.kvm.state)
    assert te.kvm.seq_pages == {s: list(map(int, p))
                                for s, p in je.kvm.seq_pages.items()}
    assert te.kvm.pool._free_dev == je.kvm.pool._free_dev
    te.kvm.sync_allocator()
    st = te.kvm.state
    assert int(st.free_n) == te.kvm.pool.free_device
    np.testing.assert_array_equal(st.free_stack[:int(st.free_n)].numpy(),
                                  np.asarray(te.kvm.pool._free_dev, np.int32))
    assert not bool(st.oob)
    assert (te.metrics["macro_fallbacks"] > 0) == (case == "dry_pool")
    if case == "crossing_simple":
        assert all(simple for simple, _ in variants)
    if case == "budget_full":
        assert [len(g) for g in got] == [7, 12]
        assert not all(simple for simple, _ in variants)
    if case == "eos":
        assert got[1][-1] == extra["eos_id"] and len(got[1]) < reqs[1][1]
        assert not any(simple for simple, _ in variants)
    if case == "chunked":
        assert te.metrics["chunked_prefills"] >= 1
        assert any(forced for _, forced in variants)


def test_steady_state_one_dispatch_one_sync_per_k_tokens(models):
    """Steady macro decode: per round exactly one dispatch and one host
    sync for K tokens a slot, no host-side map call, no full-table
    retranslation, no allocator re-sync, no graph capture and (CPU
    tensors) no kernel launch; the device allocator stays the host
    pool's mirror."""
    k = 8
    eng = ServeEngine(models["llama3.2-1b"][2], models["llama3.2-1b"][3],
                      config=ServeConfig(n_slots=2, max_ctx=256, macro_k=k),
                      device="cpu")
    eng.min_page_bucket = 32
    r1 = eng.submit(list(range(1, 9)), max_new=10 ** 6)
    r2 = eng.submit(list(range(20, 28)), max_new=10 ** 6)
    done: dict = {}
    for _ in range(2):                 # admission + prefill, first runs
        eng.step(done)
    launches0 = COUNTERS.launches()
    grew = False
    for _ in range(6):
        before = COUNTERS.snapshot()
        pages = {s: len(p) for s, p in eng.kvm.seq_pages.items()}
        outs = {r.rid: len(r.out) for r in eng.active.values()}
        eng.step(done)
        d = COUNTERS.delta(before)
        assert d["engine.macro_dispatches"] == 1
        assert d["engine.host_syncs"] == 1
        assert d["kvm.xlate_calls"] == 0
        assert d["kvm.full_table_calls"] == 0
        assert d["kvm.alloc_syncs"] == 0
        assert d["engine.macro_captures"] == 0
        # the K commits of a run are counted as executed: one probe
        # and one insert pass per step, page boundary or not
        assert d["fmmu.probe_calls"] == d["fmmu.insert_calls"] == k
        assert all(len(eng.active[r].out) - n == k for r, n in outs.items())
        grew |= any(len(eng.kvm.seq_pages[s]) != n for s, n in pages.items())
    assert grew
    assert eng.metrics["macro_fallbacks"] == 0
    assert COUNTERS.launches() == launches0
    assert {r1, r2} == set(eng.active)
    np.testing.assert_array_equal(eng.kvm.block_tables().numpy(),
                                  eng.kvm.retranslate_tables().numpy())
    st = eng.kvm.state
    np.testing.assert_array_equal(st.free_stack[:int(st.free_n)].numpy(),
                                  np.asarray(eng.kvm.pool._free_dev, np.int32))
    assert TE.MACRO_DISPATCHES is COUNTERS.cell("engine.macro_dispatches")
    assert TKM.ALLOC_SYNCS is COUNTERS.cell("kvm.alloc_syncs")
    assert TM.MACRO_CAPTURES is COUNTERS.cell("engine.macro_captures")


def test_pack_inputs_round_trip():
    """The packed input vector unpacks into the program's inputs: [S]
    lanes, the simple schedule or n_pages, and the forced triple."""
    k, s = 3, 5
    rng = np.random.default_rng(0)
    lanes = dict(tokens=rng.integers(0, 99, s), ctx=rng.integers(0, 99, s),
                 alive=rng.random(s) < .5, budget=rng.integers(0, 9, s),
                 npages=rng.integers(0, 9, s),
                 grow=rng.random((k, s)) < .5, dl=rng.integers(0, 99, (k, s)),
                 fmask=rng.random((k, s)) < .5,
                 ftok=rng.integers(0, 99, (k, s)),
                 emit=rng.random((k, s)) < .5)
    buf = torch.from_numpy(TM.pack_inputs(k, s, **lanes))
    for simple in (False, True):
        for forced in (False, True):
            tok, ctx, n_pages, alive, budget, fc = TM.unpack_inputs(
                buf, k, s, simple, forced)
            for got, name in ((tok, "tokens"), (ctx, "ctx"),
                              (alive, "alive"), (budget, "budget")):
                np.testing.assert_array_equal(got.numpy(), lanes[name])
            if simple:
                np.testing.assert_array_equal(n_pages[0].numpy(),
                                              lanes["grow"])
                np.testing.assert_array_equal(n_pages[1].numpy(),
                                              lanes["dl"])
            else:
                np.testing.assert_array_equal(n_pages.numpy(),
                                              lanes["npages"])
            if forced:
                for got, name in zip(fc, ("fmask", "ftok", "emit")):
                    np.testing.assert_array_equal(got.numpy(), lanes[name])
            else:
                assert fc is None
    assert alive.dtype == torch.bool and tok.dtype == torch.int32


def test_macro_page_buckets_follow_single_steps(models, monkeypatch):
    """Each step of a K-step run cuts its tables to the page bucket a
    single step would use there (on the card paged attention's split
    plan, and so its rounding, follows the table's width): the 30-token
    prompt (page 8) passes 32 tokens, bucket 4 -> 8, at step 2 of its
    first run, and the last runs retire lanes mid-run (full variant)."""
    _, _, tm, tp = models["llama3.2-1b"]
    reqs = [(range(1, 31), 9), (range(40, 45), 14)]
    used, runs = {}, []
    run_eager = TM.run_eager

    def spy(eng, buf, simple, forced, pages):
        runs.append((simple, pages))
        return run_eager(eng, buf, simple, forced, pages)
    monkeypatch.setattr(TM, "run_eager", spy)
    for macro_k in (K, 0):
        eng = ServeEngine(tm, tp, config=ServeConfig(
            n_slots=2, max_ctx=64, macro_k=macro_k), device="cpu")
        used[macro_k] = []
        decode = eng.decode_fn

        def record(*args, _used=used[macro_k], _decode=decode):
            _used.append(args[-1])
            return _decode(*args)
        eng.decode_fn = record
        for t, n in reqs:
            eng.submit(list(t), max_new=n)
        eng.run()
    assert runs[0] == (True, (4, 4, 8, 8))
    assert {simple for simple, _ in runs} == {True, False}
    n = len(used[0])                  # idle steps end the last run only
    assert used[K][:n] == used[0] and len(used[K]) - n < K
