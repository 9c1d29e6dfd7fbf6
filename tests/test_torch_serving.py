"""The port's ServeEngine against the JAX ServeEngine (single-step path,
macro_k=0) on smoke_config(llama3.2-1b) in float32, with the reference's
initialisation loaded through ``convert.params_from_jax``: the emitted
greedy tokens must be identical — one request, two concurrent requests
(isolation), growth that pauses and resumes without a host tier, and
chunked admission. Also the engine's host-cost counters, its device
rule and the rejection of settings that are not ported."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
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
from repro_torch.paging.pool import OutOfBlocks  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import ServeConfig, ServeEngine  # noqa: E402

PAGE = 8


@pytest.fixture(scope="module")
def models():
    jm = j_build(j_smoke(j_get_arch("llama3.2-1b")),
                 JRuntime(compute_dtype=jnp.float32, param_dtype=jnp.float32,
                          remat="none", page_size=PAGE))
    cfg = smoke_config(get_arch("llama3.2-1b"))
    tm = build_model(cfg, Runtime(compute_dtype=torch.float32,
                                  param_dtype=torch.float32, page_size=PAGE),
                     device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, tm, tp


def _port(models, reqs, **cfg):
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, config=ServeConfig(**cfg), device="cpu")
    rids = [eng.submit(t, max_new=n) for t, n in reqs]
    done = eng.run()
    return [done[r] for r in rids], eng


def _jax(models, reqs, **cfg):
    jm, jp, _, _ = models
    eng = JServeEngine(jm, jp, config=JServeConfig(**cfg))
    rids = [eng.submit(t, max_new=n) for t, n in reqs]
    done = eng.run()
    return [done[r] for r in rids]


T1, T2 = list(range(1, 12)), list(range(50, 73))


@pytest.mark.parametrize("case", ["single", "two_isolated", "pause_resume",
                                  "chunked"])
def test_tokens_identical_to_jax_engine(models, case):
    if case == "single":
        rng = np.random.default_rng(1)
        reqs = [(list(rng.integers(0, 512, 21)), 6)]
        cfg = dict(n_slots=2, max_ctx=64)
    elif case == "two_isolated":
        reqs = [(T1, 4), (T2, 4)]
        cfg = dict(n_slots=2, max_ctx=64)
    elif case == "pause_resume":
        # pool of 3 pages: both prompts take 1 page; at ctx 8 both want
        # a second page -> one grows, the other pauses until r1 frees
        reqs = [(list(range(1, 9)), 6), (list(range(30, 38)), 12)]
        cfg = dict(n_slots=2, max_ctx=64, n_device_blocks=3)
    else:
        reqs = [(T2, 5), (T1, 5)]
        cfg = dict(n_slots=2, max_ctx=64, admit_tokens=8)
    got, eng = _port(models, reqs, **cfg)
    assert got == _jax(models, reqs, **cfg)
    assert [len(g) for g in got] == [n for _, n in reqs]
    if case in ("two_isolated", "pause_resume"):
        # each request equals its uncontended solo run
        for (t, n), g in zip(reqs, got):
            assert _port(models, [(t, n)], n_slots=1, max_ctx=64)[0] == [g]
    if case == "chunked":
        assert eng.metrics["chunked_prefills"] >= 1


def test_growth_livelock_raises_out_of_blocks(models):
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, config=ServeConfig(
        n_slots=1, max_ctx=64, n_device_blocks=2), device="cpu")
    eng.submit(list(range(1, 9)), max_new=40)   # needs 6 pages, pool=2
    with pytest.raises(OutOfBlocks):
        eng.run()


def test_steady_decode_one_host_sync_at_most_one_map_call(models):
    """A steady decode step: exactly one host sync (the next-token
    readback), zero full-map retranslations, one fused map call on a
    page-boundary step and none otherwise; CPU tensors launch no
    kernel."""
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, config=ServeConfig(n_slots=2, max_ctx=64),
                      device="cpu")
    eng.submit(list(range(1, 9)), max_new=40)
    eng.submit(list(range(20, 28)), max_new=40)
    done: dict = {}
    eng.step(done)
    launches0 = COUNTERS.launches()
    boundary_seen = False
    for _ in range(12):
        s0, x0, f0 = (TE.HOST_SYNCS[0], TKM.XLATE_CALLS[0],
                      TKM.FULL_TABLE_CALLS[0])
        pre = {r.slot: len(eng.kvm.seq_pages[r.slot])
               for r in eng.active.values()}
        eng.step(done)
        grew = any(len(eng.kvm.seq_pages.get(s, [])) != n
                   for s, n in pre.items())
        assert TE.HOST_SYNCS[0] - s0 == 1
        assert TKM.FULL_TABLE_CALLS[0] - f0 == 0
        assert TKM.XLATE_CALLS[0] - x0 == (1 if grew else 0)
        boundary_seen |= grew
    assert boundary_seen
    assert COUNTERS.launches() == launches0
    np.testing.assert_array_equal(eng.kvm.block_tables().numpy(),
                                  eng.kvm.retranslate_tables().numpy())


def test_entry_points_default_to_cuda_and_raise_without_it(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is valid here")
    from repro_torch.paging.kv_manager import KVPageManager
    _, _, tm, tp = models
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(tm, tp, config=ServeConfig(n_slots=1, max_ctx=16))
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(tm.cfg, tm.rt)
    with pytest.raises(RuntimeError, match="cuda"):
        KVPageManager(1, 4, 4)


@pytest.mark.parametrize("kw", [
    dict(use_mesh=True), dict(gc=object()),
    dict(prefix=object()), dict(journal_path="j.log", gc=object())])
def test_serve_config_rejects_unported_features(kw):
    """The mesh, GC and prefix sharing raise; journaling is ported, but
    not beside a GC plane."""
    with pytest.raises(NotImplementedError):
        ServeConfig(n_slots=2, max_ctx=32, **kw)


def test_serve_config_accepts_swap_settings():
    cfg = ServeConfig(n_slots=2, max_ctx=32, n_host_blocks=4,
                      nonblocking_swap=False, swap_patience=2)
    assert (cfg.nonblocking_swap, cfg.swap_patience) == (False, 2)


def test_engine_rejects_fault_plane(models):
    """The fault plane is ported: the engine takes a ``FaultPlane`` and
    rejects anything else."""
    from repro_torch.core.faults import FaultPlane, make_plan
    _, _, tm, tp = models
    with pytest.raises(TypeError):
        ServeEngine(tm, tp, config=ServeConfig(n_slots=1, max_ctx=16),
                    device="cpu", fault_plane=object())
    plane = FaultPlane(make_plan(0))
    eng = ServeEngine(tm, tp, config=ServeConfig(n_slots=1, max_ctx=16),
                      device="cpu", fault_plane=plane)
    assert eng.faults is plane and eng.kvm.faults is plane
