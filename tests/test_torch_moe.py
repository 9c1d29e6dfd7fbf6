"""The port's MoE layer and MoE decoders (dbrx-132b: 16 experts top-4;
arctic-480b: 128 experts top-2 with a dense residual MLP) against the
JAX reference, at each ``smoke_config`` (4 experts, top-k <= 2, d_ff 64)
in float32 with the reference's initialisation loaded through
``convert.params_from_jax``: the configs (MoE fields, ``period``,
``is_moe_layer``), the init layout with its float32 router,
``apply_moe``'s (out, aux) against the JAX ``apply_moe`` on one CPU
device at the default capacity (where slots are dropped: the same slots)
and dropless, the dropless layer against ``apply_moe_dense_ref``,
``prefill`` and ``decode_step`` logits within 2e-5, and ``ServeEngine``
greedy tokens identical to the JAX engine's, single-step and
``macro_k=4``, at the default capacity with slots dropped at decode."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_pairs import pair, share_jax_programs  # noqa: E402
from repro.configs import ArchConfig as JArchConfig  # noqa: E402
from repro.configs import MoEConfig as JMoEConfig  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import Runtime as JRuntime  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.parallel.sharding import trivial_ctx  # noqa: E402
from repro.serving.config import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import ArchConfig, MoEConfig  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.counters import COUNTERS  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving import ServeConfig, ServeEngine  # noqa: E402

TOL = 2e-5
ARCHS = ("dbrx-132b", "arctic-480b")
FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "d_ff", "vocab_size", "qkv_bias", "rope_theta",
          "tie_embeddings", "norm_eps", "act", "period", "source")
MOE_FIELDS = ("n_experts", "top_k", "d_ff", "every", "moe_offset",
              "dense_residual", "capacity_factor", "router_aux_weight")


@pytest.fixture(scope="module", autouse=True)
def shared_jax_programs():
    """JAX engines of one model and configuration share one set of
    compiled programs (``_torch_pairs.share_jax_programs``)."""
    mp = share_jax_programs()
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pairs():
    return pair


def _shapes(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict/list of arrays."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _shapes(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _shapes(v, f"{path}/{i}").items()}
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=TOL,
                               rtol=TOL)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for full in (True, False):
        jc, tc = j_get_arch(arch), get_arch(arch)
        if not full:
            jc, tc = j_smoke(jc), smoke_config(tc)
        for f in FIELDS:
            assert getattr(tc, f) == getattr(jc, f), f
        for f in MOE_FIELDS:
            assert getattr(tc.moe, f) == getattr(jc.moe, f), f
        assert [tc.is_moe_layer(i) for i in range(tc.n_layers)] == \
            [jc.is_moe_layer(i) for i in range(jc.n_layers)]
        assert [tc.layer_kind(i) for i in range(tc.n_layers)] == \
            [jc.layer_kind(i) for i in range(jc.n_layers)]


@pytest.mark.parametrize("every,offset,pattern", [
    (2, 1, ()), (2, 0, ("local", "global", "local")), (3, 2, ("a", "b"))])
def test_period_and_moe_layers_follow_reference(every, offset, pattern):
    """MoE every other (or third) layer: the period is the lcm with the
    attention pattern, and the MoE layers are the reference's."""
    kw = dict(name="x", family="moe", n_layers=12, d_model=8, n_heads=2,
              n_kv_heads=2, d_ff=8, vocab_size=8, layer_pattern=pattern)
    tc = ArchConfig(moe=MoEConfig(4, 2, 8, every=every, moe_offset=offset),
                    **kw)
    jc = JArchConfig(moe=JMoEConfig(4, 2, 8, every=every,
                                    moe_offset=offset), **kw)
    assert tc.period == jc.period
    assert [tc.is_moe_layer(i) for i in range(12)] == \
        [jc.is_moe_layer(i) for i in range(12)]
    assert j_smoke(jc).n_layers == smoke_config(tc).n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_and_float32_router(arch):
    """Under bf16 parameters both inits keep the router in float32, and
    params_from_jax carries the reference's leaves across unchanged; the
    dense residual MLP sits beside the experts on arctic alone."""
    jcfg, cfg = j_smoke(j_get_arch(arch)), smoke_config(get_arch(arch))
    jm = j_build(jcfg, JRuntime(param_dtype=jnp.bfloat16, remat="none"))
    tm = build_model(cfg, Runtime(param_dtype=torch.bfloat16), device="cpu")
    jp = jm.init(jax.random.key(0))
    want = _shapes(jax.tree.map(np.asarray, jp))
    mine = tm.init(torch.Generator().manual_seed(0))
    assert _shapes(mine) == want
    ffn = mine["stack"][0]["ffn"]
    assert ffn["moe"]["router"].dtype == torch.float32
    assert ffn["moe"]["wg"].dtype == torch.bfloat16
    assert ("dense" in ffn) is cfg.moe.dense_residual
    conv = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert _shapes(conv) == want
    np.testing.assert_array_equal(
        conv["stack"][0]["ffn"]["moe"]["router"].numpy(),
        np.asarray(jp["stack"][0]["ffn"]["moe"]["router"]))


def test_convert_rejects_bad_moe_leaves(pairs):
    jm, jp, tm, *_ = pairs("dbrx-132b")
    cfg = tm.cfg
    good = jax.tree.map(np.asarray, jp)
    for leaf, bad in (("wg", lambda a: a[:, :-1]),
                      ("router", lambda a: a.astype(jnp.bfloat16))):
        tree = jax.tree.map(lambda a: a, good)
        tree["stack"][0]["ffn"]["moe"][leaf] = bad(
            good["stack"][0]["ffn"]["moe"][leaf])
        with pytest.raises(ValueError, match=leaf if leaf == "router"
                           else "MoE leaves"):
            params_from_jax(tree, cfg, "cpu")


# ---------------------------------------------------------- the layer
def _layer(pairs, arch):
    """(JAX and port layer params, dense residual params or None, both
    configs and runtimes) of the first layer's FFN."""
    jm, jp, tm, tp, *_ = pairs(arch)
    jffn = jax.tree.map(lambda t: t[0], jp["stack"][0]["ffn"])
    tffn = ttr.layer_params(tp["stack"], 0, 0)["ffn"]
    return jm, jffn, tm, tffn


def _inputs(d, seed=3):
    """[2, 24, d] tokens sharing one direction, so the router favours
    some experts and the default capacity drops slots."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 24, d))
            + 1.5 * rng.standard_normal(d)).astype(np.float32)


def _jax_keep(jffn, x, cfg, capacity):
    """Which of the T*k slots (token-major) the reference keeps: its
    gates and top-k in JAX, then its stable order by expert and capacity
    cut in numpy."""
    m = cfg.moe
    x2 = jnp.asarray(x.reshape(-1, x.shape[-1]))
    gates = jax.nn.softmax(x2 @ jffn["moe"]["router"], axis=-1)
    flat_e = np.asarray(jax.lax.top_k(gates, m.top_k)[1]).reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    sle = flat_e[order]
    offsets = np.cumsum(np.bincount(sle, minlength=m.n_experts))
    pos = np.arange(len(sle)) - (offsets - np.bincount(
        sle, minlength=m.n_experts))[sle]
    keep = np.zeros(len(sle), bool)
    keep[order] = pos < capacity
    return keep


@pytest.mark.parametrize("factor", [None, 100.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(pairs, arch, factor):
    jm, jffn, tm, tffn = _layer(pairs, arch)
    cfg = tm.cfg
    x = _inputs(cfg.d_model)
    jrt = dataclasses.replace(jm.rt, capacity_factor=factor)
    rt = dataclasses.replace(tm.rt, capacity_factor=factor)
    jout, jaux = jax.jit(lambda p, xx, dp: jmoe.apply_moe(
        p, xx, jm.cfg, jrt, trivial_ctx(), dense_params=dp))(
            jffn["moe"], jnp.asarray(x), jffn.get("dense"))
    tout, taux = tmoe.apply_moe(tffn["moe"], torch.from_numpy(x), cfg, rt,
                                dense_params=tffn.get("dense"))
    _close(tout, jout)
    _close(taux, jaux)
    t = x.shape[0] * x.shape[1]
    cap = tmoe._capacity(t, cfg.moe.n_experts, cfg.moe.top_k,
                         factor or cfg.moe.capacity_factor)
    dsp = tmoe.route(torch.from_numpy(x.reshape(t, -1)),
                     tffn["moe"]["router"], cfg.moe.top_k, cap)
    keep = torch.zeros(t * cfg.moe.top_k, dtype=torch.bool)
    keep[dsp.order] = dsp.keep
    np.testing.assert_array_equal(keep.numpy(),
                                  _jax_keep(jffn, x, cfg, cap))
    dropped = int((~dsp.keep).sum())
    if factor is None:
        assert 0 < dropped < t * cfg.moe.top_k
    else:
        assert dropped == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_dropless_apply_moe_equals_dense_reference(pairs, arch):
    """At capacity_factor=100 nothing is dropped: the sort-based layer
    equals the O(T*E) dense oracle, the port's and the reference's."""
    jm, jffn, tm, tffn = _layer(pairs, arch)
    cfg = tm.cfg
    x = _inputs(cfg.d_model, seed=4)
    rt = dataclasses.replace(tm.rt, capacity_factor=100.0)
    tout, _ = tmoe.apply_moe(tffn["moe"], torch.from_numpy(x), cfg, rt,
                             dense_params=tffn.get("dense"))
    tref = tmoe.apply_moe_dense_ref(tffn["moe"], torch.from_numpy(x), cfg,
                                    rt)
    jref = jmoe.apply_moe_dense_ref(jffn["moe"], jnp.asarray(x), jm.cfg,
                                    jm.rt)
    _close(tref, jref)
    if "dense" in tffn:                        # arctic: the residual MLP
        from repro_torch.models import mlp
        tref = tref + mlp.apply_mlp(tffn["dense"], torch.from_numpy(x), cfg,
                                    rt)
    _close(tout, tref.detach().numpy())


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("seq", [1, 37])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_kv_match_jax(pairs, arch, seq):
    jm, jp, tm, tp, jprefill, _ = pairs(arch)
    toks = np.random.default_rng(seq).integers(0, 512, (2, seq))
    jlog, jcols = jprefill(jp, {"tokens": jnp.asarray(toks)})
    tlog, tcols = tm.prefill(tp, torch.from_numpy(toks))
    _close(tlog, jlog)
    for tc, jc in zip(tcols, jcols):
        for tkv, jkv in zip(tc["kv"], jc["kv"]):
            _close(tkv, jkv)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_and_pools_match_jax(pairs, arch):
    """Six lanes: the decode capacity is 4 slots an expert for 12."""
    jm, jp, tm, tp, _, jdecode = pairs(arch)
    rng = np.random.default_rng(5)
    b, maxp, nb = 6, 4, 32
    jcaches = jtr.init_decode_caches(jm.cfg, jm.rt, b, maxp, nb,
                                     jnp.float32)
    pools = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in jcaches.items()}
    table = rng.permutation(nb)[:b * maxp].reshape(b, maxp).astype(np.int32)
    ctx = np.asarray([3, 17, 30, 1, 9, 22], np.int32)
    toks = rng.integers(0, 512, (b,)).astype(np.int32)
    jlog, jnew = jdecode(jp, jnp.asarray(toks),
                         {k: jnp.asarray(v) for k, v in pools.items()},
                         ctx_lens=jnp.asarray(ctx),
                         block_table=jnp.asarray(table))
    tlog, tnew = tm.decode_step(
        tp, torch.from_numpy(toks),
        {k: torch.from_numpy(v.copy()) for k, v in pools.items()},
        ctx_lens=torch.from_numpy(ctx), block_table=torch.from_numpy(table))
    _close(tlog, jlog)
    for k in pools:
        _close(tnew[k], jnew[k])


# -------------------------------------------------------------- engine
# two prompt lengths (each length is one more JAX prefill to compile);
# at dbrx's smoke size these requests drop different slots in the two
# modes (test_modes_differ_only_through_capacity_drops)
REQS = [(list(range(a, a + n)), m) for a, n, m in (
    (305, 23, 6), (147, 9, 3), (7, 9, 4), (311, 23, 9), (291, 23, 9),
    (303, 23, 6), (448, 23, 4))]


@pytest.fixture(scope="module")
def served(pairs):
    """run(arch, macro_k, factor=None) -> {"port": tokens, "jax": tokens
    (None unless factor is None), "drops": slots the port's router
    dropped, "launches": whether the port's run launched a kernel, the
    engines' "macro_steps"}: REQS through both engines, once each."""
    @functools.lru_cache(maxsize=None)
    def run(arch, macro_k, factor=None):
        jm, jp, tm, tp, *_ = pairs(arch)
        if factor is not None:
            tm = dataclasses.replace(tm, rt=dataclasses.replace(
                tm.rt, capacity_factor=factor))
        drops = []
        route = tmoe.route

        def spy(x, router, top_k, capacity):
            dsp = route(x, router, top_k, capacity)
            drops.append(int((~dsp.keep).sum()))
            return dsp
        cfg = dict(n_slots=6, max_ctx=64, macro_k=macro_k)
        te = ServeEngine(tm, tp, config=ServeConfig(**cfg), device="cpu")
        rids = [te.submit(t, max_new=n) for t, n in REQS]
        launches0 = COUNTERS.launches()
        tmoe.route = spy
        try:
            done = te.run()
        finally:
            tmoe.route = route
        out = {"port": [done[r] for r in rids], "drops": sum(drops),
               "launches": COUNTERS.launches() != launches0,
               "macro_steps": [te.metrics["macro_steps"]], "jax": None}
        if factor is None:
            je = JServeEngine(jm, jp, config=JServeConfig(**cfg))
            jrids = [je.submit(t, max_new=n) for t, n in REQS]
            jdone = je.run()
            out["jax"] = [jdone[r] for r in jrids]
            out["macro_steps"].append(je.metrics["macro_steps"])
        return out
    return run


@pytest.mark.parametrize("macro_k", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_identical_to_jax(served, arch, macro_k):
    """Seven requests on six slots at the default capacity (4 slots an
    expert at decode, for 12): lanes finish at different steps and the
    seventh waits for a slot, so the dead and live lanes route together
    and slots are dropped. The port gives the JAX engine's greedy tokens
    in the same mode, with no kernel launch on the CPU."""
    r = served(arch, macro_k)
    assert r["port"] == r["jax"]
    assert [len(g) for g in r["port"]] == [n for _, n in REQS]
    assert not r["launches"]
    steps_port, steps_jax = r["macro_steps"]
    assert steps_port == steps_jax and (steps_port > 0) is (macro_k > 0)
    assert r["drops"] > 0


def test_modes_differ_only_through_capacity_drops(served):
    """Static capacity couples the lanes: every lane goes through the
    router, finished and waiting ones too. A lane that finishes inside a
    K-step run keeps decoding to the boundary, where a single step feeds
    it token 0, so the two modes route different slots and drop
    different ones. At dbrx's smoke size the single-step and K-step
    tokens differ at the default capacity, in the JAX engines as in the
    port's (each mode equal across the packages), and agree dropless."""
    single, macro = served("dbrx-132b", 0), served("dbrx-132b", 4)
    assert single["jax"] != macro["jax"]
    assert single["port"] != macro["port"]
    assert served("dbrx-132b", 0, 100.0)["drops"] == 0
    assert served("dbrx-132b", 0, 100.0)["port"] == \
        served("dbrx-132b", 4, 100.0)["port"]
