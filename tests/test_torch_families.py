"""The port's other dense decoders against the JAX model and engine:
gemma2-9b (local/global layers with a sliding window, attention and
final softcaps, pre and post norms, GeGLU with tanh gelu, the sqrt(d)
embedding scale, tied embeddings), glm4-9b (GQA 16, QKV bias) and
qwen2-72b (GQA 8, QKV bias, untied head). At each ``smoke_config`` in
float32, with the reference's initialisation loaded through
``convert.params_from_jax``: the configs field by field (full and
smoke), the init layout, ``prefill`` and ``decode_step`` logits and KV
within 2e-5, and ``ServeEngine`` greedy tokens identical to the JAX
engine's, single-step and ``macro_k=4``. One JAX model per arch serves
the module (its jitted prefill and decode are traced once a shape), and
its engines share their compiled programs (``shared_jax_programs``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_pairs import pair, share_jax_programs  # noqa: E402
from _torch_pairs import shapes as _shapes  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving.config import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.core.counters import COUNTERS  # noqa: E402
from repro_torch.serving import ServeConfig, ServeEngine  # noqa: E402

TOL = 2e-5
ARCHS = ("gemma2-9b", "glm4-9b", "qwen2-72b")
FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "d_ff", "vocab_size", "qkv_bias", "use_rope",
          "rope_theta", "attn_softcap", "final_softcap", "sliding_window",
          "layer_pattern", "tie_embeddings", "norm_eps", "post_norms", "act",
          "period", "source")


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


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for full in (True, False):
        jc, tc = j_get_arch(arch), get_arch(arch)
        if not full:
            jc, tc = j_smoke(jc), smoke_config(tc)
        for f in FIELDS:
            assert getattr(tc, f) == getattr(jc, f), f
        assert tc.moe is None and jc.moe is None
        for i in range(tc.n_layers):
            assert tc.layer_kind(i) == jc.layer_kind(i) == "attn"
            assert tc.attn_kind(i) == jc.attn_kind(i)
            assert tc.is_moe_layer(i) is jc.is_moe_layer(i) is False


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_layout(pairs, arch):
    jm, jp, tm, *_ = pairs(arch)
    mine = tm.init(torch.Generator().manual_seed(0))
    assert _shapes(mine) == _shapes(jp)
    assert ("post2" in mine["stack"][0]) is tm.cfg.post_norms
    assert ("bq" in mine["stack"][0]["mixer"]) is tm.cfg.qkv_bias


# gemma2's smoke window is 16 tokens: 37 reaches past it on local layers
@pytest.mark.parametrize("seq", [1, 37])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_kv_match_jax(pairs, arch, seq):
    jm, jp, tm, tp, jprefill, _ = pairs(arch)
    toks = np.random.default_rng(seq).integers(0, 512, (2, seq))
    jlog, jcols = jprefill(jp, {"tokens": jnp.asarray(toks)})
    tlog, tcols = tm.prefill(tp, torch.from_numpy(toks))
    _close(tlog, jlog)
    assert len(tcols) == len(jcols) == tm.cfg.period
    for tc, jc in zip(tcols, jcols):
        for tkv, jkv in zip(tc["kv"], jc["kv"]):
            _close(tkv, jkv)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_and_pools_match_jax(pairs, arch):
    """Contexts inside and past gemma2's 16-token window."""
    jm, jp, tm, tp, _, jdecode = pairs(arch)
    rng = np.random.default_rng(5)
    b, maxp, nb = 3, 6, 24
    jcaches = jtr.init_decode_caches(jm.cfg, jm.rt, b, maxp, nb,
                                     jnp.float32)
    pools = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in jcaches.items()}
    table = rng.permutation(nb)[:b * maxp].reshape(b, maxp).astype(np.int32)
    ctx = np.asarray([3, 17, 44], np.int32)
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
REQS = [(list(range(1, 12)), 6), (list(range(50, 73)), 9),
        (list(range(200, 219)), 4)]


@pytest.mark.parametrize("macro_k", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_identical_to_jax(pairs, arch, macro_k):
    """Three requests on two slots (the third waits for a free slot),
    the 23-token prompt past gemma2's window: the same greedy tokens as
    the JAX engine in the same mode, and no kernel launch on the CPU."""
    jm, jp, tm, tp, *_ = pairs(arch)
    cfg = dict(n_slots=2, max_ctx=64, macro_k=macro_k)
    te = ServeEngine(tm, tp, config=ServeConfig(**cfg), device="cpu")
    je = JServeEngine(jm, jp, config=JServeConfig(**cfg))
    rids = [(te.submit(t, max_new=n), je.submit(t, max_new=n))
            for t, n in REQS]
    launches0 = COUNTERS.launches()
    tdone, jdone = te.run(), je.run()
    got = [tdone[t] for t, _ in rids]
    assert got == [jdone[j] for _, j in rids]
    assert [len(g) for g in got] == [n for _, n in REQS]
    assert COUNTERS.launches() == launches0
    assert (te.metrics["macro_steps"] > 0) is (macro_k > 0)
    assert te.metrics["macro_steps"] == je.metrics["macro_steps"]
