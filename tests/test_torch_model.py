"""The port's dense decoder against the JAX model: ``prefill`` and
``decode_step`` logits (and the KV they collect or write) on
smoke_config(llama3.2-1b) in float32, within 2e-5, with the reference's
own initialisation loaded through ``convert.params_from_jax``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import Runtime as JRuntime  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

TOL = 2e-5
PAGE = 8


@pytest.fixture(scope="module")
def pair():
    jcfg = j_smoke(j_get_arch("llama3.2-1b"))
    cfg = smoke_config(get_arch("llama3.2-1b"))
    jm = j_build(jcfg, JRuntime(compute_dtype=jnp.float32,
                                param_dtype=jnp.float32, remat="none",
                                page_size=PAGE))
    tm = build_model(cfg, Runtime(compute_dtype=torch.float32,
                                  param_dtype=torch.float32, page_size=PAGE),
                     device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, tm, tp


def test_configs_match_reference():
    for full in (False, True):
        jc = j_get_arch("llama3.2-1b")
        tc = get_arch("llama3.2-1b")
        if not full:
            jc, tc = j_smoke(jc), smoke_config(tc)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "rope_theta", "norm_eps",
                  "tie_embeddings", "period", "act"):
            assert getattr(tc, f) == getattr(jc, f), f


def _shapes(tree, path=""):
    """{path: shape} of a nested dict/list of arrays or tensors."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _shapes(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _shapes(v, f"{path}/{i}").items()}
    return {path: tuple(tree.shape)}


def test_init_matches_reference_layout(pair):
    jm, jp, tm, _ = pair
    tp = tm.init(torch.Generator().manual_seed(0))
    assert _shapes(tp) == _shapes(jp)
    assert all(t.dtype == torch.float32 for t in
               [tp["embed"], tp["stack"][0]["mixer"]["wq"]])


@pytest.mark.parametrize("seq", [1, 21, 37])
def test_prefill_logits_and_kv_match_jax(pair, seq):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(seq).integers(0, 512, (2, seq))
    jlog, jcols = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tlog, tcols = tm.prefill(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    for j in range(len(tcols)):
        for tkv, jkv in zip(tcols[j]["kv"], jcols[j]["kv"]):
            np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv),
                                       atol=TOL, rtol=TOL)


def test_decode_step_logits_and_pools_match_jax(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    b, maxp, nb = 3, 4, 16
    jcaches = jtr.init_decode_caches(jm.cfg, jm.rt, b, maxp, nb,
                                     jnp.float32)
    pools = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in jcaches.items()}
    tcaches = ttr.init_decode_caches(cfg, tm.rt, b, nb, torch.float32,
                                     device=torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in tcaches.items()} == \
        {k: v.shape for k, v in jcaches.items()}
    table = rng.permutation(nb)[:b * maxp].reshape(b, maxp).astype(np.int32)
    ctx = np.asarray([3, 17, 30], np.int32)
    toks = rng.integers(0, 512, (b,)).astype(np.int32)
    jlog, jnew = jax.jit(jm.decode_step)(
        jp, jnp.asarray(toks), {k: jnp.asarray(v) for k, v in pools.items()},
        ctx_lens=jnp.asarray(ctx), block_table=jnp.asarray(table))
    tlog, tnew = tm.decode_step(
        tp, torch.from_numpy(toks),
        {k: torch.from_numpy(v.copy()) for k, v in pools.items()},
        ctx_lens=torch.from_numpy(ctx), block_table=torch.from_numpy(table))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                               rtol=TOL)
    for k in pools:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   atol=TOL, rtol=TOL)
    assert int(np.argmax(tlog.numpy()[0])) == int(np.argmax(np.asarray(jlog)[0]))
