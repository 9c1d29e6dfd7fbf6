"""The port's sampling policies and serving launcher on the CPU against
the JAX package: ``serving.sampling.greedy`` and ``temperature`` against
``repro.serving.sampling`` (argmax ties, the top-k kept set with ties at
its threshold, a chi-square test of the draws' frequencies against
``softmax(l / temp)`` over that set), and ``launch.serve.main`` at
``--smoke --device cpu`` against the reference's ``ServeEngine`` built as
``repro/launch/serve.py`` builds it (with no EOS the counts depend on no
weight)."""
import contextlib
import io
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import Runtime as JRuntime  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.paging.kv_manager import MapStats as JMapStats  # noqa: E402
from repro.serving import sampling as jsampling  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402

VOCAB = 40
N_DRAWS = 20_000
P_MIN = 1e-3


def _logits(seed, rows=6, ties=True):
    """Seeded float32 logits [rows, VOCAB], integers / 4 so that values
    repeat; with ``ties`` each row's maximum is planted at two places."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-12, 12, (rows, VOCAB)) / 4).astype(np.float32)
    if ties:
        for r in range(rows):
            i, j = rng.choice(VOCAB, 2, replace=False)
            x[r, i] = x[r, j] = x[r].max() + 1.0
    else:
        x += (1e-3 * rng.standard_normal(x.shape)).astype(np.float32)
    return x


def _kept(row, temp, top_k):
    """The reference's kept set of one row: the entries its top-k cut
    leaves above the fill."""
    l = jnp.asarray(row) / temp
    thresh = jax.lax.top_k(l, top_k)[0][..., -1:]
    return np.asarray(l >= thresh)


def test_greedy_matches_reference_on_ties():
    x = _logits(0)
    got = sampling.greedy(torch.from_numpy(x))
    want = np.asarray(jsampling.greedy(jnp.asarray(x)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert all(x[r, want[r]] == x[r].max() for r in range(len(x)))
    # the first of the two planted maxima
    assert all(np.flatnonzero(x[r] == x[r].max())[0] == want[r]
               for r in range(len(x)))


@pytest.mark.parametrize("temp,top_k,ties", [(0.0, 0, True),
                                             (-1.0, 5, True),
                                             (0.7, 1, False),
                                             (3.0, 1, False)])
def test_temperature_degenerates_to_greedy(temp, top_k, ties):
    """temp <= 0 is greedy; top_k = 1 keeps the maximum alone (logits
    without a tie at the top), so every draw is greedy's."""
    x = torch.from_numpy(_logits(1, rows=64, ties=ties))
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        got = sampling.temperature(x, g, temp=temp, top_k=top_k)
        assert got.dtype == torch.int32
        assert torch.equal(got, sampling.greedy(x))


@pytest.mark.parametrize("temp,top_k", [(1.0, 0), (0.5, 7), (2.0, 3)])
def test_temperature_draws_match_reference_distribution(temp, top_k):
    """N_DRAWS draws of one row with ties at the k-th value: none outside
    the reference's kept set, and the frequencies pass a chi-square test
    at P_MIN against softmax(l / temp) over that set."""
    row = _logits(2, rows=1, ties=False)[0].round(0)
    if top_k:
        order = np.argsort(-row, kind="stable")
        row[order[top_k]] = row[order[top_k - 1]]  # a tie at the cut
    kept = _kept(row, temp, top_k) if top_k else np.ones(VOCAB, bool)
    assert kept.sum() >= top_k + (1 if top_k else 0)
    x = torch.from_numpy(np.tile(row, (N_DRAWS, 1)))
    got = sampling.temperature(x, torch.Generator().manual_seed(3),
                               temp=temp, top_k=top_k).numpy()
    assert kept[got].all()
    l = row.astype(np.float64) / temp
    p = np.where(kept, np.exp(l - l[kept].max()), 0.0)
    p /= p.sum()
    counts = np.bincount(got, minlength=VOCAB)
    expect = p * N_DRAWS
    # pool the cells expected below 5 (the test's validity rule)
    small = expect < 5
    f_obs = np.append(counts[~small], counts[small].sum())
    f_exp = np.append(expect[~small], expect[small].sum())
    if f_exp[-1] == 0:
        f_obs, f_exp = f_obs[:-1], f_exp[:-1]
    assert stats.chisquare(f_obs, f_exp).pvalue > P_MIN


def test_top_k_mask_matches_reference_cut():
    """Batched rows, each its own kept set with ties at the threshold:
    the port's mask equals the reference's cut row by row."""
    x = _logits(4, rows=16)
    for k in (1, 2, 5, 9):
        got = sampling.top_k_mask(torch.from_numpy(x) / 1.3, k).numpy()
        l = jnp.asarray(x) / 1.3
        thresh = jax.lax.top_k(l, k)[0][..., -1:]
        want = np.asarray(jnp.where(l < thresh, -1e30, l))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- launcher
def _port_launch(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    text = buf.getvalue()
    head, _, tail = text.partition("\nreq ")
    return json.loads(head), "req " + tail


def _reference_metrics(arch, n_requests, max_new):
    """The reference launcher's engine and requests
    (``repro/launch/serve.py:34-56``) at its defaults, run; its
    ``metrics`` and ``kvm.hit_stats()``."""
    cfg = j_smoke(j_get_arch(arch))
    rt = JRuntime(compute_dtype=jnp.float32, param_dtype=jnp.float32,
                  remat="none", page_size=16, capacity_factor=100.0)
    model = j_build(cfg, rt)
    params = model.init(jax.random.key(0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = JServeEngine(model, params, n_slots=4, max_ctx=256,
                           n_host_blocks=0)
    rng = np.random.default_rng(0)
    for i in range(n_requests):
        plen = int(rng.integers(8, 48))
        toks = rng.integers(2, cfg.vocab_size, plen).tolist()
        kw = {}
        if cfg.prefix_len:
            kw["prefix_emb"] = 0.02 * jax.random.normal(
                jax.random.key(i), (min(cfg.prefix_len, 8), cfg.d_model))
        if cfg.n_enc_layers:
            kw["src_emb"] = 0.02 * jax.random.normal(
                jax.random.key(100 + i), (32, cfg.d_model))
        eng.submit(toks, max_new=max_new, **kw)
    done = eng.run()
    return len(done), eng.metrics, eng.kvm.hit_stats()


@pytest.mark.parametrize("arch,n_requests,max_new", [
    ("llama3.2-1b", 6, 16), ("seamless-m4t-large-v2", 5, 6)])
def test_launcher_matches_reference_engine(arch, n_requests, max_new):
    """The JSON parses with the reference's keys (``fmmu_map`` with
    ``MapStats``' fields), and completed, generated_tokens,
    decode_steps and preemptions equal the reference engine's."""
    out, reqs = _port_launch(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", str(n_requests),
                              "--max-new", str(max_new)])
    assert set(out) == {"completed", "generated_tokens", "decode_steps",
                        "preemptions", "tok_per_s", "fmmu_map",
                        "pool_peak_blocks"}
    assert set(out["fmmu_map"]) == set(JMapStats().as_dict())
    completed, metrics, jstats = _reference_metrics(arch, n_requests,
                                                    max_new)
    assert out["completed"] == completed == n_requests
    for k, j in (("generated_tokens", "generated"),
                 ("decode_steps", "decode_steps"),
                 ("preemptions", "preemptions")):
        assert out[k] == metrics[j], k
    assert out["generated_tokens"] == n_requests * max_new
    assert out["fmmu_map"]["updates"] == jstats["updates"]
    assert len(reqs.strip().splitlines()) == min(3, n_requests)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_launcher_cuda_without_card_raises():
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "llama3.2-1b", "--smoke"])
