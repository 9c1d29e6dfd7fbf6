"""The port's VLM (llava-next-mistral-7b's backbone) against the JAX
model and engine, at ``smoke_config`` (2 layers, 8 prefix embeddings)
in float32 with the reference's initialisation loaded through
``convert.params_from_jax``: the config field by field, the init
layout, ``prefill`` logits and KV with ``prefix_emb`` (positions over
prefix and tokens), ``decode_step`` logits past a prefix (2e-5),
``ServeEngine`` greedy tokens identical to the JAX engine's
single-step and ``macro_k=4`` with requests with and without prefix
embeddings (one chunked admission, admission mapping the prefix's
pages), the reference's teacher-forcing check on the port, and the
engine's refusals (a journaled engine, prefix sharing)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_pairs import (close, emb, pair, share_jax_programs,  # noqa: E402
                          shapes, teacher_forcing)
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.model import _prefix_len as j_prefix_len  # noqa: E402
from repro.models.model import _src_len as j_src_len  # noqa: E402
from repro.serving.config import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.core.counters import COUNTERS  # noqa: E402
from repro_torch.models.model import _prefix_len, _src_len  # noqa: E402
from repro_torch.serving import (PrefixConfig, ServeConfig,  # noqa: E402
                                 ServeEngine)
from repro_torch.serving.engine import Request  # noqa: E402

ARCH = "llava-next-mistral-7b"
FIELDS = ("family", "n_layers", "n_enc_layers", "d_model", "n_heads",
          "n_kv_heads", "head_dim", "d_ff", "vocab_size", "rope_theta",
          "frontend", "prefix_len", "norm_eps", "tie_embeddings", "act",
          "period", "source")


@pytest.fixture(scope="module", autouse=True)
def shared_jax_programs():
    mp = share_jax_programs()
    yield
    mp.undo()


def test_configs_and_lengths_match_reference():
    for full in (True, False):
        jc, tc = j_get_arch(ARCH), get_arch(ARCH)
        if not full:
            jc, tc = j_smoke(jc), smoke_config(tc)
        for f in FIELDS:
            assert getattr(tc, f) == getattr(jc, f), f
        for seq in (16, 64, 4096, 32768):
            assert _prefix_len(tc, seq) == j_prefix_len(jc, seq)
            assert _src_len(tc, seq) == j_src_len(jc, seq) == 0
    enc = j_get_arch("seamless-m4t-large-v2")
    for seq in (64, 2048, 4096):
        assert _src_len(get_arch("seamless-m4t-large-v2"), seq) == \
            j_src_len(enc, seq)
    assert smoke_config(get_arch(ARCH)).prefix_len == 8


def test_init_matches_reference_layout():
    jm, jp, tm, tp, *_ = pair(ARCH)
    mine = tm.init(torch.Generator().manual_seed(0))
    assert shapes(mine) == shapes(jp) == shapes(tp)
    assert "enc_stack" not in mine and "cross" not in mine["stack"][0]


@pytest.mark.parametrize("seq", [1, 21])
def test_prefill_logits_and_kv_with_prefix_match_jax(seq):
    """8 prefix embeddings before ``seq`` tokens: logits and the KV of
    all 8 + seq positions within 2e-5."""
    jm, jp, tm, tp, jprefill, _ = pair(ARCH)
    d = tm.cfg.d_model
    toks = np.random.default_rng(seq).integers(0, 512, (2, seq))
    pre = np.stack([emb(11, 8, d), emb(12, 8, d)])
    jlog, jcols = jprefill(jp, {"tokens": jnp.asarray(toks),
                                "prefix_emb": jnp.asarray(pre)})
    tlog, tcols = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                  "prefix_emb": torch.from_numpy(pre)})
    close(tlog, jlog)
    for tc, jc in zip(tcols, jcols):
        assert tc["kv"][0].shape[2] == 8 + seq
        for t, j in zip(tc["kv"], jc["kv"]):
            close(t, j)


def test_decode_step_past_a_prefix_matches_jax():
    """Contexts that hold a prefix (positions 8 + tokens)."""
    jm, jp, tm, tp, _, jdecode = pair(ARCH)
    rng = np.random.default_rng(13)
    b, maxp, nb = 3, 6, 24
    jcaches = jtr.init_decode_caches(jm.cfg, jm.rt, b, maxp, nb,
                                     jnp.float32)
    caches = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in jcaches.items()}
    table = rng.permutation(nb)[:b * maxp].reshape(b, maxp).astype(np.int32)
    ctx = np.asarray([9, 23, 40], np.int32)
    toks = rng.integers(0, 512, (b,)).astype(np.int32)
    jlog, jnew = jdecode(jp, jnp.asarray(toks),
                         {k: jnp.asarray(v) for k, v in caches.items()},
                         ctx_lens=jnp.asarray(ctx),
                         block_table=jnp.asarray(table))
    tlog, tnew = tm.decode_step(
        tp, torch.from_numpy(toks),
        {k: torch.from_numpy(v.copy()) for k, v in caches.items()},
        ctx_lens=torch.from_numpy(ctx), block_table=torch.from_numpy(table))
    close(tlog, jlog)
    for k in caches:
        close(tnew[k], jnew[k])


# ------------------------------------------------------ engine
# (prompt, max_new, with prefix embeddings)
REQS = [(list(range(1, 12)), 6, True), (list(range(50, 73)), 5, False),
        (list(range(200, 219)), 4, True), (list(range(300, 305)), 5, False)]


def _submit_all(eng, to_arr):
    return [eng.submit(t, max_new=n, **({"prefix_emb": to_arr(
        emb(200 + i, 8, 64))} if pre else {}))
        for i, (t, n, pre) in enumerate(REQS)]


@pytest.mark.parametrize("macro_k", [0, 4])
def test_engine_tokens_identical_to_jax(macro_k):
    """Four requests on two slots, two with 8 prefix embeddings and two
    without, an admission budget of 16 tokens (the 23- and 19-token
    prompts are chunk-prefilled): the same greedy tokens, context
    lengths and mapped pages as the JAX engine in the same mode, and no
    kernel launch on the CPU."""
    jm, jp, tm, tp, *_ = pair(ARCH)
    cfg = dict(n_slots=2, max_ctx=64, macro_k=macro_k, admit_tokens=16)
    te = ServeEngine(tm, tp, config=ServeConfig(**cfg), device="cpu")
    je = JServeEngine(jm, jp, config=JServeConfig(**cfg))
    trids = _submit_all(te, lambda a: a)
    jrids = _submit_all(je, jnp.asarray)
    launches0 = COUNTERS.launches()
    te._admit()
    je._admit()
    # admission maps the prefix's pages: (8 + 11) tokens -> 3 pages of 8
    assert te.kvm.seq_pages == je.kvm.seq_pages
    assert len(te.kvm.seq_pages[0]) == 3
    np.testing.assert_array_equal(te.ctx_lens, je.ctx_lens)
    tdone, jdone = te.run(), je.run()
    got = [tdone[r] for r in trids]
    assert got == [jdone[r] for r in jrids]
    assert [len(g) for g in got] == [n for _, n, _ in REQS]
    assert COUNTERS.launches() == launches0
    assert te.metrics["chunked_prefills"] == je.metrics["chunked_prefills"] \
        >= 1
    assert (te.metrics["macro_steps"] > 0) is (macro_k > 0)
    assert te.metrics["macro_steps"] == je.metrics["macro_steps"]


def test_prefill_decode_matches_teacher_forcing():
    _, _, tm, tp, *_ = pair(ARCH)
    toks = [int(t) for t in np.random.default_rng(1).integers(0, 512, 21)]
    teacher_forcing(tm, tp, toks, 4, {"prefix_emb": emb(3, 8, 64)})


def test_engine_refuses_what_the_reference_refuses(tmp_path):
    """A journaled engine refuses prefix embeddings and takes token
    prompts; a model without an encoder refuses src_emb; prefix sharing
    takes a long token prompt and never one with prefix embeddings."""
    _, _, tm, tp, *_ = pair(ARCH)
    eng = ServeEngine(tm, tp, config=ServeConfig(
        n_slots=2, max_ctx=64, journal_path=str(tmp_path / "j")),
        device="cpu")
    with pytest.raises(ValueError, match="journaled"):
        eng.submit([1, 2, 3], prefix_emb=emb(0, 8, 64))
    assert eng.submit([1, 2, 3]) == 0
    eng = ServeEngine(tm, tp, config=ServeConfig(
        n_slots=2, max_ctx=64, prefix=PrefixConfig(min_tokens=4)),
        device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        eng.submit([1, 2, 3], src_emb=emb(0, 8, 64))
    long = list(range(1, 30))
    assert eng._share_ok(Request(0, long, 4))
    assert not eng._share_ok(Request(1, long, 4,
                                     prefix_emb=torch.zeros(8, 64)))
