"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX
model and engine, at ``smoke_config`` (2 encoder + 2 decoder layers) in
float32 with the reference's initialisation loaded through
``convert.params_from_jax``: the config field by field, the init
layout, ``attention_naive`` with segment ids against the reference's
``attention_naive`` and ``flash_attention_blocked`` (1e-5), ``cross_kv``
/ ``cross_forward``, ``prefill`` and ``decode_step`` logits and caches
with ``src_emb`` / ``src_valid`` (2e-5), ``ServeEngine`` greedy tokens
identical to the JAX engine's single-step and ``macro_k=4`` (one
chunked admission), the reference's teacher-forcing check on the port,
the engine's refusals (a journaled engine, prefix sharing), and where a
query row with no valid source frame occurs: only on a dead lane."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_pairs import (TOL, close, emb, pair, share_jax_programs,  # noqa: E402
                          shapes, teacher_forcing)
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving.config import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.core.counters import COUNTERS  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.serving import (PrefixConfig, ServeConfig,  # noqa: E402
                                 ServeEngine)
from repro_torch.serving.engine import Request  # noqa: E402

ARCH = "seamless-m4t-large-v2"
FIELDS = ("family", "n_layers", "n_enc_layers", "d_model", "n_heads",
          "n_kv_heads", "head_dim", "d_ff", "vocab_size", "act", "frontend",
          "prefix_len", "norm_eps", "rope_theta", "tie_embeddings", "period",
          "source")


@pytest.fixture(scope="module", autouse=True)
def shared_jax_programs():
    mp = share_jax_programs()
    yield
    mp.undo()


def test_configs_match_reference():
    for full in (True, False):
        jc, tc = j_get_arch(ARCH), get_arch(ARCH)
        if not full:
            jc, tc = j_smoke(jc), smoke_config(tc)
        for f in FIELDS:
            assert getattr(tc, f) == getattr(jc, f), f
        assert [tc.layer_kind(i) for i in range(tc.n_layers)] == \
            [jc.layer_kind(i) for i in range(jc.n_layers)]
    assert smoke_config(get_arch(ARCH)).n_enc_layers == 2


def test_init_matches_reference_layout():
    jm, jp, tm, tp, *_ = pair(ARCH)
    mine = tm.init(torch.Generator().manual_seed(0))
    assert shapes(mine) == shapes(jp) == shapes(tp)
    assert "cross" in mine["stack"][0] and "bq" not in \
        mine["stack"][0]["cross"]


# ------------------------------------------------------ segmented attention
def _packed(b, s, seed):
    """Packed segment ids [b, s]: runs of seeded lengths."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, s), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), 3, replace=False))
        out[i] = np.searchsorted(cuts, np.arange(s), side="right")
    return out


def _valid(lens, s):
    return (np.arange(s)[None, :] < np.asarray(lens)[:, None]).astype(
        np.int32)


SEG_CASES = {
    # packed sequences, causal self-attention (and with a window)
    "packed": dict(sq=48, skv=48, seg=lambda: (_packed(2, 48, 1),) * 2),
    "packed_window": dict(sq=48, skv=48, window=8,
                          seg=lambda: (_packed(2, 48, 2),) * 2),
    # Sq < Skv, causal right-aligned, queries the last 16 positions
    "packed_sq_lt_skv": dict(sq=16, skv=48, seg=lambda: (
        _packed(2, 48, 3)[:, 32:], _packed(2, 48, 3))),
    # prefix masks: every query sees a valid prefix of the keys
    "prefix_mask": dict(sq=16, skv=48, bidirectional=True, seg=lambda: (
        np.ones((2, 16), np.int32), _valid([30, 48], 48))),
    "bidirectional_packed": dict(sq=48, skv=48, bidirectional=True,
                                 seg=lambda: (_packed(2, 48, 4),) * 2),
    # decode-time cross-attention: one query, per-lane valid frames
    "cross_decode": dict(sq=1, skv=48, bidirectional=True, seg=lambda: (
        np.ones((2, 1), np.int32), _valid([17, 48], 48))),
}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_attention_naive_segments_match_reference(case):
    """f32 within 1e-5 of the reference's oracle and of its blocked
    lowering (16-row chunks, so the masks cross chunk edges), the path
    the reference takes for every segmented call."""
    spec = dict(SEG_CASES[case])
    sq, skv = spec.pop("sq"), spec.pop("skv")
    seg = tuple(spec.pop("seg")())
    kw = dict(causal=not spec.get("bidirectional", False), **spec)
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    got = ref.attention_naive(
        *(torch.from_numpy(a) for a in (q, k, v)),
        segment_ids=tuple(torch.from_numpy(s) for s in seg), **kw)
    jseg = tuple(jnp.asarray(s) for s in seg)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    close(got, jref.attention_naive(jq, jk, jv, segment_ids=jseg, **kw),
          1e-5)
    close(got, jref.flash_attention_blocked(
        jq, jk, jv, segment_ids=jseg, q_chunk=min(16, sq), kv_chunk=16,
        **kw), 1e-5)


def test_rows_without_a_valid_key_are_zero():
    """A query row whose segment has no key: the port (its plain version
    and the kernel) returns 0, the reference the mean of v (its -1e30 is
    finite); rows with a key agree."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    seg = (np.ones((2, 1), np.int32), _valid([0, 9], 24))
    kw = dict(causal=False, bidirectional=True)
    got = ref.attention_naive(
        *(torch.from_numpy(a) for a in (q, k, v)),
        segment_ids=tuple(torch.from_numpy(s) for s in seg), **kw)
    want = np.asarray(jref.attention_naive(
        *(jnp.asarray(a) for a in (q, k, v)),
        segment_ids=tuple(jnp.asarray(s) for s in seg), **kw))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(want[0, 0], v[0].mean(axis=0), atol=1e-5)
    close(got[1], want[1], 1e-5)


# ------------------------------------------------------ model
def test_cross_kv_and_cross_forward_match_jax():
    jm, jp, tm, tp, *_ = pair(ARCH)
    d = tm.cfg.d_model
    enc = np.stack([emb(1, 20, d), emb(2, 20, d)])
    x = np.stack([emb(3, 5, d), emb(4, 5, d)])
    valid = _valid([20, 13], 20)
    jlp = jax.tree.map(lambda t: t[1], jp["stack"][0]["cross"])
    tlp = {k: v[1] for k, v in tp["stack"][0]["cross"].items()}
    jkv = jattn.cross_kv(jlp, jnp.asarray(enc), jm.cfg, jm.rt)
    tkv = tattn.cross_kv(tlp, torch.from_numpy(enc), tm.cfg, tm.rt)
    for t, j in zip(tkv, jkv):
        close(t, j)
    jy = jattn.cross_forward(jlp, jnp.asarray(x), jkv, jm.cfg, jm.rt,
                             src_valid=jnp.asarray(valid))
    ty = tattn.cross_forward(tlp, torch.from_numpy(x), tkv, tm.cfg, tm.rt,
                             src_valid=torch.from_numpy(valid))
    close(ty, jy)


@pytest.mark.parametrize("seq", [1, 19])
def test_prefill_logits_and_caches_match_jax(seq):
    """src_emb with padded frames (src_valid [24, 11] of 24): logits, the
    decoder's KV and its cross K/V within 2e-5."""
    jm, jp, tm, tp, jprefill, _ = pair(ARCH)
    d = tm.cfg.d_model
    toks = np.random.default_rng(seq).integers(0, 512, (2, seq))
    src = np.stack([emb(5, 24, d), emb(6, 24, d)])
    batch = dict(tokens=toks, src_emb=src, src_valid=_valid([24, 11], 24))
    jlog, jcols = jprefill(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tlog, tcols = tm.prefill(tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    close(tlog, jlog)
    for tc, jc in zip(tcols, jcols):
        assert set(tc) == set(jc) == {"kv", "cross_kv"}
        for key in tc:
            for t, j in zip(tc[key], jc[key]):
                close(t, j)


def _decode_inputs(jm, lens, seed=9):
    rng = np.random.default_rng(seed)
    b, maxp, nb, src = len(lens), 4, 16, 24
    jcaches = jtr.init_decode_caches(jm.cfg, jm.rt, b, maxp, nb,
                                     jnp.float32, src_len=src)
    caches = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in jcaches.items()}
    table = rng.permutation(nb)[:b * maxp].reshape(b, maxp).astype(np.int32)
    ctx = rng.integers(1, maxp * 8 - 1, (b,)).astype(np.int32)
    toks = rng.integers(0, 512, (b,)).astype(np.int32)
    return caches, table, ctx, toks, _valid(lens, src)


def _decode_both(jm, jp, tm, tp, jdecode, lens):
    caches, table, ctx, toks, valid = _decode_inputs(jm, lens)
    jlog, jnew = jdecode(jp, jnp.asarray(toks),
                         {k: jnp.asarray(v) for k, v in caches.items()},
                         ctx_lens=jnp.asarray(ctx),
                         block_table=jnp.asarray(table),
                         src_valid=jnp.asarray(valid))
    tlog, tnew = tm.decode_step(
        tp, torch.from_numpy(toks),
        {k: torch.from_numpy(v.copy()) for k, v in caches.items()},
        ctx_lens=torch.from_numpy(ctx), block_table=torch.from_numpy(table),
        src_valid=torch.from_numpy(valid))
    return tlog, jlog, tnew, jnew


def test_decode_step_logits_and_caches_match_jax():
    jm, jp, tm, tp, _, jdecode = pair(ARCH)
    tlog, jlog, tnew, jnew = _decode_both(jm, jp, tm, tp, jdecode,
                                          [24, 7, 1])
    close(tlog, jlog)
    assert set(tnew) == {"pool_k", "pool_v", "cross_k", "cross_v"}
    for k in tnew:
        close(tnew[k], jnew[k])


def test_decode_lane_without_source_frames_leaves_live_lanes_exact():
    """A lane with no valid frame (a dead serving lane): its cross
    attention is 0 in the port and the mean of v in the reference, so
    its logits differ; every other lane's match within 2e-5."""
    jm, jp, tm, tp, _, jdecode = pair(ARCH)
    tlog, jlog, _, _ = _decode_both(jm, jp, tm, tp, jdecode, [24, 0, 5])
    close(tlog[[0, 2]], np.asarray(jlog)[[0, 2]])
    assert not np.allclose(tlog[1].numpy(), np.asarray(jlog)[1], atol=TOL)


# ------------------------------------------------------ engine
REQS = [(list(range(1, 7)), 20, 5), (list(range(50, 61)), 33, 4),
        (list(range(200, 217)), 47, 6)]


def _submit_all(eng, to_src):
    return [eng.submit(t, max_new=n, src_emb=to_src(emb(100 + i, s, 64)))
            for i, (t, s, n) in enumerate(REQS)]


@pytest.mark.parametrize("macro_k", [0, 4])
def test_engine_tokens_identical_to_jax(macro_k):
    """Three requests on two slots (the third waits for a free slot),
    source lengths 20 / 33 / 47 frames of src_cap 128, an admission
    budget of 12 tokens (the 17-token prompt is chunk-prefilled): the
    same greedy tokens as the JAX engine in the same mode, and no kernel
    launch on the CPU."""
    jm, jp, tm, tp, *_ = pair(ARCH)
    cfg = dict(n_slots=2, max_ctx=64, macro_k=macro_k, admit_tokens=12)
    te = ServeEngine(tm, tp, config=ServeConfig(**cfg), device="cpu")
    je = JServeEngine(jm, jp, config=JServeConfig(**cfg))
    trids = _submit_all(te, lambda a: a)
    jrids = _submit_all(je, jnp.asarray)
    launches0 = COUNTERS.launches()
    tdone, jdone = te.run(), je.run()
    got = [tdone[r] for r in trids]
    assert got == [jdone[r] for r in jrids]
    assert [len(g) for g in got] == [n for *_, n in REQS]
    assert COUNTERS.launches() == launches0
    assert te.metrics["chunked_prefills"] == je.metrics["chunked_prefills"] \
        >= 1
    assert (te.metrics["macro_steps"] > 0) is (macro_k > 0)
    assert te.metrics["macro_steps"] == je.metrics["macro_steps"]
    assert te.src_cap == je.src_cap == 128
    np.testing.assert_array_equal(te.src_lens, je.src_lens)


def test_prefill_decode_matches_teacher_forcing():
    _, _, tm, tp, *_ = pair(ARCH)
    toks = [int(t) for t in np.random.default_rng(1).integers(0, 512, 21)]
    teacher_forcing(tm, tp, toks, 4, {"src_emb": emb(2, 32, 64)})


def test_rows_without_a_valid_frame_only_on_dead_lanes(monkeypatch):
    """Three slots, two requests: the decode step's source mask is the
    slot's valid frames times the live lanes, so the lanes with no valid
    frame are exactly the dead ones (the unused slot at every step, a
    retired slot after), never a live one; their tokens are discarded
    (each request's tokens equal a one-slot engine's)."""
    _, _, tm, tp, *_ = pair(ARCH)
    seen = []
    eng = ServeEngine(tm, tp, config=ServeConfig(n_slots=3, max_ctx=64),
                      device="cpu")
    decode_fn, decode_step = eng.decode_fn, tm.decode_step

    def spy_fn(params, caches, tokens, ctx_lens, table, live, pages):
        seen.append([live.clone()])
        return decode_fn(params, caches, tokens, ctx_lens, table, live,
                         pages)

    def spy_step(*args, src_valid=None, **kw):
        seen[-1].append(src_valid.sum(dim=1) == 0)
        return decode_step(*args, src_valid=src_valid, **kw)
    eng.decode_fn = spy_fn
    monkeypatch.setattr(tm, "decode_step", spy_step)
    rids = [eng.submit(t, max_new=n, src_emb=emb(100 + i, s, 64))
            for i, (t, s, n) in enumerate(REQS[:2])]
    done = eng.run()
    monkeypatch.undo()
    assert seen and all(torch.equal(empty, ~live) for live, empty in seen)
    assert all(bool(empty[2]) for _, empty in seen)
    for rid, (t, s, n), i in zip(rids, REQS, range(2)):
        solo = ServeEngine(tm, tp, config=ServeConfig(n_slots=1, max_ctx=64),
                           device="cpu")
        r = solo.submit(t, max_new=n, src_emb=emb(100 + i, s, 64))
        assert solo.run()[r] == done[rid]


def test_engine_refuses_what_the_reference_refuses(tmp_path):
    """A journaled engine refuses embeddings (it persists token prompts
    only); a request without src_emb, or with more frames than src_cap,
    is refused; prefix sharing never takes a request with embeddings."""
    _, _, tm, tp, *_ = pair(ARCH)
    eng = ServeEngine(tm, tp, config=ServeConfig(
        n_slots=2, max_ctx=64, journal_path=str(tmp_path / "j")),
        device="cpu")
    with pytest.raises(ValueError, match="journaled"):
        eng.submit([1, 2, 3], src_emb=emb(0, 8, 64))
    eng = ServeEngine(tm, tp, config=ServeConfig(
        n_slots=2, max_ctx=64, prefix=PrefixConfig(min_tokens=4)),
        device="cpu")
    for bad in (None, emb(0, eng.src_cap + 1, 64)):
        with pytest.raises(ValueError, match="src_emb"):
            eng.submit([1, 2, 3], src_emb=bad)
    long = list(range(1, 30))
    assert eng._share_ok(Request(0, long, 4))
    assert not eng._share_ok(Request(1, long, 4, src_emb=torch.zeros(8, 64)))
