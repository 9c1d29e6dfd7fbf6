"""The port's Mamba2 path against the JAX reference on the CPU: the
``mamba_chunk_scan`` plain version against the Pallas kernel in
interpret mode (S a multiple of the chunk) and against the naive scan
(ragged S, 1 <= S < chunk included), the chunked plain version
``mamba_chunk_scan_blocked`` against the reference's (and, padded with
x = dt = 0 rows, against the naive scan of a ragged S),
``mamba_decode_step``, ``ssm_forward``/``ssm_decode``, the smoke model's
prefill and decode, and the ServeEngine on smoke_config(mamba2-1.3b):
greedy tokens equal to the JAX engine's and the map state bit-identical. The reference's
init is loaded through ``convert.params_from_jax``; other inputs come
from a numpy seed. Tolerances: the scan 5e-3 f32 / 8e-2 bf16 (the
Pallas tests'), the f32 model paths 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.kernels import mamba_scan as jms  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import Runtime as JRuntime  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving.config import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import ArchConfig, get_arch, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.counters import COUNTERS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_chunk_scan  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving import ServeConfig, ServeEngine  # noqa: E402

SCAN_TOL = {"float32": 5e-3, "bfloat16": 8e-2}
TOL = 1e-4
PAGE = 8
ARCH = "mamba2-1.3b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dtype="float32"):
    """One numpy array -> (jax array, torch tensor) of the same values."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(JDT[dtype]), \
        torch.from_numpy(a.copy()).to(TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scan_inputs(seed, bt, s, h, p, n, dtype, init=False):
    """(jax args, torch args, (jax s0, torch s0)); dt = softplus(N(0,1))
    in f32 as ssm_forward passes it, A = -exp(N(0,1)), D ~ N(1, 0.1)."""
    rng = np.random.default_rng(seed)
    x = _both(rng.standard_normal((bt, s, h, p)), dtype)
    dt = _both(np.log1p(np.exp(rng.standard_normal((bt, s, h)))))
    a = _both(-np.exp(rng.standard_normal(h)))
    b = _both(rng.standard_normal((bt, s, n)), dtype)
    c = _both(rng.standard_normal((bt, s, n)), dtype)
    d = _both(1.0 + 0.1 * rng.standard_normal(h))
    s0 = _both(rng.standard_normal((bt, h, p, n))) if init else (None, None)
    args = (x, dt, a, b, c, d)
    return [t[0] for t in args], [t[1] for t in args], s0


def _assert_close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------- scan
@pytest.mark.parametrize("bt,s,h,p,n,chunk", [
    (2, 64, 2, 16, 16, 32), (1, 128, 4, 32, 32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_chunk_scan_ref_vs_pallas(bt, s, h, p, n, chunk, dtype):
    jargs, targs, _ = _scan_inputs(0, bt, s, h, p, n, dtype)
    yw, fw = jms.mamba_chunk_scan(*jargs, chunk=chunk, interpret=True)
    y, fin = mamba_chunk_scan(*targs, chunk=chunk)
    assert y.dtype == TDT[dtype] and y.shape == (bt, s, h, p)
    assert fin.dtype == torch.float32 and fin.shape == (bt, h, p, n)
    _assert_close(y, yw, SCAN_TOL[dtype])
    _assert_close(fin, fw, SCAN_TOL[dtype])


def test_mamba_chunk_scan_initial_state_vs_pallas():
    jargs, targs, (js0, ts0) = _scan_inputs(1, 1, 64, 2, 8, 16, "float32",
                                            init=True)
    yw, fw = jms.mamba_chunk_scan(*jargs, chunk=16, initial_state=js0,
                                  interpret=True)
    y, fin = mamba_chunk_scan(*targs, chunk=16, initial_state=ts0)
    _assert_close(y, yw, SCAN_TOL["float32"])
    _assert_close(fin, fw, SCAN_TOL["float32"])


@pytest.mark.parametrize("s", [1, 3, 31, 32, 33, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_chunk_scan_ragged_vs_naive(s, dtype):
    """Ragged and short S (the engine prefills prompts of any length
    unpadded) against the reference's naive scan, with an initial
    state; chunk 32 as in the smoke config."""
    jargs, targs, (js0, ts0) = _scan_inputs(s, 2, s, 4, 16, 16, dtype,
                                            init=True)
    yw, fw = jref.mamba_chunk_scan_naive(*jargs, chunk=32,
                                         initial_state=js0)
    y, fin = ops.mamba_chunk_scan(*targs, chunk=32, initial_state=ts0)
    _assert_close(y, yw, SCAN_TOL[dtype])
    _assert_close(fin, fw, SCAN_TOL[dtype])


@pytest.mark.parametrize("bt,s,h,p,n,chunk", [
    (2, 64, 2, 16, 16, 32), (1, 128, 4, 32, 32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True])
def test_mamba_chunk_scan_blocked_vs_jax(bt, s, h, p, n, chunk, dtype, init):
    """The port's chunked SSD plain version (the bf16 kernel's
    arithmetic) against the reference's ``mamba_chunk_scan_blocked``."""
    jargs, targs, (js0, ts0) = _scan_inputs(7, bt, s, h, p, n, dtype,
                                            init=init)
    yw, fw = jref.mamba_chunk_scan_blocked(*jargs, chunk=chunk,
                                           initial_state=js0)
    y, fin = tref.mamba_chunk_scan_blocked(*targs, chunk=chunk,
                                           initial_state=ts0)
    assert y.dtype == TDT[dtype] and fin.dtype == torch.float32
    _assert_close(y, yw, SCAN_TOL[dtype])
    _assert_close(fin, fw, SCAN_TOL[dtype])


@pytest.mark.parametrize("s", [33, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_chunk_scan_padded_ragged_vs_naive(s, dtype):
    """The bf16 kernel's edge scheme: a ragged S padded up to a chunk
    multiple with x = 0, dt = 0 (and B = C = 0) rows adds nothing to
    the state (decay 2^0 = 1, dt x = 0), so the blocked form of the
    padded input equals the reference's naive scan of the unpadded one
    on the real rows and on the final state."""
    chunk = 32
    jargs, targs, (js0, ts0) = _scan_inputs(11 + s, 2, s, 3, 16, 16, dtype,
                                            init=True)
    yw, fw = jref.mamba_chunk_scan_naive(*jargs, chunk=chunk,
                                         initial_state=js0)
    x, dt, a, b, c, d = targs
    pad = -s % chunk

    def padded(t):
        z = torch.zeros((t.shape[0], pad) + tuple(t.shape[2:]),
                        dtype=t.dtype)
        return torch.cat([t, z], dim=1)
    y, fin = tref.mamba_chunk_scan_blocked(
        padded(x), padded(dt), a, padded(b), padded(c), d, chunk=chunk,
        initial_state=ts0)
    assert y.shape[1] == s + pad and (s + pad) % chunk == 0
    _assert_close(y[:, :s], yw, SCAN_TOL[dtype])
    _assert_close(fin, fw, SCAN_TOL[dtype])


def test_mamba_decode_step_vs_jax():
    rng = np.random.default_rng(3)
    bt, h, p, n = 3, 4, 16, 16
    st = _both(rng.standard_normal((bt, h, p, n)))
    x = _both(rng.standard_normal((bt, h, p)))
    dt = _both(np.log1p(np.exp(rng.standard_normal((bt, h)))))
    a = _both(-np.exp(rng.standard_normal(h)))
    b = _both(rng.standard_normal((bt, n)))
    c = _both(rng.standard_normal((bt, n)))
    d = _both(np.ones(h))
    args = (st, x, dt, a, b, c, d)
    yw, sw = jref.mamba_decode_step(*[t[0] for t in args])
    y, s2 = ops.mamba_decode_step(*[t[1] for t in args])
    _assert_close(y, yw, 1e-5)
    _assert_close(s2, sw, 1e-5)


def test_softplus_matches_jax():
    """torch's F.softplus returns x above a threshold of 20; the port's
    softplus is jax.nn.softplus (logaddexp(x, 0)) everywhere."""
    xs = np.concatenate([np.linspace(-60, 60, 481),
                         [-1e4, -100.0, 19.99, 20.0, 20.01, 1e4]]
                        ).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(xs)))
    got = tssm.softplus(torch.from_numpy(xs)).numpy()
    # atol: XLA flushes f32 denormals (softplus(-100) ~ 4e-44) to zero
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-38)


# --------------------------------------------------------------- model
@pytest.fixture(scope="module")
def pair():
    jcfg = j_smoke(j_get_arch(ARCH))
    cfg = smoke_config(get_arch(ARCH))
    jm = j_build(jcfg, JRuntime(compute_dtype=jnp.float32,
                                param_dtype=jnp.float32, remat="none",
                                page_size=PAGE))
    tm = build_model(cfg, Runtime(compute_dtype=torch.float32,
                                  param_dtype=torch.float32, page_size=PAGE),
                     device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, tm, tp


def _shapes(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict/list of arrays."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _shapes(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _shapes(v, f"{path}/{i}").items()}
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def test_configs_match_reference_and_unported_families_raise():
    for full in (False, True):
        jc, tc = j_get_arch(ARCH), get_arch(ARCH)
        if not full:
            jc, tc = j_smoke(jc), smoke_config(tc)
        for f in ("family", "n_layers", "d_model", "d_ff", "vocab_size",
                  "tie_embeddings", "norm_eps", "period", "source"):
            assert getattr(tc, f) == getattr(jc, f), f
        for f in ("d_state", "head_dim", "expand", "chunk", "conv_dim"):
            assert getattr(tc.ssm, f) == getattr(jc.ssm, f), f
        assert [tc.layer_kind(i) for i in range(tc.n_layers)] == \
            [jc.layer_kind(i) for i in range(jc.n_layers)]
    for fam in ("hybrid", "moe", "encdec", "vlm", "audio"):
        with pytest.raises(NotImplementedError):
            ArchConfig(name="x", family=fam, n_layers=2, d_model=8,
                       n_heads=2, n_kv_heads=2, d_ff=8, vocab_size=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_and_convert_keep_reference_dtypes(dtype):
    """Model.init draws the reference's shapes and dtypes (A_log, D and
    dt_bias in f32 whatever the parameter dtype; no ffn/ln2 at d_ff=0),
    and params_from_jax carries the reference's pytree across with its
    f32 leaves."""
    jcfg, cfg = j_smoke(j_get_arch(ARCH)), smoke_config(get_arch(ARCH))
    jm = j_build(jcfg, JRuntime(param_dtype=JDT[dtype], remat="none"))
    tm = build_model(cfg, Runtime(param_dtype=TDT[dtype]), device="cpu")
    jp = jm.init(jax.random.key(0))
    want = _shapes(jax.tree.map(np.asarray, jp))
    mine = tm.init(torch.Generator().manual_seed(0))
    assert _shapes(mine) == want
    assert "ffn" not in mine["stack"][0] and "ln2" not in mine["stack"][0]
    mixer = mine["stack"][0]["mixer"]
    assert all(mixer[k].dtype == torch.float32
               for k in ("A_log", "D", "dt_bias"))
    assert mixer["wx"].dtype == TDT[dtype]
    conv = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert _shapes(conv) == want
    for k in ("A_log", "dt_bias", "wx", "conv_w"):
        np.testing.assert_array_equal(
            _np(conv["stack"][0]["mixer"][k]),
            np.asarray(jp["stack"][0]["mixer"][k], np.float32))


@pytest.mark.parametrize("seq", [1, 2, 21])
def test_ssm_forward_and_decode_vs_jax(pair, seq):
    """One mixer: prefill output and collected (conv, ssm) state (S <
    K-1 included), then one decode step from that state."""
    jm, jp, tm, tp = pair
    jlp = jax.tree.map(lambda t: t[0], jp["stack"][0]["mixer"])
    tlp = ttr.layer_params(tp["stack"], 0, 0)["mixer"]
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, tm.cfg.d_model)).astype(np.float32)
    jy, jst = jssm.ssm_forward(jlp, jnp.asarray(x), jm.cfg, jm.rt,
                               return_state=True)
    ty, tst = tssm.ssm_forward(tlp, torch.from_numpy(x), tm.cfg, tm.rt,
                               return_state=True)
    _assert_close(ty, jy, TOL)
    for a, b in zip(tst, jst):
        _assert_close(a, b, TOL)
    x1 = rng.standard_normal((2, tm.cfg.d_model)).astype(np.float32)
    jy1, jst1 = jssm.ssm_decode(jlp, jnp.asarray(x1), jst, jm.cfg, jm.rt)
    ty1, tst1 = tssm.ssm_decode(tlp, torch.from_numpy(x1), tst, tm.cfg,
                                tm.rt)
    _assert_close(ty1, jy1, TOL)
    for a, b in zip(tst1, jst1):
        _assert_close(a, b, TOL)


@pytest.mark.parametrize("seq", [1, 21, 40])
def test_prefill_logits_and_states_match_jax(pair, seq):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(seq).integers(0, 512, (2, seq))
    jlog, jcols = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tlog, tcols = tm.prefill(tp, torch.from_numpy(toks))
    _assert_close(tlog, jlog, TOL)
    assert len(tcols) == len(jcols)
    for tc, jc in zip(tcols, jcols):
        assert set(tc) == set(jc) == {"ssm"}
        for a, b in zip(tc["ssm"], jc["ssm"]):
            assert tuple(a.shape) == b.shape
            _assert_close(a, b, TOL)


def test_decode_step_logits_and_states_match_jax(pair):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(5)
    b, maxp, nb = 3, 4, 16
    jcaches = jtr.init_decode_caches(jm.cfg, jm.rt, b, maxp, nb,
                                     jnp.float32)
    tcaches = ttr.init_decode_caches(tm.cfg, tm.rt, b, nb, torch.float32,
                                     device=torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in tcaches.items()} == \
        {k: v.shape for k, v in jcaches.items()}
    assert set(tcaches) == {"conv", "ssm"}      # no pool without attention
    states = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in jcaches.items()}
    table = rng.permutation(nb)[:b * maxp].reshape(b, maxp).astype(np.int32)
    ctx = np.asarray([3, 17, 30], np.int32)
    toks = rng.integers(0, 512, (b,)).astype(np.int32)
    jlog, jnew = jax.jit(jm.decode_step)(
        jp, jnp.asarray(toks), {k: jnp.asarray(v) for k, v in states.items()},
        ctx_lens=jnp.asarray(ctx), block_table=jnp.asarray(table))
    tc = {k: torch.from_numpy(v.copy()) for k, v in states.items()}
    tlog, tnew = tm.decode_step(tp, torch.from_numpy(toks), tc,
                                ctx_lens=torch.from_numpy(ctx),
                                block_table=torch.from_numpy(table))
    _assert_close(tlog, jlog, TOL)
    for k in states:
        assert tnew[k] is tc[k]                   # updated in place
        _assert_close(tnew[k], jnew[k], TOL)


# -------------------------------------------------------------- engine
def _engines(pair, reqs, **cfg):
    """Both engines with the same requests submitted; not yet run."""
    jm, jp, tm, tp = pair
    te = ServeEngine(tm, tp, config=ServeConfig(**cfg), device="cpu")
    je = JServeEngine(jm, jp, config=JServeConfig(**cfg))
    rids = [(te.submit(t, max_new=n), je.submit(t, max_new=n))
            for t, n in reqs]
    return te, je, rids


def _assert_map_equal(te, je):
    for name in te.kvm.state._fields:
        tv, jv = getattr(te.kvm.state, name), getattr(je.kvm.state, name)
        if name == "fmmu":
            for f in tv._fields:
                np.testing.assert_array_equal(
                    getattr(tv, f).numpy(), np.asarray(getattr(jv, f)),
                    err_msg=f"fmmu.{f}")
        elif tv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                          err_msg=name)


T1, T2 = list(range(1, 12)), list(range(50, 87))


@pytest.mark.parametrize("case", ["two_concurrent", "chunked"])
def test_engine_tokens_and_map_identical_to_jax(pair, case):
    if case == "two_concurrent":
        reqs = [(T1, 6), (T2, 5)]
        cfg = dict(n_slots=2, max_ctx=64)
    else:
        # admit_tokens=8: T2's first 8 tokens are prefilled, the rest
        # stream through decode as forced lanes continuing the
        # recurrence from the prefilled conv/SSM state
        reqs = [(T2, 5), (T1, 5)]
        cfg = dict(n_slots=2, max_ctx=64, admit_tokens=8)
    te, je, rids = _engines(pair, reqs, **cfg)
    launches0 = COUNTERS.launches()
    tdone, jdone = te.run(), je.run()
    got = [tdone[t] for t, _ in rids]
    assert got == [jdone[j] for _, j in rids]
    assert [len(g) for g in got] == [n for _, n in reqs]
    _assert_map_equal(te, je)
    assert te.kvm.hit_stats()["updates"] > 0       # pages went through the map
    assert COUNTERS.launches() == launches0        # CPU: plain versions only
    assert te._share_model_ok is je._share_model_ok is False
    if case == "chunked":
        assert te.metrics["chunked_prefills"] >= 1


def test_paused_slot_ssm_state_advances_like_the_reference(pair):
    """Reference divergence, kept: under an undersized pool a slot whose
    page growth fails pauses, but its lane still runs a token-0 step
    through ssm_decode (the resident mask only redirects KV writes), so
    its recurrent state advances while paused. Both engines do this;
    their tokens, SSM states and map state stay equal step by step."""
    reqs = [(list(range(1, 9)), 6), (list(range(30, 38)), 12)]
    te, je, rids = _engines(pair, reqs, n_slots=2, max_ctx=64,
                            n_device_blocks=3)
    tdone, jdone = {}, {}
    paused_steps = 0
    for _ in range(40):
        before = {r.slot: int(te.ctx_lens[r.slot])
                  for r in te.active.values()}
        s0 = te.caches["ssm"].clone()
        more = te.step(tdone)
        je.step(jdone)
        _assert_close(te.caches["ssm"], je.caches["ssm"], TOL)
        _assert_map_equal(te, je)
        for slot, ctx in before.items():
            if int(te.ctx_lens[slot]) == ctx and any(
                    r.slot == slot for r in te.active.values()):
                paused_steps += 1
                assert not torch.equal(te.caches["ssm"][:, :, slot],
                                       s0[:, :, slot])
        if not more:
            break
    assert paused_steps > 0
    assert [tdone[t] for t, _ in rids] == [jdone[j] for _, j in rids]
