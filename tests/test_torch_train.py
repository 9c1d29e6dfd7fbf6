"""The port's training path against the JAX package, on the CPU in
float32 at ``smoke_config`` size, with the reference's initialisation
loaded through ``convert``: ``Model.loss_fn`` (value, metrics and every
gradient leaf against ``jax.value_and_grad``), AdamW and its schedule,
``make_train_step`` over three steps, gradient accumulation, the remat
policies, the reference's learning test, and the flash attention
backward's plain version (and the autograd Function that carries the
CUDA kernel) against autograd and ``jax.grad``. One jitted JAX
``value_and_grad`` per model configuration serves the module."""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import Runtime as JRuntime  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train_loop import TrainState as JTrainState  # noqa: E402
from repro.training.train_loop import make_train_step as j_make  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.data.pipeline import data_iter  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    TrainerConfig, TrainState, make_train_step, to_device, train, trainable)
from repro_torch.training.tree import leaves  # noqa: E402

from _torch_pairs import BATCH, GRAD_TOL, LOSS_RTOL, SEQ  # noqa: E402
from _torch_pairs import hold_loss_and_grads, port_loss_grads  # noqa: E402
from _torch_pairs import train_batch as _batch  # noqa: E402
from _torch_pairs import train_pair as _pair  # noqa: E402

@pytest.mark.parametrize("arch,pack,zloss", [
    ("llama3.2-1b", True, 0.0), ("llama3.2-1b", False, 0.0),
    ("gemma2-9b", True, 0.0), ("llama3.2-1b", True, 1e-4)])
def test_loss_and_grads_match_jax(arch, pack, zloss):
    vg, jp, tm, tp = _pair(arch, zloss)
    metrics = hold_loss_and_grads(vg, jp, tm, tp,
                                  _batch(tm.cfg.vocab_size, pack))
    if zloss:
        assert float(metrics["zloss"]) > 0


def test_moe_loss_and_aux_match_jax():
    """dbrx-132b's loss and aux_loss values (the MoE aux loss that the
    stack now returns)."""
    vg, jp, tm, tp = _pair("dbrx-132b")
    batch = _batch(tm.cfg.vocab_size, True)
    (jloss, jmet), _ = vg(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        loss, metrics = tm.loss_fn(tp, to_device(batch, tm.device))
    assert float(jmet["aux_loss"]) > 0
    for k in ("loss", "nll", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


# ----------------------------------------------------------------------
def _opt_trees(rng):
    shapes = {"w": (3, 4), "b": (4,), "s": [{"x": (2, 2, 3)}, {"x": (5,)}]}

    def draw(scale):
        def one(s):
            if isinstance(s, dict):
                return {k: one(v) for k, v in s.items()}
            if isinstance(s, list):
                return [one(v) for v in s]
            return (scale * rng.standard_normal(s)).astype(np.float32)
        return one(shapes)
    return draw(1.0), [draw(3.0) for _ in range(5)]


def test_adamw_and_schedule_match_jax():
    """Five AdamW steps with clipping active (every gradient's norm
    above grad_clip) and weight decay on the >= 2-D leaves; lr and
    grad_norm each step, params and moments at the end, within 1e-6."""
    cfg = dict(lr=0.05, warmup_steps=2, decay_steps=4, grad_clip=1.0,
               weight_decay=0.1)
    p_np, g_nps = _opt_trees(np.random.default_rng(0))
    jcfg, tcfg = jopt.AdamWConfig(**cfg), opt.AdamWConfig(**cfg)
    jupdate = jax.jit(functools.partial(jopt.adamw_update, jcfg))
    jp = jax.tree.map(jnp.asarray, p_np)
    js = jopt.init_opt_state(jp)
    tp = params_from_tree(p_np)
    ts = opt.init_opt_state(tp)
    for g_np in g_nps:
        jp, js, jm = jupdate(jp, jax.tree.map(jnp.asarray, g_np), js)
        tp, ts, tm = opt.adamw_update(tcfg, tp, params_from_tree(g_np), ts)
        assert float(jm["grad_norm"]) > cfg["grad_clip"]
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5
    for t, j in zip(leaves([tp, ts.mu, ts.nu]),
                    jax.tree.leaves([jp, js.mu, js.nu])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)
    for s in range(0, 7):
        np.testing.assert_allclose(float(opt.schedule(tcfg, s)),
                                   float(jopt.schedule(jcfg, s)), rtol=1e-6)


def params_from_tree(tree):
    if isinstance(tree, dict):
        return {k: params_from_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True))


def test_adamw_reference_math():
    """``tests/test_training.py``'s AdamW case on the port."""
    cfg = opt.AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8,
                          weight_decay=0.0, grad_clip=0.0,
                          warmup_steps=0, decay_steps=10 ** 9)
    params = {"w": torch.tensor([1.0, 2.0])}
    p2, _, _ = opt.adamw_update(cfg, params, {"w": torch.tensor([0.5, -0.5])},
                                opt.init_opt_state(params))
    mhat = 0.1 * 0.5 / (1 - 0.9)
    vhat = 0.01 * 0.25 / (1 - 0.99)
    want = 1.0 - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(float(p2["w"][0]), want, rtol=1e-5)


# ----------------------------------------------------------------------
# the near-zero elements' share, measured on the CPU: 4.3% of the tied
# embedding (the head's gradient on rare tokens' rows), <= 0.28% of every
# other leaf, 1.6% of all; the caps are a small multiple of those
NEAR_ZERO_SHARE = 0.1
NEAR_ZERO_TOTAL = 0.05


def _near_zero(grads):
    """Per leaf, the elements whose gradient is nonzero but within
    GRAD_TOL of the leaf's largest magnitude: the gradient check cannot
    tell them from zero."""
    out = []
    for g in grads:
        a = np.abs(g)
        out.append((a > 0) & (a <= GRAD_TOL * a.max()))
    return out


def test_train_step_three_steps_match_jax():
    """Both packages' make_train_step from one state over three packed
    batches: each step's loss within 1e-5 relative, the final params
    within 1e-4 of each leaf's largest magnitude. AdamW's first steps
    are sign-like: where a gradient is nonzero but below GRAD_TOL of its
    leaf's largest (in either package, at any step; the gradient check
    cannot tell it from zero), its roundoff can move the weight by up to
    2 lr a step, and such an element is held at that bound instead. Each
    step's gradients come from one more ``value_and_grad`` of each
    package on the state the step starts from; those elements must stay
    a small share of their leaf, so a fault cannot hide under it."""
    cfg = dict(lr=1e-3, warmup_steps=1, decay_steps=10)
    vg, jp0, tm, _ = _pair("llama3.2-1b")
    jm = j_build(j_smoke(j_get_arch("llama3.2-1b")),
                 JRuntime(compute_dtype=jnp.float32, param_dtype=jnp.float32,
                          remat="none"))
    jstep, _, _ = j_make(jm, jopt.AdamWConfig(**cfg))
    jstep = jax.jit(jstep)
    jstate = JTrainState(jp0, jopt.init_opt_state(jp0))
    tstate = train_state_from_jax(
        jax.tree.map(np.asarray, jp0),
        jax.tree.map(np.asarray, jstate.opt_state), tm.cfg, "cpu")
    tstep, _ = make_train_step(tm, opt.AdamWConfig(**cfg))
    near, lr_sum = None, 0.0
    for s in range(3):
        batch = _batch(tm.cfg.vocab_size, True, seed=s)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jg = [np.asarray(g) for g in jax.tree.leaves(vg(jstate.params,
                                                        jbatch)[1])]
        tg = [np.zeros_like(j) if t is None else t.detach().numpy()
              for t, j in zip(port_loss_grads(tm, tstate.params, batch)[2],
                              jg)]
        step_near = [a | b for a, b in zip(_near_zero(jg), _near_zero(tg))]
        near = step_near if near is None else [
            a | b for a, b in zip(near, step_near)]
        jstate, jmet = jstep(jstate, jbatch)
        tstate, tmet = tstep(tstate, batch)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                                   rtol=1e-6)
        lr_sum += float(jmet["lr"])
    n_near = n_all = 0
    for i, (t, j, nz) in enumerate(zip(leaves(tstate.params),
                                       jax.tree.leaves(jstate.params), near)):
        j = np.asarray(j)
        err = np.abs(t.detach().numpy() - j)
        n_near += int(nz.sum())
        n_all += nz.size
        assert nz.mean() <= NEAR_ZERO_SHARE, (i, float(nz.mean()))
        assert err[~nz].max(initial=0.0) <= 1e-4 * np.abs(j).max(), i
        assert err[nz].max(initial=0.0) <= 2 * lr_sum, i
    assert n_near <= NEAR_ZERO_TOTAL * n_all, n_near / n_all
    assert int(tstate.opt_state.step) == int(jstate.opt_state.step) == 3


def _fresh(tm, seed=0):
    return trainable(tm.init(torch.Generator().manual_seed(seed)))


def test_grad_accum_equivalence():
    """``tests/test_training.py``'s case on the port: one step of 4
    micro-batches equals one of the whole batch within 2e-5."""
    tm = _pair("llama3.2-1b")[2]
    cfg = opt.AdamWConfig(lr=1e-3, grad_clip=0.0, weight_decay=0.0)
    batch = make_batch(DataConfig(vocab_size=tm.cfg.vocab_size, seq_len=32,
                                  global_batch=8, pack=False), 0)
    outs = []
    for ga in (1, 4):
        step, _ = make_train_step(tm, cfg, grad_accum=ga)
        params = _fresh(tm)
        st, _ = step(opt_state_of(params), batch)
        outs.append(st.params)
    for a, b in zip(leaves(outs[0]), leaves(outs[1])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("ga", [1, 2])
def test_train_step_phase_marks(ga):
    """``on_phase`` marks the step's phases in order (forward and
    backward once a micro-batch, then optimizer and end), and a step
    with the hook equals one without it bit for bit."""
    tm = _pair("llama3.2-1b")[2]
    cfg = opt.AdamWConfig(lr=1e-3)
    batch = make_batch(DataConfig(vocab_size=tm.cfg.vocab_size, seq_len=32,
                                  global_batch=4, pack=False), 0)
    marks, outs = [], []
    for hook in (None, marks.append):
        step, _ = make_train_step(tm, cfg, grad_accum=ga, on_phase=hook)
        st, met = step(opt_state_of(_fresh(tm)), batch)
        outs.append((st.params, float(met["loss"])))
    assert marks == ["forward", "backward"] * ga + ["optimizer", "end"]
    assert outs[0][1] == outs[1][1]
    for a, b in zip(leaves(outs[0][0]), leaves(outs[1][0])):
        assert torch.equal(a, b)


def opt_state_of(params):
    return TrainState(params, opt.init_opt_state(params))


class _MMCount(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_same_loss_and_grads():
    """'none', 'dots' and 'full' give the same loss and gradients (bit
    for bit on the CPU: the same ops recomputed); the backward pass of
    'dots' runs as many weight products as 'none' (they were saved)
    and 'full' more (the forward's are recomputed)."""
    batch = _batch(512, True)
    out, mms = {}, {}
    for remat in ("none", "dots", "full"):
        tm = build_model(smoke_config(get_arch("llama3.2-1b")),
                         Runtime(compute_dtype=torch.float32, remat=remat),
                         device="cpu")
        tp = _fresh(tm)
        loss, _ = tm.loss_fn(tp, to_device(batch, tm.device))
        with _MMCount() as c:
            grads = torch.autograd.grad(loss, leaves(tp))
        out[remat], mms[remat] = (loss, grads), c.n
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)
    assert mms["dots"] == mms["none"] < mms["full"]


def test_remat_recomputes_the_encoder_stack():
    """seamless's encoder stack is rematerialised like its decoder
    stack, as the reference checkpoints every scanned body: its input
    (the source frames) needs no gradient but its weights do. Under
    'full' the backward pass runs every weight product of both stacks
    again (with the recomputation's early stop off), so its products
    exceed 'none''s by all of the forward's but the head's one; the
    loss and gradients stay bit-equal."""
    cfg = smoke_config(get_arch("seamless-m4t-large-v2"))
    rng = np.random.default_rng(0)
    batch = _batch(cfg.vocab_size, False)
    batch["src_emb"] = (0.02 * rng.standard_normal(
        (BATCH, 12, cfg.d_model))).astype(np.float32)
    batch["src_valid"] = np.ones((BATCH, 12), np.int32)
    out, mms = {}, {}
    for remat in ("none", "full"):
        tm = build_model(cfg, Runtime(compute_dtype=torch.float32,
                                      remat=remat), device="cpu")
        tp = _fresh(tm)
        with _MMCount() as fwd, \
                torch.utils.checkpoint.set_checkpoint_early_stop(False):
            loss, _ = tm.loss_fn(tp, to_device(batch, tm.device))
        with _MMCount() as c:
            grads = torch.autograd.grad(loss, leaves(tp))
        out[remat], mms[remat] = (loss, grads), c.n
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(out["full"][1], out["none"][1]):
        assert torch.equal(a, b)
    assert mms["full"] - mms["none"] == fwd.n - 1


def test_loss_decreases_60_steps():
    """``tests/test_training.py``'s learning test on the port."""
    tm = _pair("llama3.2-1b")[2]
    dcfg = DataConfig(vocab_size=tm.cfg.vocab_size, seq_len=64,
                      global_batch=8, pack=False)
    _, summary = train(
        tm, data_iter(dcfg, prefetch=False),
        opt.AdamWConfig(lr=1e-2, weight_decay=0.0, warmup_steps=10,
                        decay_steps=100),
        TrainerConfig(total_steps=60, log_every=10, ckpt_every=0))
    hist = summary["history"]
    assert hist[-1][1] < hist[0][1] - 1.0, f"no learning: {hist}"


# ----------------------------------------------------------------------
# the flash attention backward's plain version
BWD_CASES = {
    "causal": dict(h=4, kv=4, sq=24, skv=24, kw=dict()),
    "window": dict(h=4, kv=2, sq=24, skv=24, kw=dict(window=5)),
    "softcap": dict(h=4, kv=2, sq=24, skv=24, kw=dict(softcap=3.0)),
    "packed": dict(h=4, kv=1, sq=24, skv=24, kw=dict(), segs=True),
    "bidirectional": dict(h=2, kv=1, sq=16, skv=24,
                          kw=dict(causal=False, bidirectional=True)),
    "gqa_g2_window_softcap": dict(h=4, kv=2, sq=20, skv=20,
                                  kw=dict(window=7, softcap=2.0), segs=True),
    "no_key_rows": dict(h=4, kv=2, sq=24, skv=16, kw=dict()),
}
BWD_TOL = 2e-5      # float32, summation order
# head_dim 256 (gemma2's): the blocked walk at the eight-warp bodies'
# tiles (64-row blocks over 32-row tiles), S crossing the 32- and 64-row
# edges and a multiple of the JAX blocked lowering's chunk (24 here)
WIDE_TILES = (64, 32)
WIDE_CASES = {
    "d256_window": dict(h=2, kv=2, sq=72, skv=72, kw=dict(window=24)),
    "d256_softcap": dict(h=2, kv=2, sq=72, skv=72, kw=dict(softcap=2.0)),
    "d256_gqa_g2": dict(h=4, kv=2, sq=72, skv=72, kw=dict()),
    "d256_packed": dict(h=2, kv=1, sq=72, skv=72, kw=dict(), segs=True),
    "d256_sq_ne_skv": dict(h=2, kv=1, sq=48, skv=72, kw=dict(window=28)),
}
WIDE_TOL = 1e-4     # float32 at head_dim 256


def _bwd_inputs(case, seed=0):
    c = BWD_CASES.get(case) or WIDE_CASES[case]
    b, d = (1, 256) if case in WIDE_CASES else (2, 16)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, c["sq"], c["h"], d)).astype(np.float32)
    k = rng.standard_normal((b, c["skv"], c["kv"], d)).astype(np.float32)
    v = rng.standard_normal((b, c["skv"], c["kv"], d)).astype(np.float32)
    do = rng.standard_normal(q.shape).astype(np.float32)
    segs = None
    if c.get("segs"):
        ids = np.cumsum(rng.random((b, c["skv"])) < 0.2, axis=1)
        segs = (ids.astype(np.int32), ids.astype(np.int32))
    # rows with no valid key (causal rows before the first key): the
    # port gives 0 there and the jnp oracle the mean of v; their dout is
    # zeroed so both backward passes agree on every other gradient
    qpos = np.arange(c["sq"]) + c["skv"] - c["sq"]
    causal = c["kw"].get("causal", True)
    if causal:
        do[:, qpos < 0] = 0.0
    return q, k, v, do, segs, c["kw"]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _autograd_ref(q, k, v, do, segs, kw):
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    sg = None if segs is None else tuple(_t(s) for s in segs)
    out = ref.attention_naive(qt, kt, vt, segment_ids=sg, **kw)
    return torch.autograd.grad(out, (qt, kt, vt), _t(do))


@functools.lru_cache(maxsize=None)
def _jax_bwd(name, kw_items, chunk=8):
    """Jitted (q, k, v, dout, segs) -> (dq, dk, dv) of the reference's
    ``name`` (the blocked lowering in chunks of ``chunk``)."""
    fn = getattr(jref, name)
    if name == "flash_attention_blocked":
        fn = functools.partial(fn, q_chunk=chunk, kv_chunk=chunk)
    kw = dict(kw_items)

    def grads(q, k, v, do, segs):
        _, pull = jax.vjp(lambda a, b, c: fn(a, b, c, segment_ids=segs,
                                             **kw), q, k, v)
        return pull(do)
    return jax.jit(grads)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_ref_matches_autograd_and_jax(case):
    q, k, v, do, segs, kw = _bwd_inputs(case)
    sg = None if segs is None else tuple(_t(s) for s in segs)
    out, lse = ref.attention_lse(_t(q), _t(k), _t(v), segment_ids=sg, **kw)
    got = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse, _t(do),
                                      segment_ids=sg, **kw)
    want = _autograd_ref(q, k, v, do, segs, kw)
    jsegs = None if segs is None else tuple(jnp.asarray(s) for s in segs)
    for name in ("attention_naive", "flash_attention_blocked"):
        pulled = _jax_bwd(name, tuple(sorted(kw.items())))(
            *map(jnp.asarray, (q, k, v, do)), jsegs)
        for g, j, t in zip(got, pulled, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(j),
                                       atol=BWD_TOL, rtol=BWD_TOL)
            np.testing.assert_allclose(g.numpy(), t.numpy(),
                                       atol=BWD_TOL, rtol=BWD_TOL)
    if case == "no_key_rows":
        dead = np.arange(q.shape[1]) + k.shape[1] - q.shape[1] < 0
        assert torch.isinf(lse[:, :, dead]).all()
        assert not got[0][:, dead].abs().sum()
        assert not out[:, dead].abs().sum()


@pytest.mark.parametrize("case", sorted(BWD_CASES) + sorted(WIDE_CASES))
def test_flash_bwd_blocked_matches_reference(case):
    """The kernels' tile walk (``flash_attention_bwd_blocked``: causal
    frontier, window and the ids' span skip; tiles of 8 rows, and at
    head_dim 256 the eight-warp bodies' 64-row blocks over 32-row
    tiles) against ``jax.vjp`` of the reference's ``attention_naive``
    and ``flash_attention_blocked`` (only the blocked lowering at head
    dim 256) and against ``flash_attention_bwd_ref``, on the same (out,
    lse)."""
    q, k, v, do, segs, kw = _bwd_inputs(case)
    sg = None if segs is None else tuple(_t(s) for s in segs)
    args = (_t(q), _t(k), _t(v)) + ref.attention_lse(
        _t(q), _t(k), _t(v), segment_ids=sg, **kw) + (_t(do),)
    wide = case in WIDE_CASES
    tol = WIDE_TOL if wide else BWD_TOL
    got = ref.flash_attention_bwd_blocked(
        *args, segment_ids=sg, tiles=WIDE_TILES if wide else (8, 8), **kw)
    want = ref.flash_attention_bwd_ref(*args, segment_ids=sg, **kw)
    jsegs = None if segs is None else tuple(jnp.asarray(s) for s in segs)
    names = ("flash_attention_blocked",) if wide else (
        "attention_naive", "flash_attention_blocked")
    for name in names:
        pulled = _jax_bwd(name, tuple(sorted(kw.items())),
                          24 if wide else 8)(
            *map(jnp.asarray, (q, k, v, do)), jsegs)
        for g, j, t in zip(got, pulled, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(j),
                                       atol=tol, rtol=tol)
            np.testing.assert_allclose(g.numpy(), t.numpy(),
                                       atol=tol, rtol=tol)


# the backward kernels' walks: (query tile rows, key tile rows, which
# side walks): "dq" walks key tiles from each query tile (the causal /
# window key range), "dkdv" walks query tiles from each key tile (the
# query range)
SPAN_WALKS = {
    "square": [(t, t, side) for t in (4, 8, 32, 64)
               for side in ("dq", "dkdv")],
    # head_dim 256: 64-row blocks over 32-row tiles
    "d256": [(64, 32, "dq"), (32, 64, "dkdv")],
}


@pytest.mark.parametrize("route", sorted(SPAN_WALKS))
@pytest.mark.parametrize("ids", ["packed", "shuffled"])
@pytest.mark.parametrize("mask", ["causal", "window", "bidirectional"])
def test_span_skip_never_drops_a_visible_pair(ids, mask, route):
    """The kernels' tile skip is conservative: for seeded packed
    (nondecreasing) and shuffled ids, under causal, windowed and
    bidirectional masks, at Sq == Skv and Sq != Skv and each walk of
    the route (square tiles of 4 / 8 / 32 / 64 rows; at head_dim 256
    the 64-row blocks over 32-row tiles), every (query tile, key tile)
    pair that holds a visible pair has spans that meet and lies in the
    walk's causal / window range (``_tile_key_range`` from a query
    tile, ``_tile_query_range`` from a key tile); with packed ids the
    skip drops tile pairs."""
    kw = {"causal": dict(), "window": dict(window=9),
          "bidirectional": dict(causal=False, bidirectional=True)}[mask]
    causal, window = kw.get("causal", True), kw.get("window", 0)
    rng = np.random.default_rng(5)
    dropped = 0
    for sq, skv in ((96, 96), (40, 96), (96, 40), (130, 130)):
        s = max(sq, skv)
        seg = np.cumsum(rng.random((3, s)) < 0.08, axis=1).astype(np.int32)
        if ids == "shuffled":
            seg = rng.permuted(seg, axis=1)
        seg_q, seg_k = _t(seg[:, :sq]), _t(seg[:, :skv])
        _, _, vis = ref._attention_logits(
            torch.zeros((3, sq, 1, 4)), torch.zeros((3, skv, 1, 4)),
            causal=causal, window=window, softcap=0.0,
            segment_ids=(seg_q, seg_k),
            bidirectional=kw.get("bidirectional", False))
        vis = vis[:, 0]                                     # [B,Sq,Skv]
        for tq, tk, side in SPAN_WALKS[route]:
            nq, nk = -(-sq // tq), -(-skv // tk)
            pad = torch.nn.functional.pad(
                vis, (0, nk * tk - skv, 0, nq * tq - sq))
            held = pad.reshape(3, nq, tq, nk, tk).any(4).any(2)
            meet = ref.spans_meet(ref.tile_spans(seg_q, tq)[:, :, None],
                                  ref.tile_spans(seg_k, tk)[:, None, :])
            assert not (held & ~meet).any(), (sq, skv, tq, tk)
            if side == "dq":
                for qt in range(nq):
                    keys = ref._tile_key_range(
                        qt * tq, min(sq, (qt + 1) * tq), sq, skv, tk,
                        causal, window)
                    outside = [kt for kt in range(nk) if kt not in keys]
                    assert not held[:, qt, outside].any(), (sq, skv, tq, qt)
            else:
                for kt in range(nk):
                    rows = ref._tile_query_range(
                        kt * tk, min(skv, (kt + 1) * tk), sq, skv, tq,
                        causal, window)
                    outside = [qt for qt in range(nq) if qt not in rows]
                    assert not held[:, outside, kt].any(), (sq, skv, tk, kt)
            dropped += int((~meet).sum())
    assert dropped > 0 or ids == "shuffled"


@pytest.mark.parametrize("case", ["causal", "gqa_g2_window_softcap",
                                  "no_key_rows"])
def test_flash_attention_fn_plain(case):
    """The autograd Function that carries the CUDA kernels, driven with
    the plain forward and backward, against autograd of
    ``attention_naive``: output and (dq, dk, dv)."""
    q, k, v, do, segs, kw = _bwd_inputs(case, seed=1)
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    sq, sk = (None, None) if segs is None else tuple(_t(s) for s in segs)
    opts = dict(causal=kw.get("causal", True), window=kw.get("window", 0),
                softcap=kw.get("softcap", 0.0),
                bidirectional=kw.get("bidirectional", False))
    out = fa.FlashAttentionFn.apply(qt, kt, vt, sq, sk, opts, fa._plain_fwd,
                                    fa.flash_attention_bwd_ref)
    got = torch.autograd.grad(out, (qt, kt, vt), _t(do))
    sg = None if segs is None else (sq, sk)
    torch.testing.assert_close(
        out, ref.attention_naive(_t(q), _t(k), _t(v), segment_ids=sg, **kw),
        atol=0, rtol=0)
    for g, w in zip(got, _autograd_ref(q, k, v, do, segs, kw)):
        torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=BWD_TOL)


def test_flash_bwd_wrapper_on_cpu_is_plain():
    """On CPU tensors ``flash_attention_bwd`` is the plain version and
    launches nothing; the lse of a masked-softcap row is finite."""
    from repro_torch.core.counters import COUNTERS
    q, k, v, do, _, kw = _bwd_inputs("softcap")
    out, lse = ref.attention_lse(_t(q), _t(k), _t(v), **kw)
    assert torch.isfinite(lse).all()
    before = COUNTERS.launches()
    a = fa.flash_attention_bwd(_t(q), _t(k), _t(v), out, lse, _t(do), **kw)
    b = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse, _t(do),
                                    **kw)
    assert COUNTERS.launches() == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    _, logits, mask = ref._attention_logits(
        _t(q), _t(k), causal=True, window=0, softcap=kw["softcap"],
        segment_ids=None, bidirectional=False)
    want = torch.logsumexp(logits.masked_fill(~mask, -math.inf), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)
