"""Shared pieces of the port's model-family tests
(``test_torch_families.py``, ``test_torch_moe.py``,
``test_torch_encdec.py``, ``test_torch_vlm.py``) and training tests
(``test_torch_train.py``, ``test_torch_train_families.py``): the JAX /
port model pair at ``smoke_config`` in float32 with the reference's
initialisation loaded through ``convert.params_from_jax`` (for training
with the jitted JAX ``value_and_grad`` of ``loss_fn``), the JAX
engines' shared compiled programs, and the loss-and-gradient check."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_config as j_smoke
from repro.data.pipeline import DataConfig, make_batch
from repro.core.fmmu import batch as JB
from repro.models import Runtime as JRuntime
from repro.models import build_model as j_build
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_arch, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Runtime, build_model
from repro_torch.training.train_loop import to_device, trainable
from repro_torch.training.tree import leaves

# The port's CPU tests run small tensors, where torch's intra-op threads
# only add their spin-waits; under the parallel runner (several workers
# on the same cores) those threads oversubscribe the cores and slow the
# port's tests several times over. Every worker imports this module when
# it collects the tests, so one thread a process holds there.
torch.set_num_threads(1)

TOL = 2e-5
PAGE = 8
# training, float32 on both sides: the loss and every gradient leaf
# agree to summation order (measured ~1e-6 relative); a gradient leaf is
# held within GRAD_TOL of its own largest magnitude
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
SEQ, BATCH = 32, 4


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(jax model, its params, port model, port params, jitted JAX
    prefill, jitted JAX decode_step), one per arch per process."""
    jm = j_build(j_smoke(j_get_arch(arch)),
                 JRuntime(compute_dtype=jnp.float32, param_dtype=jnp.float32,
                          remat="none", page_size=PAGE))
    cfg = smoke_config(get_arch(arch))
    tm = build_model(cfg, Runtime(compute_dtype=torch.float32,
                                  param_dtype=torch.float32, page_size=PAGE),
                     device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, tm, tp, jax.jit(jm.prefill), jax.jit(jm.decode_step)


@functools.lru_cache(maxsize=None)
def train_pair(arch, zloss=0.0, remat="none"):
    """(jitted JAX value_and_grad of loss_fn, JAX params, port model,
    port params) for one smoke configuration, once per process."""
    jm = j_build(j_smoke(j_get_arch(arch)),
                 JRuntime(compute_dtype=jnp.float32, param_dtype=jnp.float32,
                          remat="none", zloss=zloss))
    tm = build_model(smoke_config(get_arch(arch)),
                     Runtime(compute_dtype=torch.float32,
                             param_dtype=torch.float32, remat=remat,
                             zloss=zloss), device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = trainable(params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                   "cpu"))
    vg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    return vg, jp, tm, tp


def train_batch(vocab, pack, seed=0):
    """One reference batch (``make_batch``) of BATCH x SEQ tokens."""
    return make_batch(DataConfig(vocab_size=vocab, seq_len=SEQ,
                                 global_batch=BATCH, pack=pack), seed)


def port_loss_grads(tm, tp, batch):
    """The port's loss, metrics and gradient of every leaf of ``tp``."""
    loss, metrics = tm.loss_fn(tp, to_device(batch, tm.device))
    grads = torch.autograd.grad(loss, leaves(tp), allow_unused=True)
    return loss, metrics, grads


def hold_grads(tgrads, jgrads):
    """Each port gradient leaf (None: zero) within GRAD_TOL of the JAX
    leaf's largest magnitude."""
    jl = jax.tree.leaves(jgrads)
    assert len(tgrads) == len(jl)
    for i, (t, j) in enumerate(zip(tgrads, jl)):
        j = np.asarray(j)
        t = np.zeros_like(j) if t is None else t.detach().numpy()
        scale = max(float(np.abs(j).max()), 1e-12)
        err = float(np.abs(t - j).max())
        assert err <= GRAD_TOL * scale, (i, err, scale)


def hold_loss_and_grads(vg, jp, tm, tp, batch):
    """``loss_fn``'s value, every metric and every gradient leaf of the
    port against ``jax.value_and_grad`` on one host batch (numpy
    arrays); returns the port's metrics."""
    (jloss, jmet), jgrads = vg(jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    loss, metrics, grads = port_loss_grads(tm, tp, batch)
    assert set(metrics) == set(jmet)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmet[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    hold_grads(grads, jgrads)
    return metrics


def _engine_key(eng):
    return (id(eng.m), eng.page, eng.n_slots, eng.max_pages,
            eng.scratch_block, eng.eos_id, eng.channels, eng.kvm.geom)


def share_jax_programs():
    """Make JAX engines of one model and configuration share one set of
    compiled programs: the page manager's jitted map commits are a
    function of its geometry alone (``make_jitted``), prefill and the
    single decode step read only what ``_engine_key`` holds when they
    are traced (so the single-step and K-step engines share them), and
    the K-step programs that and ``macro_k``. Returns the MonkeyPatch
    to undo."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JB, "make_jitted",
               functools.lru_cache(maxsize=None)(JB.make_jitted))
    shared = {}
    init = JServeEngine.__init__

    def shared_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        key = _engine_key(self)
        for name, k in (("_prefill", key), ("_decode", key),
                        ("_macro", key + (self.macro_k,)),
                        ("_macro_simple", key + (self.macro_k,))):
            programs = shared.setdefault(k, {})
            if name in programs:
                setattr(self, name, programs[name])
            else:
                programs[name] = getattr(self, name)
    mp.setattr(JServeEngine, "__init__", shared_init)
    return mp


def close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol,
                               rtol=tol)


def shapes(tree, path=""):
    """{path: shape} of a nested dict/list of arrays or tensors."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in shapes(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in shapes(v, f"{path}/{i}").items()}
    return {path: tuple(tree.shape)}


def emb(seed, n, d):
    """Seeded stub embeddings [n, d], float32: 0.02 * N(0, 1), the scale
    of the reference's test stubs."""
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (n, d))).astype(np.float32)


def teacher_forcing(tm, tp, tokens, n_new, extra):
    """``tests/test_serving.py``'s check on the port: one request served
    greedily through a 2-slot engine, then each output token equal to
    the argmax of a full-sequence prefill over the prompt plus the
    tokens before it (the same embeddings)."""
    from repro_torch.serving import ServeConfig, ServeEngine
    eng = ServeEngine(tm, tp, config=ServeConfig(n_slots=2, max_ctx=64),
                      device="cpu")
    rid = eng.submit(tokens, max_new=n_new, **extra)
    got = eng.run()[rid]
    assert len(got) == n_new
    full = list(tokens) + got
    batch = {k: torch.from_numpy(v)[None] for k, v in extra.items()}
    if "src_emb" in extra:
        batch["src_valid"] = torch.ones((1, len(extra["src_emb"])),
                                        dtype=torch.int32)
    for t in range(n_new):
        batch["tokens"] = torch.tensor(full[:len(tokens) + t])[None]
        logits, _ = tm.prefill(tp, batch)
        assert got[t] == int(torch.argmax(logits[0])), t
    return got
