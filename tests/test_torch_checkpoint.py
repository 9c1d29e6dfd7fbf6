"""The port's checkpoints, data pipeline, straggler monitor and training
launcher against the JAX package on the CPU: the reference's
``tests/test_checkpoint.py`` cases on the port's ``CheckpointManager``,
checkpoints restored across the two packages (every leaf bit-identical,
a full train state of smoke_config(llama3.2-1b)), ``make_batch`` and
``Prefetcher`` equal to the reference's, ``StragglerMonitor`` and
``QuorumPolicy`` on the reference's cases, and ``launch.train``."""
import contextlib
import io
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import Runtime as JRuntime  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.training.straggler import QuorumPolicy as JQuorum  # noqa: E402
from repro.training.straggler import StragglerMonitor as JMonitor  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.straggler import (  # noqa: E402
    QuorumPolicy, StragglerMonitor)
from repro_torch.training.train_loop import TrainerConfig, train  # noqa: E402
from repro_torch.training.tree import leaves  # noqa: E402

RT = Runtime(compute_dtype=torch.float32, param_dtype=torch.float32,
             remat="none")


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)}}


def _specs():
    return {"a": (None, "model"), "b": {"c": (None,)}}


def _equal(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip_and_crc():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        res = mgr.save(3, _tree(), _specs())
        assert res.step == 3 and res.n_leaves == 2
        got, step = mgr.restore(_tree())
        assert step == 3
        _equal(got, _tree())
        with open(os.path.join(d, "step_000000003", "manifest.json")) as f:
            man = json.load(f)
        assert man["leaves"][0]["spec"] == [None, "model"]
        mgr.save(4, _tree())                      # no specs: replicated
        with open(os.path.join(d, "step_000000004", "manifest.json")) as f:
            assert [m["spec"] for m in json.load(f)["leaves"]] == [[], []]


def test_corruption_detected():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, _tree(), _specs())
        path = os.path.join(d, "step_000000001", "arrays", "00000.npy")
        arr = np.load(path)
        arr[0] += 1
        np.save(path, arr)
        with pytest.raises(IOError):
            mgr.restore(_tree())


def test_async_save_and_retention():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep_last=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _tree(), _specs(), async_=True)
            mgr.wait()
        assert mgr.all_steps() == [3, 4]


def test_async_error_raised_at_wait():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        os.makedirs(os.path.join(d, "step_000000002"))
        open(os.path.join(d, "step_000000002.tmp"), "w").close()  # a file
        mgr.save(2, _tree(), async_=True)
        with pytest.raises(OSError):
            mgr.wait()


def test_atomic_commit_no_tmp_left():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(9, _tree(), _specs())
        assert not [n for n in os.listdir(d) if n.endswith(".tmp")]


def _model():
    return build_model(smoke_config(get_arch("llama3.2-1b")), RT,
                       device="cpu")


def test_resume_continues_identically():
    """train(20) equals train(10) -> checkpoint -> restore -> train(10
    more), bit for bit on the CPU."""
    m = _model()
    dcfg = tpipe.DataConfig(vocab_size=m.cfg.vocab_size, seq_len=32,
                            global_batch=4, pack=True)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=5, decay_steps=20)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        state_a, sum_a = train(m, tpipe.data_iter(dcfg, prefetch=False),
                               ocfg, TrainerConfig(total_steps=20,
                                                   log_every=1,
                                                   ckpt_every=0,
                                                   ckpt_dir=d1))
        train(m, tpipe.data_iter(dcfg, prefetch=False), ocfg,
              TrainerConfig(total_steps=10, ckpt_every=10, ckpt_dir=d2,
                            async_ckpt=False))
        it = tpipe.data_iter(dcfg, prefetch=False)
        for _ in range(10):   # the data stream replays deterministically
            next(it)
        state_b, sum_b = train(m, it, ocfg,
                               TrainerConfig(total_steps=20, log_every=1,
                                             ckpt_every=0, ckpt_dir=d2))
        assert sum_b["history"] == sum_a["history"][10:]
        _equal(state_a.tree(), state_b.tree())
        assert int(state_b.opt_state.step) == 20


# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def train_states():
    """A smoke llama train state after one AdamW update (nonzero
    moments, step 1): the reference's and the port's copy of it."""
    jm = j_build(j_smoke(j_get_arch("llama3.2-1b")),
                 JRuntime(compute_dtype=jnp.float32, param_dtype=jnp.float32,
                          remat="none"))
    jp = jm.init(jax.random.key(3))
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), jp)
    jp, js, _ = jopt.adamw_update(jopt.AdamWConfig(), jp, grads,
                                  jopt.init_opt_state(jp))
    jtree = {"params": jp, "opt": js._asdict()}
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jp),
                                  jax.tree.map(np.asarray, js),
                                  smoke_config(get_arch("llama3.2-1b")),
                                  "cpu")
    return jtree, tstate


def _jax_specs(tree):
    return jax.tree.map(lambda _: P(), tree)


def test_jax_checkpoint_restores_in_port(train_states):
    jtree, tstate = train_states
    with tempfile.TemporaryDirectory() as d:
        JManager(d).save(7, jtree, _jax_specs(jtree))
        got, step = CheckpointManager(d).restore(tstate.tree())
        assert step == 7
        for t, j in zip(leaves(got), jax.tree.leaves(jtree)):
            j = np.asarray(j)
            assert t.numpy().dtype == j.dtype and t.shape == j.shape
            assert t.numpy().tobytes() == j.tobytes()


def test_port_checkpoint_restores_in_jax(train_states):
    jtree, tstate = train_states
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(5, tstate.tree())
        got, step = JManager(d).restore(jtree)
        assert step == 5
        for j, t in zip(jax.tree.leaves(got), leaves(tstate.tree())):
            j = np.asarray(j)
            assert j.dtype == t.detach().numpy().dtype
            assert j.tobytes() == t.detach().numpy().tobytes()
        with open(os.path.join(d, "step_000000005", "manifest.json")) as f:
            man = json.load(f)
        assert len(man["leaves"]) == len(jax.tree.leaves(jtree))


# ----------------------------------------------------------------------
DATA_CASES = {
    "packed": dict(vocab_size=512, seq_len=128, global_batch=4),
    "unpacked": dict(vocab_size=512, seq_len=64, global_batch=4,
                     pack=False),
    "host1_of_2": dict(vocab_size=512, seq_len=64, global_batch=8,
                       host_count=2, host_index=1),
    "llama_vocab": dict(vocab_size=128256, seq_len=256, global_batch=2,
                        seed=3),
}


@pytest.mark.parametrize("case", sorted(DATA_CASES))
def test_make_batch_equals_reference(case):
    kw = DATA_CASES[case]
    for step in (0, 7):
        want = jpipe.make_batch(jpipe.DataConfig(**kw), step)
        got = tpipe.make_batch(tpipe.DataConfig(**kw), step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_equals_reference():
    kw = dict(vocab_size=256, seq_len=32, global_batch=2, prefetch=2)
    pre = tpipe.Prefetcher(tpipe.DataConfig(**kw), start_step=2)
    got = [next(pre) for _ in range(3)]
    pre.close()
    for i, g in enumerate(got):
        want = jpipe.make_batch(jpipe.DataConfig(**kw), 2 + i)
        for k in want:
            np.testing.assert_array_equal(g[k], want[k])
    gen = tpipe.data_iter(tpipe.DataConfig(**kw), prefetch=False)
    np.testing.assert_array_equal(
        next(gen)["tokens"], jpipe.make_batch(jpipe.DataConfig(**kw),
                                              0)["tokens"])


# ----------------------------------------------------------------------
def test_straggler_monitor_matches_reference():
    """The reference's injected-delay case, and a noisy stream with
    spikes recorded by both monitors: equal flags, EWMA and events."""
    mons = (StragglerMonitor(k_sigma=3.0, warmup=3),
            JMonitor(k_sigma=3.0, warmup=3))
    for mon in mons:
        for i in range(20):
            mon.record(i, 0.10 + 0.001 * (i % 3))
        assert not mon.events
        assert mon.record(20, 0.50, host=7)
        assert mon.events[0].host == 7 and mon.ewma < 0.12
    rng = np.random.default_rng(0)
    a, b = StragglerMonitor(), JMonitor()
    for i in range(200):
        dt = float(rng.gamma(4.0, 0.025) + (0.5 if i % 37 == 36 else 0.0))
        assert a.record(i, dt, host=i % 3) == b.record(i, dt, host=i % 3)
    assert a.ewma == b.ewma and a.var == b.var and a.mean() == b.mean()
    assert [vars(e) for e in a.events] == [vars(e) for e in b.events]
    assert a.events


def test_quorum_policy_matches_reference():
    for cls in (QuorumPolicy, JQuorum):
        q = cls(n_hosts=10, quorum=0.9)
        assert q.decide(0, list(range(10)))
        assert q.decide(1, list(range(9)))
        assert q.skipped == [(1, [9])]
        assert not q.decide(2, list(range(5)))


# ----------------------------------------------------------------------
def test_launch_train_smoke_cpu():
    with tempfile.TemporaryDirectory() as d:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            state, summary = launch_train.main(
                ["--arch", "llama3.2-1b", "--smoke", "--steps", "3",
                 "--batch", "2", "--seq", "32", "--device", "cpu",
                 "--fp32", "--log-every", "1", "--ckpt-dir", d])
        last = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert set(last) == {"final_loss", "first_loss", "mean_step_s",
                             "stragglers"}
        assert np.isfinite(last["final_loss"])
        assert CheckpointManager(d).latest_step() == 3
    with pytest.raises(NotImplementedError):
        launch_train.main(["--arch", "llama3.2-1b", "--smoke", "--tp", "2",
                           "--device", "cpu"])
