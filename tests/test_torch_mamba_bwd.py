"""The Mamba2 scan's gradient on the CPU: the port's plain versions of
the backward kernel's function, ``mamba_chunk_scan_bwd_ref`` (autograd
through the naive scan) and ``mamba_chunk_scan_bwd_blocked`` (the
kernel's passes: chunk-local states, the passing, chunk-local gradients
with dB and dC summed over groups of heads), against each other and
against ``jax.vjp`` through the reference's ``ref.mamba_chunk_scan_blocked``
and ``ref.mamba_chunk_scan_naive``, in float32 at small shapes: d_state
16, with and without an initial state, a zero and a nonzero cotangent
of the final state, S a multiple of the chunk and not, dt in
``init_ssm``'s range and ten times it; and at the tensor-core body's
chunk of 64 (and 128) with more than one group of heads, the last one
partial. Each gradient is held within 1e-4 of its own largest
magnitude. Also ``MambaChunkScanFn`` driven with the plain versions
(against autograd of the plain forward, and ``torch.autograd.gradcheck``
at a tiny float64 shape) and ``ops.mamba_chunk_scan`` on the CPU
differentiating the plain version. Inputs come from a numpy seed."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

GRAD_TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinitial_state")


def _inputs(seed, bt, s, h, p, n, init, dfinal, dt_scale=1.0):
    """numpy float32 (x, dt, A, B, C, D, dy, dfinal, s0); dt =
    softplus(0.5 N(0,1) + bias) around a per-head rate log-uniform in
    [0.001, 0.1] (``init_ssm``'s dt_bias), times ``dt_scale``; A =
    -exp(log(1 + 15 U)) as ``init_ssm`` draws A_log."""
    rng = np.random.default_rng(seed)
    dt0 = dt_scale * np.exp(rng.random(h) * (math.log(0.1) - math.log(1e-3))
                            + math.log(1e-3))
    bias = dt0 + np.log(-np.expm1(-dt0))
    z = 0.5 * rng.standard_normal((bt, s, h)) + bias
    dt = np.logaddexp(z, 0.0)
    a = -np.exp(np.log(1.0 + 15.0 * rng.random(h)))
    d = 1.0 + 0.1 * rng.standard_normal(h)
    x = rng.standard_normal((bt, s, h, p))
    b = rng.standard_normal((bt, s, n))
    c = rng.standard_normal((bt, s, n))
    dy = rng.standard_normal((bt, s, h, p))
    df = rng.standard_normal((bt, h, p, n)) if dfinal else None
    s0 = rng.standard_normal((bt, h, p, n)) if init else None
    return tuple(None if v is None else np.asarray(v, np.float32)
                 for v in (x, dt, a, b, c, d, dy, df, s0))


def _torch(arrs):
    return tuple(None if a is None else torch.from_numpy(a.copy())
                 for a in arrs)


def _jax_grads(fn, arrs, chunk):
    """(dx, ddt, dA, dB, dC, dD, ds0) of ``fn`` (a reference scan) by
    jax.vjp with cotangents (dy, dfinal or 0)."""
    x, dt, a, b, c, d, dy, df, s0 = (None if v is None else jnp.asarray(v)
                                     for v in arrs)
    prim = (x, dt, a, b, c, d) + ((s0,) if s0 is not None else ())

    def f(*args):
        init = args[6] if len(args) > 6 else None
        return fn(*args[:6], chunk=chunk, initial_state=init)
    (y, fin), vjp = jax.vjp(f, *prim)
    cot = (dy, df if df is not None else jnp.zeros_like(fin))
    g = vjp(cot)
    return tuple(np.asarray(v) for v in g) + \
        ((None,) if s0 is None else ())


def _hold(got, want, tag):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, (tag, name)
            continue
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else w
        assert g.shape == w.shape, (tag, name, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale, (tag, name, err, scale)


CASES = [  # (bt, s, h, p, n, chunk, init, dfinal, dt_scale)
    (2, 64, 3, 8, 16, 32, False, False, 1.0),
    (2, 64, 3, 8, 16, 16, True, True, 1.0),
    (1, 50, 2, 4, 16, 32, True, False, 1.0),
    (2, 45, 2, 16, 16, 16, False, True, 10.0),
    (1, 7, 2, 4, 16, 32, True, True, 1.0),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_bwd_plain_versions_match_jax(case):
    """Both plain versions against the reference's scans under jax.vjp:
    its blocked lowering where S is a multiple of the chunk (which it
    falls back from to the naive scan otherwise) and its naive scan."""
    bt, s, h, p, n, chunk, init, dfinal, dts = case
    arrs = _inputs(CASES.index(case), bt, s, h, p, n, init, dfinal, dts)
    x, dt, a, b, c, d, dy, df, s0 = _torch(arrs)
    ref = tref.mamba_chunk_scan_bwd_ref(x, dt, a, b, c, d, dy, df,
                                        initial_state=s0)
    blocked = tref.mamba_chunk_scan_bwd_blocked(
        x, dt, a, b, c, d, dy, df, initial_state=s0, chunk=chunk)
    _hold(blocked, ref, "blocked vs ref")
    for fn in (jref.mamba_chunk_scan_blocked, jref.mamba_chunk_scan_naive):
        want = _jax_grads(fn, arrs, chunk)
        _hold(ref, want, f"ref vs {fn.__name__}")
        _hold(blocked, want, f"blocked vs {fn.__name__}")


GROUP_CASES = [  # (bt, s, h, p, n, chunk, init, dfinal, dt_scale)
    (1, 128, 10, 4, 16, 64, True, True, 1.0),
    (2, 100, 17, 4, 16, 64, False, True, 10.0),
    (1, 256, 9, 4, 16, 128, True, False, 1.0),
    (1, 70, 9, 4, 32, 64, True, True, 1.0),
]


@pytest.mark.parametrize("case", GROUP_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_bwd_kernel_chunks_and_head_groups_match_jax(case):
    """The blocked version at the tensor-core body's chunk (64; 128 as
    the forward's) with dB and dC summed over groups of eight heads (two
    or three groups, the last one partial) against jax.vjp through the
    reference's blocked lowering (where S is a multiple of the chunk)
    and naive scan, and against ``mamba_chunk_scan_bwd_ref``."""
    bt, s, h, p, n, chunk, init, dfinal, dts = case
    assert h > tref.SCAN_BWD_GROUP
    arrs = _inputs(20 + GROUP_CASES.index(case), bt, s, h, p, n, init,
                   dfinal, dts)
    x, dt, a, b, c, d, dy, df, s0 = _torch(arrs)
    got = tref.mamba_chunk_scan_bwd_blocked(
        x, dt, a, b, c, d, dy, df, initial_state=s0, chunk=chunk)
    ref = tref.mamba_chunk_scan_bwd_ref(x, dt, a, b, c, d, dy, df,
                                        initial_state=s0)
    _hold(got, ref, "blocked vs ref")
    for fn in (jref.mamba_chunk_scan_blocked, jref.mamba_chunk_scan_naive):
        _hold(got, _jax_grads(fn, arrs, chunk), f"blocked vs {fn.__name__}")


@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_bwd_blocked_chunk_does_not_change_the_gradient(chunk):
    """The blocked version's chunk (the first version's is 32, the bf16
    tensor-core body's 64, one ragged chunk here) changes the result
    only by rounding: against the float64 autograd gradient."""
    arrs = _inputs(7, 2, 40, 2, 8, 16, True, True)
    t32 = _torch(arrs)
    want = tref.mamba_chunk_scan_bwd_ref(
        *(None if v is None else v.double() for v in t32[:8]),
        initial_state=t32[8].double())
    got = tref.mamba_chunk_scan_bwd_blocked(*t32[:8], initial_state=t32[8],
                                            chunk=chunk)
    _hold(got, [w.float() for w in want], f"chunk {chunk}")


def _fn_grads(fwd, bwd, t, *, with_dfinal):
    x, dt, a, b, c, d, dy, df, s0 = t
    leaves = [v.clone().requires_grad_(True) for v in (x, dt, a, b, c, d, s0)]
    y, fin = ms.MambaChunkScanFn.apply(*leaves, 32, fwd, bwd)
    loss = (y * dy).sum() + ((fin * df).sum() if with_dfinal else 0.0)
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("bwd", ["ref", "blocked"])
def test_fn_with_plain_versions_matches_autograd(bwd):
    """``MambaChunkScanFn`` carrying the plain forward and each plain
    backward gives autograd's gradients of the plain forward, with the
    final state used and unused (its cotangent then arrives as None)."""
    t = _torch(_inputs(3, 2, 45, 2, 8, 16, True, True))
    back = (ms.mamba_chunk_scan_bwd_ref if bwd == "ref" else
            tref.mamba_chunk_scan_bwd_blocked)
    for with_dfinal in (True, False):
        got = _fn_grads(ms.mamba_chunk_scan_ref, back, t,
                        with_dfinal=with_dfinal)
        want = _fn_grads(ms.mamba_chunk_scan_ref,
                         _autograd_bwd, t, with_dfinal=with_dfinal)
        _hold(got, want, f"{bwd} dfinal={with_dfinal}")


def _autograd_bwd(x, dt, a, b, c, d, dy, df, *, initial_state):
    """Autograd of the plain forward itself, in the Function's bwd
    signature (the oracle of the test above)."""
    leaves = [v.detach().clone().requires_grad_(True)
              for v in (x, dt, a, b, c, d, initial_state)]
    with torch.enable_grad():
        y, fin = tref.mamba_chunk_scan_naive(*leaves[:6], chunk=32,
                                             initial_state=leaves[6])
        outs, cots = [y], [dy]
        if df is not None:
            outs.append(fin)
            cots.append(df)
        return torch.autograd.grad(outs, leaves, cots)


def test_fn_gradcheck_float64():
    """torch.autograd.gradcheck of ``MambaChunkScanFn`` with the plain
    forward and the blocked backward (chunk 4 over S = 10: three chunks,
    the last ragged), float64, with an initial state."""
    rng = np.random.default_rng(11)
    bt, s, h, p, n = 1, 10, 2, 3, 4
    f64 = torch.float64

    def t(a):
        return torch.tensor(a, dtype=f64, requires_grad=True)
    x = t(rng.standard_normal((bt, s, h, p)))
    dt = t(np.logaddexp(rng.standard_normal((bt, s, h)), 0.0))
    a = t(-np.exp(rng.standard_normal(h)))
    b, c = (t(rng.standard_normal((bt, s, n))) for _ in range(2))
    d = t(1.0 + 0.1 * rng.standard_normal(h))
    s0 = t(rng.standard_normal((bt, h, p, n)))

    def bwd(*args, initial_state):
        return tref.mamba_chunk_scan_bwd_blocked(
            *args, initial_state=initial_state, chunk=4)

    def f(x, dt, a, b, c, d, s0):
        return ms.MambaChunkScanFn.apply(x, dt, a, b, c, d, s0, 4,
                                         ms.mamba_chunk_scan_ref, bwd)
    assert torch.autograd.gradcheck(f, (x, dt, a, b, c, d, s0))


def test_ops_cpu_differentiates_the_plain_version():
    """On the CPU ``ops.mamba_chunk_scan`` under autograd is the plain
    version (no kernel launch, no Function): its gradients equal
    ``mamba_chunk_scan_bwd_ref``'s."""
    t = _torch(_inputs(5, 1, 20, 2, 4, 16, False, False))
    x, dt, a, b, c, d, dy = (v.clone().requires_grad_(True)
                             if i < 6 else v for i, v in enumerate(t[:7]))
    n0 = ms.BWD_LAUNCHES[0]
    y, _ = ops.mamba_chunk_scan(x, dt, a, b, c, d, chunk=16)
    got = torch.autograd.grad((y * dy).sum(), (x, dt, a, b, c, d))
    want = ms.mamba_chunk_scan_bwd(*(v.detach() for v in t[:7]))
    assert ms.BWD_LAUNCHES[0] == n0
    _hold(got + (None,), want, "ops on the CPU")
