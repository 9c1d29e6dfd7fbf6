"""The port's CUDA kernels against their plain torch versions on the
card (marker ``gpu``; each test skips without a CUDA device). Imports no
JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.counters import COUNTERS  # noqa: E402
from repro_torch.core.fmmu import batch as fb  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.fmmu_lookup import (  # noqa: E402
    fmmu_lookup, fmmu_lookup_ref)
from repro_torch.kernels.fmmu_translate import (  # noqa: E402
    fmmu_translate, fmmu_translate_ref)
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_chunk_scan, mamba_chunk_scan_ref)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_ref)

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 1e-2}
SCAN_TOL = {torch.float32: 5e-3, torch.bfloat16: 8e-2}   # the Pallas tests'



@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _device_events(fn, tries):
    """The device events (FunctionEvents) of one ``fn()`` under
    torch.profiler. In some states of a process the profiler drops one
    kernel record of a profile (a one-kernel profile then records
    nothing; PERF.md §7), so ``fn()`` runs between two spin kernels
    that are left out of the result. A profile that still records
    nothing is taken again after a pause that doubles (10 ms first),
    ``tries`` times in all. [] if every profile came back empty."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for k in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(2000)
            fn()
            torch.cuda._sleep(2000)
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "spin_kernel" not in e.name]
        if events:
            return events
        _TRACE_LOG.append((k, len(prof.events())))
        time.sleep(0.01 * 2 ** k)
    return []


_TRACE_LOG = []    # (attempt, events of any kind) of each empty profile


@pytest.fixture(scope="module", autouse=True)
def cupti_warm():
    """Profile once before any test of this file runs device work, and
    fail early, with what the profiles recorded, if the profiler
    records nothing on this card."""
    if torch.cuda.is_available():
        x = torch.zeros(1, device="cuda")
        assert _device_events(lambda: x.add_(1), tries=10), \
            f"CUPTI records nothing: {_TRACE_LOG}"
    yield


@pytest.fixture
def device_trace(cuda):
    """``trace(fn)``: the device events of one ``fn()`` under
    torch.profiler, between spin kernels that are left out; a profile
    that records no device event is retaken (it says nothing about the
    kernels): up to 8 profiles, ~2.5 s."""
    return lambda fn: _device_events(fn, tries=8)


@pytest.mark.parametrize("sq,skv,h,kv,d", [
    (128, 128, 4, 4, 32), (128, 128, 4, 2, 64), (64, 192, 2, 1, 32),
    (256, 256, 2, 2, 128), (100, 100, 4, 2, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, sq, skv, h, kv, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, sq, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, skv, kv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, skv, kv, d), generator=g, device=cuda).to(dtype)
    n0 = COUNTERS.launches().get("flash_attention", 0)
    for kw in (dict(), dict(window=48, softcap=20.0),
               dict(causal=False, bidirectional=True)):
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert COUNTERS.launches()["flash_attention"] - n0 == 3


@pytest.mark.parametrize("b,h,kv,d,page,maxp", [
    (2, 4, 4, 32, 16, 8), (3, 8, 2, 64, 8, 6), (1, 4, 1, 128, 32, 4),
    (2, 8, 2, 16, 256, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel(cuda, b, h, kv, d, page, maxp, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    nb = b * maxp + 4
    q = torch.randn((b, h, d), generator=g, device=cuda).to(dtype)
    kp = torch.randn((nb, page, kv, d), generator=g, device=cuda).to(dtype)
    vp = torch.randn((nb, page, kv, d), generator=g, device=cuda).to(dtype)
    table = torch.randperm(nb, generator=g, device=cuda)[:b * maxp].reshape(
        b, maxp).to(torch.int32)
    ctx = torch.tensor([0] + [(maxp * page * (i + 1)) // b for i in
                              range(1, b)], dtype=torch.int32, device=cuda)
    for kw in (dict(), dict(window=page + 3, softcap=25.0)):
        got, (m, l) = paged_attention(q, kp, vp, table, ctx,
                                      return_stats=True, **kw)
        want, (wm, wl) = paged_attention_ref(q, kp, vp, table, ctx,
                                             return_stats=True, **kw)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        torch.testing.assert_close(m, wm, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(l, wl, atol=1e-3, rtol=1e-3)
    assert (got[0] == 0).all()             # the ctx=0 lane


def _paged_inputs(cuda, b, h, kv, d, page, maxp, dtype, seed=5):
    g = torch.Generator(device=cuda).manual_seed(seed)
    nb = b * maxp + 4
    q = torch.randn((b, h, d), generator=g, device=cuda).to(dtype)
    kp = torch.randn((nb, page, kv, d), generator=g, device=cuda).to(dtype)
    vp = torch.randn((nb, page, kv, d), generator=g, device=cuda).to(dtype)
    table = torch.randperm(nb, generator=g, device=cuda)[:b * maxp].reshape(
        b, maxp).to(torch.int32)
    return q, kp, vp, table


def _check_paged(args, ctx, dtype, **kw):
    got, (m, l) = paged_attention(*args, ctx, return_stats=True, **kw)
    want, (wm, wl) = paged_attention_ref(*args, ctx, return_stats=True, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(m, wm, atol=1e-3, rtol=0)
    torch.testing.assert_close(l, wl, atol=0, rtol=1e-3)
    return got, m, l


@pytest.mark.parametrize("maxp", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_paged_attention_split_boundaries(cuda, maxp, dtype):
    """Contexts of 1, exactly at a split boundary and one past it, a
    ctx = 0 lane, a full table, and a window spanning two splits, with
    (m, l) held against the plain version."""
    b, h, kv, d, page = 6, 8, 2, 64, 16
    pl = pa.plan(b, h, kv, maxp, page, pa._sm_count(cuda.index or 0))
    assert pl.n_split > 2
    edge = pl.pages_per_split * page
    args = _paged_inputs(cuda, b, h, kv, d, page, maxp, dtype)
    ctx = torch.tensor([1, edge, edge + 1, 0, maxp * page, 2 * edge + 5],
                       dtype=torch.int32, device=cuda)
    got, m, l = _check_paged(args, ctx, dtype)
    assert (got[3] == 0).all() and (l[3] == 0).all()
    assert (m[3] == -1e30).all()
    got, m, l = _check_paged(args, ctx, dtype, window=edge + 10)
    _check_paged(args, ctx, dtype, window=7, softcap=30.0)


def test_paged_attention_repeats_bit_identical_counters_zero(cuda):
    """The combine runs in split-index order, so two calls agree bit for
    bit; every call leaves the ticket counters at zero."""
    b, h, kv, d, page, maxp = 8, 32, 8, 64, 16, 64
    args = _paged_inputs(cuda, b, h, kv, d, page, maxp, torch.bfloat16)
    ctx = torch.tensor([1024, 1000, 3, 0, 777, 512, 513, 64],
                       dtype=torch.int32, device=cuda)
    first = paged_attention(*args, ctx, return_stats=True)
    for _ in range(3):
        again = paged_attention(*args, ctx, return_stats=True)
        assert torch.equal(first[0], again[0])
        assert torch.equal(first[1][0], again[1][0])
        assert torch.equal(first[1][1], again[1][1])
    torch.cuda.synchronize()
    assert pa.plan(b, h, kv, maxp, page, 132).n_split > 1
    assert int(pa._COUNTER_BUFS[args[0].device].abs().sum()) == 0


def test_paged_attention_one_launch_per_call(cuda, device_trace):
    """One kernel on the device per call, split combine included."""
    args = _paged_inputs(cuda, 8, 32, 8, 64, 16, 64, torch.bfloat16)
    ctx = torch.full((8,), 1024, dtype=torch.int32, device=cuda)
    paged_attention(*args, ctx)                # counters allocated once
    torch.cuda.synchronize()
    n0 = COUNTERS.launches()["paged_attention"]
    paged_attention(*args, ctx)
    assert COUNTERS.launches()["paged_attention"] - n0 == 1
    kernels = [e.name for e in device_trace(
        lambda: paged_attention(*args, ctx))]
    assert len(kernels) == 1 and "paged_attention" in kernels[0], kernels


@pytest.mark.parametrize("sq,skv", [(100, 100), (37, 200), (130, 130),
                                    (64, 64)])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_tensor_core_body(cuda, sq, skv, d, dtype):
    """The bf16/f16 body: Sq < Skv (right-aligned causal), S not a
    multiple of 16 or 64, every head_dim, with window and softcap."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((2, sq, 4, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, skv, 2, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, skv, 2, d), generator=g, device=cuda).to(dtype)
    for kw in (dict(), dict(window=40), dict(softcap=15.0),
               dict(window=70, softcap=25.0),
               dict(causal=False, bidirectional=True)):
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("s,w,e,n_backing,bq", [
    (16, 4, 8, 1024, 8), (8, 2, 4, 256, 64), (512, 4, 8, 262144, 4096)])
def test_fmmu_translate_kernel_bit_exact(cuda, s, w, e, n_backing, bq):
    rng = np.random.default_rng(2)
    tags = (rng.integers(0, 64, (s, w)) * s + np.arange(s)[:, None])
    tags[:, -1] = tags[:, 0]                       # duplicate-tag ways
    valid = rng.random((s, w)) < 0.7
    dl = rng.integers(-2, n_backing + 3, (bq,))
    dl[:min(bq, s)] = tags[:min(bq, s), 0] * e + 1
    dl[-3:] = [-1, n_backing + 1, -2]
    arrs = [tags.astype(np.int32), valid, rng.random((s, w)) < 0.3,
            rng.integers(-1, 1 << 26, (s, w, e)).astype(np.int32),
            rng.integers(-1, 1 << 26, (n_backing,)).astype(np.int32),
            dl.astype(np.int32), rng.random((bq,)) < 0.6]
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    got = fmmu_translate(*args, entries_per_block=e)
    want = fmmu_translate_ref(*args, entries_per_block=e)
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype and torch.equal(gt, wt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_bit_identical_across_table_widths(cuda, dtype):
    """One lane's output and (m, l) do not depend on the table's width:
    the same contexts read through tables of 64 and 128 pages (the wider
    one the narrower plus other blocks) give the same bits, and contexts
    of at most 8 pages the same bits at 8 pages (one split: the direct
    path), 64 and 128."""
    b, h, kv, d, page = 8, 32, 8, 64, 16
    q, kp, vp, wide = _paged_inputs(cuda, b, h, kv, d, page, 128, dtype)
    for widths, ctx in (((64, 128), [1024, 1000, 1, 0, 777, 129, 128, 513]),
                        ((8, 64, 128), [128, 127, 1, 0, 16, 17, 100, 64])):
        ctx = torch.tensor(ctx, dtype=torch.int32, device=cuda)
        outs = [paged_attention(q, kp, vp, wide[:, :w].contiguous(), ctx,
                                return_stats=True) for w in widths]
        for w, (o, (m, l)) in zip(widths[1:], outs[1:]):
            assert torch.equal(o, outs[0][0]), (widths[0], w)
            assert torch.equal(m, outs[0][1][0]) and \
                torch.equal(l, outs[0][1][1]), (widths[0], w)
        _check_paged((q, kp, vp, wide[:, :widths[0]].contiguous()), ctx,
                     dtype)
    assert pa.plan(b, h, kv, 8, page, pa._sm_count(cuda.index or 0)) \
        .n_split == 1


@pytest.mark.parametrize("bt,s,h,p,n", [
    (1, 1, 2, 16, 16), (2, 3, 2, 16, 16), (1, 31, 4, 64, 128),
    (1, 100, 4, 64, 128), (2, 33, 3, 40, 16), (1, 256, 2, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("init", [False, True])
def test_mamba_chunk_scan_kernel(cuda, bt, s, h, p, n, dtype, init):
    """Ragged and short S, P not a multiple of the 32-row slice, every
    d_state the kernel takes, with and without an initial state."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((bt, s, h, p), generator=g, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((bt, s, h), generator=g, device=cuda))
    a = -torch.exp(torch.randn((h,), generator=g, device=cuda))
    b = torch.randn((bt, s, n), generator=g, device=cuda).to(dtype)
    c = torch.randn((bt, s, n), generator=g, device=cuda).to(dtype)
    d = 1.0 + 0.1 * torch.randn((h,), generator=g, device=cuda)
    s0 = (torch.randn((bt, h, p, n), generator=g, device=cuda) if init
          else None)
    n0 = COUNTERS.launches().get("mamba_chunk_scan", 0)
    y, fin = mamba_chunk_scan(x, dt, a, b, c, d, chunk=32, initial_state=s0)
    yw, fw = mamba_chunk_scan_ref(x, dt, a, b, c, d, chunk=32,
                                  initial_state=s0)
    assert COUNTERS.launches()["mamba_chunk_scan"] - n0 == 1
    assert y.dtype == dtype and fin.dtype == torch.float32
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(y.float(), yw.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(fin, fw, atol=tol, rtol=tol)


def _scan_model_inputs(dev, bt, s, h, p, n, dtype, init, seed=5):
    """Scan inputs in mamba2's ranges (models/ssm.py init_ssm, as
    chip_smoke.py draws them): dt = softplus(projection + dt_bias) around
    a per-head rate log-uniform in [0.001, 0.1], A = -[1, 16] per head."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)
    dt0 = torch.exp(u((h,), np.log(1e-3), np.log(0.1)))
    bias = dt0 + torch.log(-torch.expm1(-dt0))          # softplus^-1(dt0)
    dt = torch.nn.functional.softplus(
        0.5 * torch.randn((bt, s, h), generator=g, device=dev) + bias)
    a = -u((h,), 1.0, 16.0)
    d = 1.0 + 0.1 * torch.randn((h,), generator=g, device=dev)
    x = torch.randn((bt, s, h, p), generator=g, device=dev).to(dtype)
    b = torch.randn((bt, s, n), generator=g, device=dev).to(dtype)
    c = torch.randn((bt, s, n), generator=g, device=dev).to(dtype)
    s0 = (torch.randn((bt, h, p, n), generator=g, device=dev) if init
          else None)
    return (x, dt, a, b, c, d), s0


def _scan_held(args, s0, dtype):
    y, fin = mamba_chunk_scan(*args, chunk=256, initial_state=s0)
    yw, fw = mamba_chunk_scan_ref(*args, chunk=256, initial_state=s0)
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(y.float(), yw.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(fin, fw, atol=tol, rtol=tol)
    return y, fin


@pytest.mark.parametrize("s", [1024, 1000])
@pytest.mark.parametrize("init", [False, True])
def test_mamba_chunk_scan_serving_shape(cuda, s, init):
    """mamba2-1.3b's prefill scan (H=64 P=64 N=128, bf16: the
    tensor-core body) at a chunk multiple and a ragged length."""
    args, s0 = _scan_model_inputs(cuda, 1, s, 64, 64, 128, torch.bfloat16,
                                  init)
    _scan_held(args, s0, torch.bfloat16)


@pytest.mark.parametrize("s", [63, 64, 65, 127, 129])
@pytest.mark.parametrize("bt,h,p,n", [(2, 3, 64, 128), (1, 2, 40, 128),
                                      (2, 2, 40, 16), (1, 2, 20, 128)])
def test_mamba_chunk_scan_chunk_edges(cuda, s, bt, h, p, n):
    """S just under, on and past the 64-token chunk of the bf16 body,
    Bt > 1, P not a multiple of the block's rows (and P = 20, not a
    multiple of 8: element loads instead of 16-byte ones), both
    d_states."""
    args, s0 = _scan_model_inputs(cuda, bt, s, h, p, n, torch.bfloat16,
                                  True)
    _scan_held(args, s0, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba_chunk_scan_repeats_bit_identical(cuda, dtype):
    args, s0 = _scan_model_inputs(cuda, 1, 1000, 8, 64, 128, dtype, True)
    y, fin = _scan_held(args, s0, dtype)
    for _ in range(2):
        y2, fin2 = mamba_chunk_scan(*args, chunk=256, initial_state=s0)
        assert torch.equal(y, y2) and torch.equal(fin, fin2)


@pytest.mark.parametrize("dtype,body", [
    (torch.float32, "mamba_scan_kernel"),
    (torch.bfloat16, "mamba_scan_tc_kernel")])
def test_mamba_chunk_scan_routes_by_dtype(cuda, dtype, body, device_trace):
    """f32 goes through the CUDA-core recurrence, bf16 through the
    tensor-core body: one device kernel per call, named for its body."""
    args, s0 = _scan_model_inputs(cuda, 1, 200, 4, 64, 128, dtype, True)
    _scan_held(args, s0, dtype)
    names = [e.name for e in device_trace(
        lambda: mamba_chunk_scan(*args, chunk=256, initial_state=s0))]
    kernels = [n for n in names if "mamba" in n]
    assert len(kernels) == 1 and f"{body}<" in kernels[0], names


@pytest.mark.parametrize("s,w,e,bq", [
    (512, 4, 8, 4096), (16, 4, 8, 100), (4, 1, 4, 33)])
def test_fmmu_lookup_kernel_bit_exact(cuda, s, w, e, bq):
    """Tags and data past 1<<24 (integer compare, exact values),
    duplicate-tag ways (first match), inactive lanes."""
    rng = np.random.default_rng(4)
    # block ids >= 1<<24 whose dlpns (id * e) stay inside int32
    tags = (rng.integers(0, 64, (s, w)) + (1 << 24) // s + 1) * s + \
        np.arange(s)[:, None]
    tags[:, -1] = tags[:, 0]
    valid = rng.random((s, w)) < 0.7
    valid[:, 0] = True
    dl = rng.integers(-2, 1 << 30, (bq,))
    k = min(bq - 3, s)
    dl[:k] = tags[:k, 0] * e + np.arange(k) % e
    dl[k:2 * k] = (tags[:k].max(axis=1) + s) * e + 1   # in no way: miss
    dl[-3:] = [-1, -2, -e - 1]
    arrs = [tags.astype(np.int32), valid,
            rng.integers(-1, 1 << 30, (s, w, e)).astype(np.int32),
            dl.astype(np.int32)]
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    got = fmmu_lookup(*args, entries_per_block=e)
    want = fmmu_lookup_ref(*args, entries_per_block=e)
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype and torch.equal(gt, wt)
    assert got[0][:k].all() and not got[0][k:2 * k].any()


# ------------------------------------------------- the map commit kernel
GEOMETRIES = {
    # the llama serving grid's map (_geometry(8, 128)): NP = 1024
    "serving": dict(cmt_sets=16, cmt_ways=4, cmt_entries=8,
                    entries_per_tp=128, n_tvpns=8),
    # the paper's: 512 x 4 x 8, NP = 1,048,576
    "paper": {}}


def _commit_state(dev, rng, g, n_stack=64, n_lanes=8):
    """A map state with history: tags of in-range blocks of their set
    (duplicate-tag ways included), random valid/ref bits and clocks,
    values past 1<<24, a random table, stack and counters."""
    from repro_torch.core.fmmu.types import HOST_BASE
    s, w, e = g.cmt_sets, g.cmt_ways, g.cmt_entries
    n_pages = g.n_tvpns * g.entries_per_tp
    tags = rng.integers(0, n_pages // e // s, (s, w)) * s + \
        np.arange(s)[:, None]
    tags[::3, -1] = tags[::3, 0]

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)
    vals = (lambda *shape: rng.integers(-1, 2 * HOST_BASE, shape))
    st = fb.BatchFMMUState(
        tags=t(tags), valid=t(rng.random((s, w)) < 0.7, torch.bool),
        ref=t(rng.random((s, w)) < 0.4, torch.bool),
        clock=t(rng.integers(0, w, s)), data=t(vals(s, w, e)),
        backing=t(vals(n_pages)), stats=t(rng.integers(0, 1000, 4)))
    return fb.ServingMapState(
        fmmu=st, table=t(vals(n_pages)),
        free_stack=t(rng.permutation(1 << 20)[:n_stack]),
        free_n=t(np.int32(n_stack)), host_stack=t(np.zeros(0, np.int32)),
        host_n=t(np.int32(0)), oob=t(False, torch.bool),
        swap_pending=t(np.zeros(n_lanes, bool), torch.bool),
        commit_seq=t(np.int32(rng.integers(0, 1000))))


def _commit_lanes(rng, g, st, bq, grow=False):
    """Bq lanes: hits, misses (many per set: overflow), lanes past the
    map (just past and up to int32's max), duplicate reads (LOOKUP) and
    inactive lanes; several lanes per block with mixed op kinds; unique
    write dlpns (the caller contract: with ``grow`` every lane may
    write, so no read is duplicated); dppns NIL, device or host-tier."""
    from repro_torch.core.fmmu.types import HOST_BASE, LOOKUP, NIL
    e = g.cmt_entries
    n_pages = g.n_tvpns * g.entries_per_tp
    tags = st.tags.cpu().numpy()[st.valid.cpu().numpy()]
    hit_pages = (tags[:, None] * e + np.arange(e)).reshape(-1)
    cand = np.concatenate([
        [n_pages, n_pages + 3, 1 << 30, (1 << 31) - 1],
        rng.permutation(hit_pages)[:max(bq // 3, 1)],
        rng.permutation(n_pages)[:bq]])
    _, first = np.unique(cand, return_index=True)
    cand = cand[np.sort(first)]
    u = min(len(cand), max(1, 3 * bq // 4))
    dups = rng.choice(cand[:u], (bq - u) // 2)
    dl = np.concatenate([cand[:u], np.full_like(dups, -1) if grow else dups,
                         rng.choice([-1, -3], bq - u - (bq - u) // 2)])
    op = rng.integers(0, 3, bq)
    op[u:u + (bq - u) // 2] = LOOKUP                        # duplicate reads
    dp = rng.choice([NIL, 7, HOST_BASE + 5], bq)
    dp = np.where(dp == NIL, NIL, dp + rng.integers(0, 99, bq))
    order = rng.permutation(bq)
    return [torch.from_numpy(a[order].astype(np.int32)) for a in (op, dl, dp)]


@pytest.mark.parametrize("geom", ["serving", "paper"])
@pytest.mark.parametrize("bq", [1, 8, 100, 1000, 4096])
@pytest.mark.parametrize("mode", ["serving", "batch", "grow"])
def test_fmmu_commit_kernel_bit_exact(cuda, geom, bq, mode):
    """Three commits in a row: the kernel in place against the plain
    chain (impl="ref") on a clone of the same state, every state tensor
    and every output bit for bit. mode: translate_serving_ (table),
    translate_batch_ (no table), serving_grow_ (pops from a stack that
    runs dry mid-batch)."""
    from repro_torch.core.fmmu.types import FMMUGeometry
    from repro_torch.kernels import fmmu_commit as fc
    g = FMMUGeometry(**GEOMETRIES[geom])
    rng = np.random.default_rng(bq)
    ms = _commit_state(cuda, rng, g, n_stack=max(bq // 3, 1))
    ker, ref = fb.clone_state(ms), fb.clone_state(ms)
    if mode == "batch":
        ker, ref = ker.fmmu, ref.fmmu
    n0 = fc.LAUNCHES[0]
    for it in range(3):
        op, dl, dp = (a.to(cuda) for a in _commit_lanes(
            rng, g, ms.fmmu, bq, grow=mode == "grow"))
        if mode == "grow":
            grow = torch.from_numpy(rng.random(bq) < 0.5).to(cuda)
            got = fb.serving_grow_(g, ker, grow, dl)
            want = fb.serving_grow_(g, ref, grow, dl, impl="ref")
        else:
            # COND_UPDATE guards that hold on about half the lanes
            out = getattr(fb, f"translate_{mode}")(
                g, ref, torch.zeros_like(op), dl, dp, dp, impl="ref")[1]
            old = torch.where(torch.rand(bq, device=cuda) < 0.5, out, dp)
            got = getattr(fb, f"translate_{mode}_")(g, ker, op, dl, dp, old)
            want = getattr(fb, f"translate_{mode}_")(g, ref, op, dl, dp, old,
                                                     impl="ref")
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y), (it, mode)
        for i, (x, y) in enumerate(zip(fb.state_tensors(ker),
                                       fb.state_tensors(ref))):
            assert x.dtype == y.dtype and torch.equal(x, y), (it, i)
    assert fc.LAUNCHES[0] - n0 == 3
    if mode == "grow" and bq >= 8:
        assert bool(ker.oob)                  # the stack ran dry


@pytest.mark.parametrize("geom", ["serving", "paper"])
@pytest.mark.parametrize("bq", [1000, 4096])
@pytest.mark.parametrize("mode", ["serving", "batch"])
def test_fmmu_commit_repeats_bit_identical(cuda, geom, bq, mode):
    """One commit of many warps (translate mode: no barrier of the grow
    path's scan before the probe) launched 100 times, each on a fresh
    copy of one state: every launch leaves the state tensors and
    outputs that the plain chain leaves. A phase that reads shared
    memory before every warp has set it up differs on some launch."""
    from repro_torch.core.fmmu.types import FMMUGeometry
    g = FMMUGeometry(**GEOMETRIES[geom])
    rng = np.random.default_rng(bq + 7)
    ms = _commit_state(cuda, rng, g)
    if mode == "batch":
        ms = ms.fmmu
    op, dl, dp = (a.to(cuda) for a in _commit_lanes(
        rng, g, ms.fmmu if mode == "serving" else ms, bq))
    commit = getattr(fb, f"translate_{mode}_")
    ref = fb.clone_state(ms)
    want = list(commit(g, ref, op, dl, dp, dp, impl="ref")) + \
        fb.state_tensors(ref)
    for it in range(100):
        ker = fb.clone_state(ms)
        got = list(commit(g, ker, op, dl, dp, dp)) + fb.state_tensors(ker)
        for i, (x, y) in enumerate(zip(got, want)):
            assert torch.equal(x, y), (it, i)


def test_masked_serving_grow_commit_leaves_state_bit_identical(
        cuda, device_trace):
    """What the K-step graph runs on a step without a page boundary: a
    grow commit with every lane masked changes no tensor of the state,
    and it is one launch on the device."""
    from repro_torch.core.fmmu.types import FMMUGeometry
    from repro_torch.kernels import fmmu_commit as fc
    g = FMMUGeometry(**GEOMETRIES["serving"])
    ms = _commit_state(cuda, np.random.default_rng(0), g)
    before = fb.clone_state(ms)
    grow = torch.zeros(8, dtype=torch.bool, device=cuda)
    dl = torch.arange(8, dtype=torch.int32, device=cuda)
    fb.serving_grow_(g, ms, grow, dl)                  # loaded once
    torch.cuda.synchronize()
    n0 = fc.LAUNCHES[0]
    blocks, ok = fb.serving_grow_(g, ms, grow, dl)
    assert fc.LAUNCHES[0] - n0 == 1
    kernels = [e.name for e in device_trace(
        lambda: fb.serving_grow_(g, ms, grow, dl))]
    assert len(kernels) == 1 and "fmmu_commit" in kernels[0], kernels
    assert not ok.any() and (blocks == -1).all()
    for x, y in zip(fb.state_tensors(ms), fb.state_tensors(before)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("bq,seed", [(64, 0), (64, 1), (128, 2)])
def test_fmmu_commit_swap_commits_bit_exact(cuda, bq, seed):
    """The swap pipeline's commit at the serving map (S=16 W=4 E=8,
    NP=1024): one slot's pages mapped at device blocks go to host
    blocks and come back to other device blocks, every lane a
    COND_UPDATE with host-tagged new (out) or old (in) dppns, a quarter
    of them with a stale old dppn. The kernel in place against the plain
    chain on a clone, every state tensor and output bit for bit; the
    guard refuses exactly the stale lanes (and, coming back, the pages
    that never left)."""
    from repro_torch.core.fmmu.types import (COND_UPDATE, FMMUGeometry,
                                             HOST_BASE, UPDATE)
    g = FMMUGeometry(**GEOMETRIES["serving"])
    rng = np.random.default_rng(seed)
    ms = _commit_state(cuda, rng, g)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(cuda)

    def stale():
        m = np.zeros(bq, bool)
        m[rng.permutation(bq)[:bq // 4]] = True
        return m
    dl = int(rng.integers(0, 8)) * 128 + np.arange(bq)
    dev, back = rng.permutation(1024)[:bq], rng.permutation(1024)[:bq]
    host = HOST_BASE + rng.permutation(4096)[:bq]
    fb.translate_serving_(g, ms, t(np.full(bq, UPDATE)), t(dl), t(dev),
                          t(dev), impl="ref")
    op = t(np.full(bq, COND_UPDATE))
    s_out, s_in = stale(), stale()
    for new, old, refused in ((host, np.where(s_out, dev + 1, dev), s_out),
                              (back, np.where(s_in, host + 1, host),
                               s_in | s_out)):
        ker, ref = fb.clone_state(ms), fb.clone_state(ms)
        got = fb.translate_serving_(g, ker, op, t(dl), t(new), t(old))
        want = fb.translate_serving_(g, ref, op, t(dl), t(new), t(old),
                                     impl="ref")
        for x, y in zip(list(got) + fb.state_tensors(ker),
                        list(want) + fb.state_tensors(ref)):
            assert x.dtype == y.dtype and torch.equal(x, y)
        np.testing.assert_array_equal(got[1].cpu().numpy(), ~refused)
        ms = ker


def test_fmmu_commit_lane_cap_raises_on_the_card(cuda):
    from repro_torch.core.fmmu.types import FMMUGeometry
    from repro_torch.kernels import fmmu_commit as fc
    g = FMMUGeometry(**GEOMETRIES["paper"])
    st = _commit_state(cuda, np.random.default_rng(1), g).fmmu
    dl = torch.full((fc.LANE_CAP + 1,), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=str(fc.LANE_CAP)):
        fb.translate_batch_(g, st, dl, dl, dl, dl)
    dl = torch.arange(fc.LANE_CAP, dtype=torch.int32, device=cuda)
    ref = fb.clone_state(st)
    got = fb.translate_batch_(g, st, dl % 3, dl, dl, dl)
    want = fb.translate_batch_(g, ref, dl % 3, dl, dl, dl, impl="ref")
    for x, y in zip(list(got) + fb.state_tensors(st),
                    list(want) + fb.state_tensors(ref)):
        assert torch.equal(x, y)


# ------------------------------------- the channel grid of the commit
def _sharded_state(dev, rng, c_n, dry=None, n_stack=64):
    """A paper-geometry map cut into ``c_n`` 1/C shards (512 x 4 x 8 CMT
    each, backing 1,048,576 / C), each with its own history
    (``_commit_state``), stacked on the channel axis; channel ``dry``
    has an empty free stack. Returns (shard geometry, state)."""
    from repro_torch.core.fmmu.types import FMMUGeometry
    g = FMMUGeometry(n_tvpns=256 // c_n)
    shards = [_commit_state(dev, rng, g, n_stack=n_stack)
              for _ in range(c_n)]
    st = fb.BatchFMMUState(*(torch.stack(ts) for ts in zip(
        *(sh.fmmu for sh in shards))))
    ms = fb.ServingMapState(st, *(torch.stack(ts) for ts in zip(
        *(sh[1:9] for sh in shards))))
    if dry is not None:
        ms.free_n[dry] = 0
    return g, ms


def _sharded_lanes(rng, g, ms, bq, grow=False):
    """Bq global lanes over a stacked state: hits in each channel's CMT
    (local page * C + channel), misses anywhere in the global space,
    lanes past it up to int32's max, duplicate reads (LOOKUP; none with
    ``grow``), inactive lanes, mixed op kinds, unique write dlpns,
    dppns NIL, device or host-tier. Returns (op, dl, dp) on the CPU."""
    from repro_torch.core.fmmu.types import HOST_BASE, LOOKUP, NIL
    c_n, e = ms.table.shape[0], g.cmt_entries
    n_pages = c_n * g.n_tvpns * g.entries_per_tp
    tags, valid = ms.fmmu.tags.cpu().numpy(), ms.fmmu.valid.cpu().numpy()
    hits = np.concatenate([
        ((tags[c][valid[c]][:, None] * e + np.arange(e)) * c_n + c)
        .reshape(-1) for c in range(c_n)])
    cand = np.concatenate([
        [n_pages, n_pages + 3, 1 << 30, (1 << 31) - 1],
        rng.permutation(hits)[:max(bq // 3, 1)],
        rng.permutation(n_pages)[:bq]])
    _, first = np.unique(cand, return_index=True)
    cand = cand[np.sort(first)]
    u = min(len(cand), max(1, 3 * bq // 4))
    dups = rng.choice(cand[:u], (bq - u) // 2)
    dl = np.concatenate([cand[:u], np.full_like(dups, -1) if grow else dups,
                         rng.choice([-1, -3], bq - u - (bq - u) // 2)])
    op = rng.integers(0, 3, bq)
    op[u:u + (bq - u) // 2] = LOOKUP
    dp = rng.choice([NIL, 7, HOST_BASE + 5], bq)
    dp = np.where(dp == NIL, NIL, dp + rng.integers(0, 99, bq))
    order = rng.permutation(bq)
    return [torch.from_numpy(a[order].astype(np.int32)) for a in (op, dl, dp)]


@pytest.mark.parametrize("c_n", [2, 8, 32])
@pytest.mark.parametrize("bq", [64, 1024])
@pytest.mark.parametrize("mode", ["translate", "grow"])
def test_fmmu_commit_grid_bit_exact(cuda, c_n, bq, mode):
    """One launch of C blocks per commit, three commits in a row, on a
    paper-geometry map cut into C shards: the kernel in place against
    the plain per-channel chain on a clone, every state tensor and
    output bit for bit. Grow mode pops from each lane's owner channel;
    channel 1's stack is empty, so its lanes fail and raise only its
    oob flag."""
    from repro_torch.kernels import fmmu_commit as fc
    rng = np.random.default_rng(c_n * 100 + bq)
    g, ms = _sharded_state(cuda, rng, c_n,
                           dry=1 if mode == "grow" else None, n_stack=bq)
    ker, ref = fb.clone_state(ms), fb.clone_state(ms)
    for it in range(3):
        op, dl, dp = (a.to(cuda) for a in _sharded_lanes(
            rng, g, ms, bq, grow=mode == "grow"))
        n0 = fc.LAUNCHES[0]
        if mode == "grow":
            grow = torch.from_numpy(rng.random(bq) < 0.5).to(cuda)
            # one growing lane in the dry channel 1 at least
            used, page = set(dl.tolist()), 1
            while page in used:
                page += c_n
            dl[0] = page
            grow[0] = True
            got = fb.grow_sharded_(g, c_n, ker, grow, dl)
            want = fb.grow_sharded_(g, c_n, ref, grow, dl, impl="ref")
        else:
            out = fb.translate_sharded(g, c_n, ref, torch.zeros_like(op), dl,
                                       dp, dp, impl="ref")[1]
            old = torch.where(torch.rand(bq, device=cuda) < 0.5, out, dp)
            got = fb.translate_sharded_(g, c_n, ker, op, dl, dp, old)
            want = fb.translate_sharded_(g, c_n, ref, op, dl, dp, old,
                                         impl="ref")
        assert fc.LAUNCHES[0] - n0 == 1
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y), (it, mode)
        for i, (x, y) in enumerate(zip(fb.state_tensors(ker),
                                       fb.state_tensors(ref))):
            assert x.dtype == y.dtype and torch.equal(x, y), (it, i)
    if mode == "grow":
        oob = fb.oob_vec(ker).tolist()
        assert oob[1] and not any(oob[:1] + oob[2:]), oob


def test_fmmu_commit_grid_repeats_bit_identical(cuda):
    """One 4096-lane commit at C = 8 launched 100 times, each on a fresh
    copy of one stacked state: every launch leaves the state tensors
    and outputs that the plain per-channel chain leaves (the race check
    of the one-block commit, on the grid)."""
    c_n = 8
    rng = np.random.default_rng(8)
    g, ms = _sharded_state(cuda, rng, c_n)
    op, dl, dp = (a.to(cuda) for a in _sharded_lanes(rng, g, ms, 4096))
    ref = fb.clone_state(ms)
    want = list(fb.translate_sharded_(g, c_n, ref, op, dl, dp, dp,
                                      impl="ref")) + fb.state_tensors(ref)
    for it in range(100):
        ker = fb.clone_state(ms)
        got = list(fb.translate_sharded_(g, c_n, ker, op, dl, dp, dp)) + \
            fb.state_tensors(ker)
        for i, (x, y) in enumerate(zip(got, want)):
            assert torch.equal(x, y), (it, i)


def test_sharded_manager_at_the_served_map_equals_the_cpu_chain(cuda):
    """The served channel map (8 slots x 128 pages over 8 channels,
    1024 device + 1024 host blocks): admissions, growth pre-commits,
    swaps both ways (``check=False`` and ``check=True``) and a free on a
    card manager (one grid launch a map call) leave, after every op,
    the map state, page lists and per-channel free lists that a CPU
    manager (the plain per-channel chain) leaves."""
    from repro_torch.kernels import fmmu_commit as fc
    from repro_torch.paging.kv_manager import XLATE_CALLS, KVPageManager
    kvms = [KVPageManager(8, 128, 1024, 1024, channels=8, device=d)
            for d in (cuda, "cpu")]
    pages = [-(-n // 16) for n in (64, 128, 256, 384, 512, 640, 768, 1020)]
    ops = [("new", s, n) for s, n in enumerate(pages)] + [
        ("pre", list(range(8)) * 2), ("swap_out", 7, False),
        ("pre", [0, 2, 4, 6]), ("swap_out", 3, True), ("swap_in", 7, False),
        ("pre", [1, 5, 7]), ("swap_in", 3, True), ("free", 4),
        ("new", 4, 9), ("pre", list(range(8)))]
    for op in ops:
        for kvm in kvms:
            n0, x0 = fc.LAUNCHES[0], XLATE_CALLS[0]
            if op[0] == "new":
                kvm.new_seq(op[1], op[2])
            elif op[0] == "pre":
                kvm.precommit_growth(op[1])
            elif op[0] == "free":
                kvm.free_seq(op[1])
            else:
                getattr(kvm, op[0])(op[1], [], check=op[2])
            if kvm.device.type == "cuda":
                assert fc.LAUNCHES[0] - n0 == XLATE_CALLS[0] - x0 == 1, op
        for a, b in zip(fb.state_tensors(kvms[0].state),
                        fb.state_tensors(kvms[1].state)):
            assert torch.equal(a.cpu(), b), op
        assert kvms[0].seq_pages == kvms[1].seq_pages, op
        assert kvms[0].pool._free_dev_ch == kvms[1].pool._free_dev_ch, op
    assert kvms[0].pool.stats.swaps_out and kvms[0].pool.stats.swaps_in


def test_wrappers_reject_bad_arguments(cuda):
    q = torch.zeros((1, 8, 4, 16), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :3], q[:, :, :3])       # H % KV != 0
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                        q.transpose(1, 2))                  # not contiguous
    t = torch.zeros((4, 2), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        fmmu_translate(t, t.bool(), t.bool(), t[..., None], t[:, 0],
                       t[:, 0], t[:, 0].bool(), entries_per_block=1)
    with pytest.raises(ValueError):
        fmmu_lookup(t, t.bool(), t[..., None], t[:, 0], entries_per_block=1)
    x = torch.zeros((1, 8, 2, 16), device=cuda)
    bc = torch.zeros((1, 8, 24), device=cuda)                # d_state 24
    dt = torch.zeros((1, 8, 2), device=cuda)
    hv = torch.zeros((2,), device=cuda)
    with pytest.raises(ValueError):
        mamba_chunk_scan(x, dt, hv, bc, bc, hv)
    with pytest.raises(ValueError):                          # dt not f32
        mamba_chunk_scan(x, dt.bfloat16(), hv, bc[..., :16], bc[..., :16],
                         hv)
    with pytest.raises(ValueError):                          # f16
        mamba_chunk_scan(x.half(), dt, hv, bc[..., :16].half(),
                         bc[..., :16].half(), hv)


# ------------------------------------------------- K-step macro graphs
MACRO_K = 4


def _macro_engine(dev, arch="llama3.2-1b", dtype=torch.float32, page=8,
                  macro_k=MACRO_K, **cfg):
    """A 2-layer smoke model (f32, page 8 unless given) behind a macro
    engine (a single-step one with macro_k=0)."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import Runtime, build_model
    from repro_torch.serving import ServeConfig, ServeEngine
    m = build_model(smoke_config(get_arch(arch)),
                    Runtime(compute_dtype=dtype, param_dtype=dtype,
                            page_size=page),
                    device=dev)
    params = m.init(torch.Generator(device=dev).manual_seed(0))
    cfg.setdefault("max_ctx", 128)
    return ServeEngine(m, params, config=ServeConfig(
        n_slots=4, macro_k=macro_k, **cfg), device=dev)


def _serve(eng, reqs):
    """Run (prompt, max_new) requests to completion; their tokens in
    order, and the (simple, forced, pages) key of every macro run."""
    keys = []
    if eng._graphs is not None:
        run = eng._graphs.run

        def spy(ms, buf, *key):
            keys.append(key)
            return run(ms, buf, *key)
        eng._graphs.run = spy
    rids = [eng.submit(list(t), max_new=n) for t, n in reqs]
    done = eng.run()
    return [done[r] for r in rids], keys


# four requests whose runs take all four (simple, forced) variants: the
# 33- and 20-token prompts are chunk-prefilled (forced lanes), the
# 5-token one retires mid-run (full variant)
MACRO_REQS = [(range(1, 34), 6), (range(90, 95), 3), (range(40, 46), 34),
              (range(60, 80), 10)]


def _check_replays(eng, cuda):
    """Hold every replay of ``eng``'s K-step graphs against one eager run
    of the same program on clones of the same map state and caches:
    tokens, oob, map state and caches bit-identical, the replay's launch
    counts equal the eager run's, K fmmu_commit launches a replay and no
    probe kernel outside them. Returns the list of replayed keys."""
    from repro_torch.serving import macro
    graphs = eng._graphs
    replay = graphs.run
    seen = []

    def checked(ms, buf, simple, forced, pages):
        ms0 = fb.clone_state(ms)
        caches0 = {n: c.clone() for n, c in eng.caches.items()}
        n0 = COUNTERS.launches()
        st, out = replay(ms, buf, simple, forced, pages)
        n1 = COUNTERS.launches()
        args = macro.unpack_inputs(torch.from_numpy(buf).to(cuda), MACRO_K,
                                   eng.n_slots, simple, forced)
        ms_e, toks, oob = macro.macro_fn(eng, eng.params, ms0, caches0,
                                         *args, pages, simple=simple)
        n2 = COUNTERS.launches()
        want = torch.cat([toks.reshape(-1), oob.to(torch.int32).reshape(1)])
        assert torch.equal(out, want)
        for a, b in zip(fb.state_tensors(st), fb.state_tensors(ms_e)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for n, c in eng.caches.items():
            assert torch.equal(c, caches0[n]), n
        assert {k: n1[k] - n0.get(k, 0) for k in n1} == \
            {k: n2[k] - n1.get(k, 0) for k in n2}
        # the in-place map commit: one kernel launch a step, and no probe
        # kernel outside it
        assert n1["fmmu_commit"] - n0.get("fmmu_commit", 0) == MACRO_K
        assert n1.get("fmmu_translate", 0) == n0.get("fmmu_translate", 0)
        seen.append((simple, forced, pages))
        return st, out

    graphs.run = checked
    return seen


def test_macro_graph_replay_matches_eager_program(cuda):
    """Every replay against one eager run of the same K-step program
    (``_check_replays``). The runs take the simple, full and forced
    variants, with the page bucket alternating 4 / 8 between rounds, so
    graphs of two buckets are replayed in turns."""
    eng = _macro_engine(cuda, admit_tokens=12)
    graphs = eng._graphs
    seen = _check_replays(eng, cuda)
    rids = [eng.submit(list(t), max_new=n) for t, n in MACRO_REQS]
    done: dict = {}
    i = 0
    while eng.step(done):
        i += 1
        eng.min_page_bucket = (4, 8)[i % 2]
    assert {(s, f) for s, f, _ in seen} == {(True, True), (True, False),
                                            (False, True), (False, False)}
    pages = [p for _, _, p in seen]
    assert any(a != b for a, b in zip(pages, pages[1:]))
    assert graphs.stats()["graphs"] == len(set(seen))
    assert [len(done[r]) for r in rids] == [n for _, n in MACRO_REQS]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_macro_capture_changes_no_state_and_steady_state_captures_nothing(
        cuda, arch):
    """Capturing a new variant leaves the map state, caches and counters
    as they were (the capture ran no work); once a round's variant is
    captured, steady rounds capture nothing and each makes one dispatch,
    one host sync, no host-side map call and no allocator re-sync, with
    K fmmu_commit launches (and K per attention layer of
    paged_attention) counted per replay."""
    eng = _macro_engine(cuda, arch)
    eng.min_page_bucket = 16          # one bucket for the whole test
    for t in (range(1, 9), range(20, 31)):
        eng.submit(list(t), max_new=10 ** 6)
    done: dict = {}
    eng.step(done)                    # admission, prefill, first capture
    ms0 = fb.clone_state(eng.kvm.state)
    caches0 = {n: c.clone() for n, c in eng.caches.items()}
    before = COUNTERS.snapshot()
    eng._graphs._capture((False, True, (16,) * MACRO_K))  # not yet used
    torch.cuda.synchronize()
    d = COUNTERS.delta(before)
    assert d.pop("engine.macro_captures") == 1
    assert not any(d.values()), d
    for a, b in zip(fb.state_tensors(eng.kvm.state),
                    fb.state_tensors(ms0)):
        assert torch.equal(a, b)
    for n, c in eng.caches.items():
        assert torch.equal(c, caches0[n]), n
    n_attn = sum(eng.cfg.layer_kind(j) == "attn"
                 for j in range(eng.cfg.n_layers))
    for _ in range(5):
        before = COUNTERS.snapshot()
        eng.step(done)
        d = COUNTERS.delta(before)
        assert d["engine.macro_captures"] == 0
        assert d["engine.macro_dispatches"] == 1
        assert d["engine.host_syncs"] == 1
        assert d["kvm.xlate_calls"] == d["kvm.alloc_syncs"] == 0
        assert d["kvm.full_table_calls"] == 0
        assert d["kernel.fmmu_commit"] == MACRO_K
        assert d.get("kernel.paged_attention", 0) == MACRO_K * n_attn
    assert eng.metrics["macro_fallbacks"] == 0
    torch.testing.assert_close(eng.kvm.block_tables(),
                               eng.kvm.retranslate_tables(), rtol=0, atol=0)


def test_macro_capture_never_grows_the_ticket_buffer(cuda, monkeypatch):
    """In a fresh process state the first capture is at page bucket 4
    (paged attention runs one split: no ticket buffer) and the next at
    bucket 8 (two splits): the buffer is grown by that variant's eager
    warm-up, never inside a capture, where the zero-fill would only run
    at replay from the graph pool. The tokens equal single steps'."""
    pa._COUNTER_BUFS.clear()                     # nothing sized yet
    grown = []
    sized = pa._counter_buffer

    def spy(dev, n):
        before = pa._COUNTER_BUFS.get(dev)
        buf = sized(dev, n)
        if buf is not before:
            grown.append(torch.cuda.is_current_stream_capturing())
        return buf
    monkeypatch.setattr(pa, "_counter_buffer", spy)
    # a 60-token prompt at page 16: ctx 60..63 (4 pages) in the first
    # run, 64..67 (5 pages, bucket 8) in the second
    reqs = [(range(1, 61), 12), (range(100, 110), 12)]
    eng = _macro_engine(cuda, page=16, max_ctx=256)
    got, keys = _serve(eng, reqs)
    cfg = eng.cfg
    splits = {p: pa.plan(eng.n_slots, cfg.n_heads, cfg.n_kv_heads, p, 16,
                         pa._sm_count(torch.cuda.current_device())).n_split
              for p in (4, 8)}
    assert [k[2] for k in keys[:2]] == [(4,) * MACRO_K, (8,) * MACRO_K]
    assert splits[4] == 1 < splits[8]
    assert grown == [False]
    assert eng._graphs.stats()["graphs"] == len(set(keys)) >= 2
    monkeypatch.undo()
    want, _ = _serve(_macro_engine(cuda, page=16, max_ctx=256, macro_k=0),
                     reqs)
    assert got == want


def test_macro_run_crossing_a_page_bucket_matches_single_steps(cuda):
    """bf16 at page 16: the 62-token prompt reaches 64 tokens (5 pages)
    at step 2 of the first K-step run, which cuts its tables to bucket 4
    for steps 0-1 and 8 for steps 2-3, as single steps do; tokens and
    the KV pools are bit-identical to single steps'. Paged attention's
    result does not depend on the table's width, so a macro engine
    whose tables are always the widest bucket gives the same bits too.
    The K-step graphs commit the map in place: after the runs the
    engine's map state is the graphs' static state, tensor for
    tensor."""
    reqs = [(range(1, 63), 13), (range(200, 240), 13), (range(300, 320), 13)]
    dt = torch.bfloat16
    eng = _macro_engine(cuda, dtype=dt, page=16, max_ctx=256)
    got, keys = _serve(eng, reqs)
    assert keys[0][2] == (4, 4, 8, 8)
    for a, b in zip(fb.state_tensors(eng.kvm.state),
                    fb.state_tensors(eng._graphs.ms)):
        assert a is b
    single = _macro_engine(cuda, dtype=dt, page=16, max_ctx=256, macro_k=0)
    want, _ = _serve(single, reqs)
    assert got == want
    wide = _macro_engine(cuda, dtype=dt, page=16, max_ctx=256)
    wide.min_page_bucket = wide.max_pages
    got_wide, keys_wide = _serve(wide, reqs)
    assert {p for k in keys_wide for p in k[2]} == {wide.max_pages}
    assert got_wide == want
    live = eng.scratch_block                     # the last block: scratch
    for name in ("pool_k", "pool_v"):
        assert torch.equal(eng.caches[name][:, :, :live],
                           single.caches[name][:, :, :live]), name
        assert torch.equal(wide.caches[name][:, :, :live],
                           single.caches[name][:, :, :live]), name


# ------------------------------------------- host tier and swaps
# the reference tests' oversubscribed shape: four 8-token prompts x 24
# new tokens (16 pages) on 10 device blocks, 24 host blocks
OVERSUB = dict(max_ctx=64, n_device_blocks=10, n_host_blocks=24,
               swap_patience=2)
OVERSUB_REQS = [(range(1 + 20 * i, 9 + 20 * i), 24) for i in range(4)]


def test_oversubscribed_macro_replays_match_eager_program(cuda):
    """About 2x oversubscription on the card: the boundary scheduler
    swaps slots out and back while the K-step graphs mask them; every
    replay equals the eager program on clones (``_check_replays``), no
    round falls back, and the tokens equal a full-pool macro engine's
    and a single-step engine's."""
    eng = _macro_engine(cuda, **OVERSUB)
    seen = _check_replays(eng, cuda)
    got, _ = _serve(eng, OVERSUB_REQS)
    assert seen
    assert eng.metrics["macro_fallbacks"] == 0
    assert eng.metrics["swaps_out"] > 0 and eng.metrics["swaps_in"] > 0
    assert eng._graphs.stats()["graphs"] == len(set(seen))
    want, _ = _serve(_macro_engine(cuda, max_ctx=64), OVERSUB_REQS)
    single, _ = _serve(_macro_engine(cuda, macro_k=0, **OVERSUB),
                       OVERSUB_REQS)
    assert got == want == single


def test_residency_flips_reach_the_static_state_without_a_capture(cuda):
    """A slot swapped out by hand between two K-step runs: the flip and
    the swap's commit land in place on the graphs' static map state, the
    next run masks the slot (no token, no context) and captures nothing,
    and after the swap back the tokens equal an engine that never
    swapped. Budgets of 1 + 5K keep every run in the simple variant, and
    the widest page bucket is pinned: one graph serves every run."""
    from repro_torch.serving import macro
    reqs = [(range(1, 9), 1 + 5 * MACRO_K), (range(30, 41), 1 + 5 * MACRO_K)]
    want, _ = _serve(_macro_engine(cuda, max_ctx=64), reqs)
    eng = _macro_engine(cuda, max_ctx=64, n_host_blocks=16)
    eng.min_page_bucket = eng.max_pages          # one bucket throughout
    rids = [eng.submit(list(t), max_new=n) for t, n in reqs]
    done: dict = {}
    eng.step(done)                  # admission, prefill, first capture
    static = eng._graphs.ms
    slot = eng.active[rids[1]].slot
    n_out = len(eng.active[rids[1]].out)
    ctx = int(eng.ctx_lens[slot])
    assert eng._swap_out_slot(slot)
    assert bool(static.swap_pending[slot])
    for a, b in zip(fb.state_tensors(eng.kvm.state),
                    fb.state_tensors(static)):
        assert a is b                # the commit and the flip in place
    c0 = macro.MACRO_CAPTURES[0]
    eng._macro_decode_step(done)    # a run with the slot masked
    assert macro.MACRO_CAPTURES[0] == c0
    assert len(eng.active[rids[1]].out) == n_out
    assert int(eng.ctx_lens[slot]) == ctx
    assert eng._swap_in_slot(slot)
    assert not bool(eng.kvm.state.swap_pending[slot])
    while eng.step(done):
        pass
    assert macro.MACRO_CAPTURES[0] == c0
    assert [done[r] for r in rids] == want


def test_swap_with_check_false_never_syncs(cuda):
    """``check=False`` swaps (the scheduler's) make no synchronising call
    (``torch.cuda.set_sync_debug_mode("error")`` raises on one), and
    leave the pool rows and the map state that a CPU manager running the
    same swaps leaves."""
    from repro_torch.paging.kv_manager import KVPageManager
    kvms = [KVPageManager(2, 8, 16, 16, device=d) for d in (cuda, "cpu")]
    g = torch.Generator().manual_seed(0)
    pools = [torch.randn((33, 4, 8), generator=g) for _ in range(2)]
    pools = [[p.to(cuda) for p in pools], pools]
    for kvm, ps in zip(kvms, pools):
        kvm.new_seq(0, 5)
        kvm.new_seq(1, 3)
        kvm.swap_out(1, ps, block_axis=0)      # warm: loads, pinned pool
        kvm.swap_in(1, ps, block_axis=0)
    torch.cuda.synchronize()
    for kvm, ps in zip(kvms, pools):
        if kvm.device.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            assert kvm.swap_out(0, ps, check=False) == 5
            assert kvm.swap_out(1, ps, check=False) == 3
            assert kvm.swap_in(0, ps, check=False) == 5
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(pools[0], pools[1]):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(fb.state_tensors(kvms[0].state),
                    fb.state_tensors(kvms[1].state)):
        assert torch.equal(a.cpu(), b)
    assert kvms[0].seq_pages == kvms[1].seq_pages


# ------------------------------------------- channel-sharded macro path
def test_sharded_macro_replays_match_eager_program(cuda):
    """A two-channel macro engine: every replay of its K-step graphs
    equals one eager run of ``macro_fn`` on clones of the map state and
    the caches (tokens and caches bit for bit, the same counted
    launches), no graph
    holds an ``fmmu_commit`` launch (the growth commit is the
    boundary's one eager launch), and the tokens equal a one-channel
    engine's and a two-channel single-step engine's."""
    from repro_torch.serving import macro
    eng = _macro_engine(cuda, channels=2, admit_tokens=12)
    graphs = eng._graphs
    replay = graphs.run
    seen = []

    def checked(ms, buf, simple, forced, pages):
        caches0 = {n: c.clone() for n, c in eng.caches.items()}
        ms0 = fb.clone_state(ms)
        n0 = COUNTERS.launches()
        st, out = replay(ms, buf, simple, forced, pages)
        n1 = COUNTERS.launches()
        args = macro.unpack_inputs(torch.from_numpy(buf).to(cuda), MACRO_K,
                                   eng.n_slots, simple, forced)
        _, toks, _ = macro.macro_fn(
            eng, eng.params, ms0, caches0, *args, pages, simple=simple)
        n2 = COUNTERS.launches()
        assert torch.equal(out[:toks.numel()], toks.reshape(-1))
        for n, c in eng.caches.items():
            assert torch.equal(c, caches0[n]), n
        assert {k: n1[k] - n0.get(k, 0) for k in n1} == \
            {k: n2[k] - n1.get(k, 0) for k in n2}
        assert n1.get("fmmu_commit", 0) == n0.get("fmmu_commit", 0)
        seen.append((simple, forced, pages))
        return st, out

    graphs.run = checked
    got, _ = _serve(eng, MACRO_REQS)
    assert {(s, f) for s, f, _ in seen} == {(True, True), (True, False),
                                            (False, True), (False, False)}
    assert all(d.get("kernel.fmmu_commit", 0) == 0
               for d in graphs.deltas.values())
    assert eng.metrics["macro_fallbacks"] == 0
    want, _ = _serve(_macro_engine(cuda, admit_tokens=12), MACRO_REQS)
    single, _ = _serve(_macro_engine(cuda, channels=2, admit_tokens=12,
                                     macro_k=0), MACRO_REQS)
    assert got == want == single


def test_stacked_residency_flip_in_place_without_a_capture(cuda):
    """A two-channel engine: a slot swapped out by hand between two
    K-step runs flips its lane in both channels' copies, in place on the
    graphs' static map state (its commit too); the next run masks the
    slot and captures nothing, and after the swap back the tokens equal
    an engine that never swapped."""
    from repro_torch.serving import macro
    reqs = [(range(1, 9), 1 + 5 * MACRO_K), (range(30, 41), 1 + 5 * MACRO_K)]
    want, _ = _serve(_macro_engine(cuda, max_ctx=64), reqs)
    eng = _macro_engine(cuda, max_ctx=64, n_host_blocks=16, channels=2)
    eng.min_page_bucket = eng.max_pages          # one bucket throughout
    rids = [eng.submit(list(t), max_new=n) for t, n in reqs]
    done: dict = {}
    eng.step(done)                  # admission, prefill, first capture
    static = eng._graphs.ms
    slot = eng.active[rids[1]].slot
    n_out = len(eng.active[rids[1]].out)
    assert eng._swap_out_slot(slot)
    assert static.swap_pending[:, slot].tolist() == [True, True]
    for a, b in zip(fb.state_tensors(eng.kvm.state),
                    fb.state_tensors(static)):
        assert a is b
    c0 = macro.MACRO_CAPTURES[0]
    eng._macro_decode_step(done)    # a run with the slot masked
    assert macro.MACRO_CAPTURES[0] == c0
    assert len(eng.active[rids[1]].out) == n_out
    assert eng._swap_in_slot(slot)
    assert not eng.kvm.state.swap_pending.any()
    while eng.step(done):
        pass
    assert macro.MACRO_CAPTURES[0] == c0
    assert [done[r] for r in rids] == want


# ------------------------------------------- faults and recovery
@pytest.mark.parametrize("channels", [1, 8])
def test_retire_and_restore_commits_match_the_cpu_chain(cuda, channels,
                                                        tmp_path):
    """Page managers on the card and on the CPU at the llama serving map
    (8 slots x 128 pages, 1024 device + 256 host blocks), journaled, run
    the same admissions; then a retirement of 4 pages with pool rows and
    a restore (the journal replayed into the reset manager): each is one
    ``fmmu_commit`` launch (of C blocks at C channels), and the map
    state, pool rows and page lists equal the CPU manager's after each.
    The restored block table equals the one before the reset."""
    from repro_torch.core import journal as jl
    from repro_torch.kernels import fmmu_commit as fc
    from repro_torch.paging.kv_manager import KVPageManager
    kvms = [KVPageManager(8, 128, 1024, 256, channels, device=d)
            for d in (cuda, "cpu")]
    g = torch.Generator().manual_seed(0)
    pool = torch.randn((1024 + 256 + 1, 4), generator=g)
    pools = [pool.clone().to(cuda), pool.clone()]
    for i, kvm in enumerate(kvms):
        kvm.journal = jl.Journal(str(tmp_path / str(i)))
        kvm.journal.snapshot(kvm.snapshot_state())
        for s in range(8):
            kvm.new_seq(s, 3 + 9 * s)
    bad = [(s * 128 + s, kvms[1].seq_pages[s][s]) for s in (1, 3, 5, 7)]
    tables = []
    for kvm, p in zip(kvms, pools):
        n0 = fc.LAUNCHES[0]
        assert kvm.retire_bad_blocks(bad, pools=[p]) == 4
        if kvm.device.type == "cuda":
            assert fc.LAUNCHES[0] - n0 == 1
        tables.append(kvm.block_tables().cpu())
        kvm.journal.close()
    assert torch.equal(pools[0].cpu(), pools[1])
    for kvm, (dl, old) in ((k, b) for k in kvms for b in bad):
        new = kvm.seq_pages[dl // 128][dl % 128]
        assert new != old and torch.equal(pools[1][new], pool[old])
    for a, b in zip(fb.state_tensors(kvms[0].state),
                    fb.state_tensors(kvms[1].state)):
        assert torch.equal(a.cpu(), b)
    for i, kvm in enumerate(kvms):
        rec = jl.replay(str(tmp_path / str(i)))
        kvm.reset()
        n0 = fc.LAUNCHES[0]
        assert kvm.restore_mapping(rec) == sum(3 + 9 * s for s in range(8))
        if kvm.device.type == "cuda":
            assert fc.LAUNCHES[0] - n0 == 1
        assert torch.equal(kvm.block_tables().cpu(), tables[i])
    for a, b in zip(fb.state_tensors(kvms[0].state),
                    fb.state_tensors(kvms[1].state)):
        assert torch.equal(a.cpu(), b)
    assert kvms[0].seq_pages == kvms[1].seq_pages
    assert kvms[0].pool.state_dict() == kvms[1].pool.state_dict()


def test_macro_retirement_moves_the_rows_the_graph_wrote(cuda):
    """A K-step engine under program faults on the card: every replay
    equals the eager program (``_check_replays``); after a run, each
    retirement of its pops moves the rows the graph wrote to the
    replacement block, in place, with one ``fmmu_commit`` launch; the
    tokens equal a fault-free engine's."""
    from repro_torch.core.faults import FaultPlane, make_plan
    from repro_torch.kernels import fmmu_commit as fc
    want, _ = _serve(_macro_engine(cuda), MACRO_REQS)
    eng = _macro_engine(cuda)
    eng.reset(FaultPlane(make_plan(5, program_fail_p=0.3)))
    seen = _check_replays(eng, cuda)
    retire = eng.kvm.retire_bad_blocks
    moved = []

    def spy(bad, pools=(), block_axis=0):
        before = [p.clone() for p in pools]
        n0 = fc.LAUNCHES[0]
        n = retire(bad, pools=pools, block_axis=block_axis)
        assert fc.LAUNCHES[0] - n0 == (1 if n else 0)
        if pools and n:
            for dl, old in bad:
                new = eng.kvm.seq_pages[dl // eng.max_pages][
                    dl % eng.max_pages]
                for p, p0 in zip(pools, before):
                    assert torch.equal(p[:, :, new], p0[:, :, old])
            moved.append(n)
        return n
    eng.kvm.retire_bad_blocks = spy
    got, _ = _serve(eng, MACRO_REQS)
    assert seen and moved
    assert got == want
