"""The port's CUDA kernels against their plain torch versions on the
card (marker ``gpu``; each test skips without a CUDA device). Imports no
JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import functools

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


def _graph_kernels(fn):
    """(graph, its kernel nodes' demangled function names) of one
    ``fn()`` captured into a kept CUDA graph after an eager warm-up:
    what one replay launches, read through libcuda, independent of any
    profiler (``macro.capture`` takes the capture's counts back out)."""
    from repro_torch.kernels._graph import kernel_names
    from repro_torch.serving.macro import capture
    fn()
    graph, _ = capture(fn)
    return graph, kernel_names(graph)


@pytest.mark.parametrize("sq,skv,h,kv,d", [
    (128, 128, 4, 4, 32), (128, 128, 4, 2, 64), (64, 192, 2, 1, 32),
    (256, 256, 2, 2, 128), (100, 100, 4, 2, 16), (130, 130, 4, 2, 256)])
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
    (2, 8, 2, 16, 256, 2), (3, 8, 2, 256, 16, 20), (2, 16, 2, 256, 16, 6)])
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


def test_paged_attention_one_launch_per_call(cuda):
    """One kernel on the device per call, split combine included: the
    call's CUDA graph holds one node, and its replay gives the eager
    call's output."""
    args = _paged_inputs(cuda, 8, 32, 8, 64, 16, 64, torch.bfloat16)
    ctx = torch.full((8,), 1024, dtype=torch.int32, device=cuda)
    paged_attention(*args, ctx)                # counters allocated once
    torch.cuda.synchronize()
    n0 = COUNTERS.launches()["paged_attention"]
    want = paged_attention(*args, ctx)
    assert COUNTERS.launches()["paged_attention"] - n0 == 1
    got = []
    graph, kernels = _graph_kernels(lambda: got.append(
        paged_attention(*args, ctx)))
    assert len(kernels) == 1 and "paged_attention" in kernels[0], kernels
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[-1], want)


@pytest.mark.parametrize("g,d", [(g, d) for d in (64, 128, 256)
                                 for g in (1, 2, 4, 6, 7, 8, 16)]
                         + [(24, 64), (40, 64), (80, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_paged_attention_tensor_core_body(cuda, g, d, dtype):
    """The bf16 / f16 body (every query head of a KV head in one block,
    the heads the rows of the tensor-core products; two and four 16-row
    head tiles at G = 24 / 40, two chunks at 80) against the plain
    version with (m, l): a ctx = 0 lane, contexts on and one past a
    split edge and far from it, with and without the window and the
    softcap; a repeat and a wider table give the same bits, every call
    is one launch and leaves the ticket counters at zero."""
    b, kv, page, maxp = 4, 2, 16, 64
    h = g * kv
    q, kp, vp, wide = _paged_inputs(cuda, b, h, kv, d, page, 2 * maxp,
                                    dtype, seed=g + d)
    args = (q, kp, vp, wide[:, :maxp].contiguous())
    pl = pa.plan(b, h, kv, maxp, page, pa._sm_count(cuda.index or 0))
    assert pl.n_split > 2 and pl.head_chunks == -(-g // 64)
    edge = pl.pages_per_split * page
    ctx = torch.tensor([0, edge, edge + 1, maxp * page - 3],
                       dtype=torch.int32, device=cuda)
    for kw in (dict(), dict(window=edge + 10, softcap=30.0)):
        got, m, l = _check_paged(args, ctx, dtype, **kw)
        assert (got[0] == 0).all() and (l[0] == 0).all() \
            and (m[0] == -1e30).all()
        n0 = COUNTERS.launches()["paged_attention"]
        again = paged_attention(*args, ctx, return_stats=True, **kw)
        wider = paged_attention(q, kp, vp, wide, ctx, return_stats=True,
                                **kw)
        assert COUNTERS.launches()["paged_attention"] - n0 == 2
        for other in (again, wider):
            assert torch.equal(got, other[0])
            assert torch.equal(m, other[1][0]) and torch.equal(l, other[1][1])
    torch.cuda.synchronize()
    assert int(pa._COUNTER_BUFS[q.device].abs().sum()) == 0


@pytest.mark.parametrize("sq,skv", [(100, 100), (37, 200), (130, 130),
                                    (64, 64)])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
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
def test_mamba_chunk_scan_routes_by_dtype(cuda, dtype, body):
    """f32 goes through the CUDA-core recurrence, bf16 through the
    tensor-core body: one device kernel per call, named for its body
    (the call's CUDA graph, read through libcuda)."""
    args, s0 = _scan_model_inputs(cuda, 1, 200, 4, 64, 128, dtype, True)
    _scan_held(args, s0, dtype)
    _, names = _graph_kernels(
        lambda: mamba_chunk_scan(*args, chunk=256, initial_state=s0))
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


def test_masked_serving_grow_commit_leaves_state_bit_identical(cuda):
    """What the K-step graph runs on a step without a page boundary: a
    grow commit with every lane masked changes no tensor of the state,
    and it is one launch on the device (the call's CUDA graph holds one
    node, read through libcuda; its replay changes no tensor either)."""
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
    graph, kernels = _graph_kernels(lambda: fb.serving_grow_(g, ms, grow, dl))
    assert len(kernels) == 1 and "fmmu_commit" in kernels[0], kernels
    graph.replay()
    torch.cuda.synchronize()
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


# ------------------------------------ the commit with its count lanes
def _arm(ms, rng, n_device=100):
    """``ms`` with its ``live`` and ``refcnt`` lanes armed over
    ``n_device`` device blocks (random counts; [C, n_device] on a
    stacked state) and its backing, cached data and table holding ids
    in [-1, n_device + 8): write lanes then unmap and map blocks both
    inside and past the lanes."""
    dev = ms.table.device
    lead = tuple(ms.table.shape[:-1])

    def ids(t):
        return torch.from_numpy(rng.integers(-1, n_device + 8, tuple(
            t.shape)).astype(np.int32)).to(dev)
    lane = (lambda: torch.from_numpy(rng.integers(
        0, 50, lead + (n_device,)).astype(np.int32)).to(dev))
    fm = ms.fmmu._replace(backing=ids(ms.fmmu.backing),
                          data=ids(ms.fmmu.data))
    return ms._replace(fmmu=fm, table=ids(ms.table), live=lane(),
                       refcnt=lane())


@pytest.mark.parametrize("c_n", [1, 8])
@pytest.mark.parametrize("bq", [8, 100, 1024])
@pytest.mark.parametrize("mode", ["translate", "grow"])
def test_armed_fmmu_commit_bit_exact(cuda, c_n, bq, mode):
    """The commit with the ``live`` and ``refcnt`` lanes armed, three
    commits in a row at one channel (the llama serving map) and at 8
    (a paper map cut in 8): the kernel in place against the plain chain
    on a clone, every state tensor (both lanes included) and output bit
    for bit, one launch each. Translate mode mixes UPDATE and
    COND_UPDATE lanes (about half the guards hold) with LOOKUPs; grow
    mode pops from stacks of device ids in and past the lanes."""
    from repro_torch.core.fmmu.types import FMMUGeometry
    from repro_torch.kernels import fmmu_commit as fc
    rng = np.random.default_rng(c_n * 1000 + bq)
    if c_n == 1:
        g = FMMUGeometry(**GEOMETRIES["serving"])
        ms = _commit_state(cuda, rng, g, n_stack=max(bq // 3, 1))
        ms = ms._replace(free_stack=torch.from_numpy(rng.integers(
            0, 108, max(bq // 3, 1)).astype(np.int32)).to(cuda))
    else:
        g, ms = _sharded_state(cuda, rng, c_n, n_stack=bq)
        ms = ms._replace(free_stack=torch.from_numpy(
            (rng.integers(0, 108 // c_n, (c_n, bq)) * c_n
             + np.arange(c_n)[:, None]).astype(np.int32)).to(cuda))
    ms = _arm(ms, rng)
    ker, ref = fb.clone_state(ms), fb.clone_state(ms)
    for it in range(3):
        if c_n == 1:
            op, dl, dp = (a.to(cuda) for a in _commit_lanes(
                rng, g, ms.fmmu, bq, grow=mode == "grow"))
        else:
            op, dl, dp = (a.to(cuda) for a in _sharded_lanes(
                rng, g, ms, bq, grow=mode == "grow"))
        dp = torch.where(dp >= 0, dp % 108, dp)
        n0 = fc.LAUNCHES[0]
        if mode == "grow":
            grow = torch.from_numpy(rng.random(bq) < 0.5).to(cuda)
            if c_n == 1:
                got = fb.serving_grow_(g, ker, grow, dl)
                want = fb.serving_grow_(g, ref, grow, dl, impl="ref")
            else:
                got = fb.grow_sharded_(g, c_n, ker, grow, dl)
                want = fb.grow_sharded_(g, c_n, ref, grow, dl, impl="ref")
        else:
            if c_n == 1:
                out = fb.translate_serving(g, ref, torch.zeros_like(op), dl,
                                           dp, dp, impl="ref")[1]
                old = torch.where(torch.rand(bq, device=cuda) < 0.5, out, dp)
                got = fb.translate_serving_(g, ker, op, dl, dp, old)
                want = fb.translate_serving_(g, ref, op, dl, dp, old,
                                             impl="ref")
            else:
                out = fb.translate_sharded(g, c_n, ref, torch.zeros_like(op),
                                           dl, dp, dp, impl="ref")[1]
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
    assert not torch.equal(ker.live, ms.live)      # the lanes moved
    assert not torch.equal(ker.refcnt, ms.refcnt)


def test_armed_fmmu_commit_repeats_bit_identical(cuda):
    """One 4096-lane commit with both count lanes armed, launched 100
    times on fresh copies of one state: every launch leaves the state
    tensors (both lanes included) and outputs the plain chain leaves."""
    from repro_torch.core.fmmu.types import FMMUGeometry
    g = FMMUGeometry(**GEOMETRIES["paper"])
    rng = np.random.default_rng(4096)
    ms = _arm(_commit_state(cuda, rng, g), rng, n_device=4000)
    op, dl, dp = (a.to(cuda) for a in _commit_lanes(rng, g, ms.fmmu, 4096))
    dp = torch.where(dp >= 0, dp % 4100, dp)
    ref = fb.clone_state(ms)
    want = list(fb.translate_serving_(g, ref, op, dl, dp, dp, impl="ref")) \
        + fb.state_tensors(ref)
    for it in range(100):
        ker = fb.clone_state(ms)
        got = list(fb.translate_serving_(g, ker, op, dl, dp, dp)) + \
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


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b", "gemma2-9b",
                                  "dbrx-132b", "arctic-480b"])
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


@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b"])
def test_moe_macro_replays_match_eager_program(cuda, arch):
    """An MoE model's K-step graphs (the routing, sort, capacity cut and
    scatter of every layer captured with the step): every replay equals
    one eager run of the same program bit for bit (``_check_replays``),
    over all four (simple, forced) variants."""
    eng = _macro_engine(cuda, arch, admit_tokens=12)
    seen = _check_replays(eng, cuda)
    out, _ = _serve(eng, MACRO_REQS)
    assert {(s, f) for s, f, _ in seen} == {(True, True), (True, False),
                                            (False, True), (False, False)}
    assert [len(t) for t in out] == [n for _, n in MACRO_REQS]


def test_macro_capture_never_grows_the_ticket_buffer(cuda, monkeypatch):
    """In a fresh process state the first capture is at page bucket 8
    (paged attention runs one split: no ticket buffer) and the next at
    bucket 16 (two splits): the buffer is grown by that variant's eager
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
    # a 124-token prompt at page 16: ctx 124..127 (8 pages) in the
    # first run, 128..131 (9 pages, bucket 16) in the second
    reqs = [(range(1, 125), 12), (range(100, 110), 12)]
    eng = _macro_engine(cuda, page=16, max_ctx=256)
    got, keys = _serve(eng, reqs)
    cfg = eng.cfg
    splits = {p: pa.plan(eng.n_slots, cfg.n_heads, cfg.n_kv_heads, p, 16,
                         pa._sm_count(torch.cuda.current_device())).n_split
              for p in (8, 16)}
    assert [k[2] for k in keys[:2]] == [(8,) * MACRO_K, (16,) * MACRO_K]
    assert splits[8] == 1 < splits[16]
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


# ------------------------------------------- GC and prefix sharing
# the reference chaos GC shape (watermark 5: the walk moves pages at one
# channel and at two) with prompts that share (three on one 8-token
# prefix) and a tree of 2 nodes, whose pins leave the 12-block pool room
# (chip_smoke.PARITY_PROMPTS)
PLANE_REQS = [(list(range(1, 9)) + [30 + i] * 4, 16) for i in range(3)] + \
    [(range(1 + i, 20 + i), 16) for i in range(3)]
PLANE_SHAPE = dict(max_ctx=64, n_device_blocks=12, n_host_blocks=24,
                   swap_patience=2)


@functools.lru_cache(maxsize=None)
def _smoke():
    """``chip_smoke.py`` as a module, for the helpers the tests share
    with it."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _graph_kernel_nodes(graph, name):
    """Kernel nodes of a kept CUDA graph whose function name holds
    ``name``, through libcuda (``chip_smoke.graph_nodes``)."""
    return _smoke().graph_nodes(graph, (name,))[1][name]


@pytest.mark.parametrize("channels", [1, 2])
def test_gc_and_prefix_engine_replays_match_eager_program(cuda, channels):
    """An oversubscribed K-step engine with the GC/CTP plane and prefix
    sharing armed on the card: every replay equals the eager program on
    clones (``_check_replays``: K fmmu_commit launches a replay, the
    count lanes included in the state compared); walks, copy-on-writes
    and prefetches run eagerly between runs on the graphs' static state
    and capture nothing (one capture per distinct variant); at one
    channel each graph holds one fmmu_commit node a step (libcuda), at
    two none (the pre-committed sharded path); the tokens equal an
    engine with both planes off."""
    from repro_torch.serving import GCConfig, PrefixConfig, macro
    eng = _macro_engine(cuda, channels=channels, **PLANE_SHAPE,
                        gc=GCConfig(5, 8, 2, prefetch=True),
                        prefix=PrefixConfig(min_tokens=8, max_nodes=2))
    seen = _check_replays(eng, cuda) if channels == 1 else []
    if channels > 1:
        run = eng._graphs.run

        def spy(ms, buf, *key):
            seen.append(key)
            return run(ms, buf, *key)
        eng._graphs.run = spy
    c0 = macro.MACRO_CAPTURES[0]
    got, _ = _serve(eng, PLANE_REQS)
    m = eng.metrics
    assert m["gc_moves"] and m["shared_admits"] and m["cow_moves"]
    assert seen and macro.MACRO_CAPTURES[0] - c0 == len(set(seen))
    assert eng._graphs.stats()["graphs"] == len(set(seen))
    for graph in eng._graphs.graphs.values():
        assert _graph_kernel_nodes(graph, "fmmu_commit") == \
            (MACRO_K if channels == 1 else 0)
    st = eng.kvm.state
    assert st.live is not None and st.refcnt is not None
    want, _ = _serve(_macro_engine(cuda, channels=channels, **PLANE_SHAPE),
                     PLANE_REQS)
    assert got == want


# ---------------------------------------------------- the FMMU packet engine
def _fsm_requests(g, seed, n, sequential=False):
    """A trace of the smoke's mix: 3:1 UPDATE to LOOKUP, a tenth
    COND_UPDATE from the GCM queue (half of them with the last value
    written as the old one), over uniform or sequential dlpns."""
    import random
    from repro_torch.core.fmmu.types import (COND_UPDATE, LOOKUP, NIL,
                                             UPDATE, Request)
    rng = random.Random(seed)
    n_pages = g.n_tvpns * g.entries_per_tp
    last, reqs = {}, []
    for rid in range(n):
        d = rid % n_pages if sequential else rng.randrange(n_pages)
        u = rng.random()
        v = rng.randrange(1 << 20)
        if u < 0.1:
            old = last.get(d, NIL) if rng.random() < 0.5 else \
                rng.randrange(1 << 20)
            reqs.append(Request(COND_UPDATE, d, v, old, rid, 1))
        elif u < 0.775:
            last[d] = v
            reqs.append(Request(UPDATE, d, v, NIL, rid, 0))
        else:
            reqs.append(Request(LOOKUP, d, NIL, NIL, rid, 0))
    return reqs


def _fsm_lockstep(engines, g, reqs, seed, outstanding):
    """Drive every engine with the same pushes (up to ``outstanding``
    requests in flight, flash reads answered in shuffled order), one
    ``run`` a round, until quiescent; after every run the step counts
    and every state tensor must be equal, and each kernel run must be
    one fmmu_fsm launch. Ends with flush_all, compared the same way."""
    import random
    from collections import deque
    from repro_torch.kernels import fmmu_fsm
    rng = random.Random(seed)
    pend, out = deque(reqs), 0

    def equal(tag):
        base = engines[0].state
        for e in engines[1:]:
            for name, x, y in zip(type(base)._fields, base, e.state):
                assert torch.equal(x, y), (tag, name)

    rounds = 0
    while True:
        while pend and out < outstanding:
            r = pend.popleft()
            for e in engines:
                e.push_request(r)
            out += 1
        steps = []
        for e in engines:
            n0 = fmmu_fsm.LAUNCHES[0]
            steps.append(e.run())
            assert fmmu_fsm.LAUNCHES[0] - n0 == \
                (0 if e.kernel_impl == "ref" else 1)
        assert len(set(steps)) == 1, steps
        equal(f"round {rounds}")
        drained = [e.drain_outputs() for e in engines]
        assert all(d == drained[0] for d in drained)
        resps, fcs, _ = drained[0]
        out -= len(resps)
        fcs = list(fcs)
        rng.shuffle(fcs)
        for e in engines:
            for t, s, w in fcs:
                e.push_flash_response(t, s, w)
        rounds += 1
        if not pend and not engines[0].pending_work() and not fcs:
            break
    for e in engines:
        e.flush_all()
    equal("flush_all")
    return rounds


FSM_GEOMETRIES = {
    "small": dict(cmt_sets=4, cmt_ways=2, cmt_entries=4, ctp_sets=2,
                  ctp_ways=2, entries_per_tp=16, n_tvpns=8, dtl_entries=4,
                  queue_cap=2048, mshr_cap=4, ctp_mshr_cap=4, tppn_cap=4096),
    "small_tppn_overflow": dict(cmt_sets=4, cmt_ways=2, cmt_entries=4,
                                ctp_sets=2, ctp_ways=2, entries_per_tp=16,
                                n_tvpns=8, dtl_entries=4, queue_cap=2048,
                                mshr_cap=2, ctp_mshr_cap=2, tppn_cap=8),
    "paper": {},
    # no power-of-two divisor but the CMT's entries: the floor_div body
    "divisors": dict(cmt_sets=6, cmt_ways=3, cmt_entries=4, ctp_sets=3,
                     ctp_ways=3, entries_per_tp=12, n_tvpns=5, dtl_entries=5,
                     queue_cap=1000, mshr_cap=3, ctp_mshr_cap=3),
    # a lane for each of 32 ways and 32 entries (37-word packets), 70 DTL
    # entries, 40 CTP MSHR rows, programs past tppn_cap
    "wide": dict(cmt_sets=8, cmt_ways=32, cmt_entries=32, ctp_sets=2,
                 ctp_ways=32, entries_per_tp=64, n_tvpns=40, dtl_entries=70,
                 queue_cap=512, mshr_cap=32, ctp_mshr_cap=40, tppn_cap=300),
}


@pytest.mark.parametrize("geom,n,outstanding", [
    ("small", 600, 64), ("small_tppn_overflow", 300, 16),
    ("paper", 150, 150)])
def test_fmmu_fsm_kernel_equals_plain_on_the_card(cuda, geom, n,
                                                  outstanding):
    """The kernel's run (one launch a call) against the plain step loop
    on the card, bit for bit on all 43 state tensors after every run
    and after flush_all; at the small geometry, and past tppn_cap
    (dropped programs, clamped reads) and at the paper geometry."""
    from repro_torch.core.fmmu.engine import FMMUEngine
    from repro_torch.core.fmmu.types import FMMUGeometry
    g = FMMUGeometry(**FSM_GEOMETRIES[geom])
    kern = FMMUEngine(g, device=cuda)
    ref = FMMUEngine(g, device=cuda, kernel_impl="ref")
    _fsm_lockstep([kern, ref], g, _fsm_requests(g, 1, n), 2, outstanding)
    if geom == "small_tppn_overflow":
        assert int(kern.state.tppn_next) > g.tppn_cap
        assert int(kern.state.gtd.max()) >= g.tppn_cap


def test_fmmu_fsm_run_and_flush_all_never_step_in_torch(cuda, monkeypatch):
    """On a CUDA state, run and flush_all go through the kernel alone
    (every plain entry raises if called); a run's launch does not sync
    the host (the caller reads the step count once)."""
    from repro_torch.core.fmmu import engine as E
    from repro_torch.core.fmmu.types import FMMUGeometry
    from repro_torch.kernels import fmmu_fsm
    g = FMMUGeometry(**FSM_GEOMETRIES["small"])
    eng = E.FMMUEngine(g, device=cuda)
    for r in _fsm_requests(g, 3, 200):
        eng.push_request(r)
    eng.run()                                    # built and loaded once

    def boom(*a, **k):
        raise AssertionError("plain torch step on a CUDA state")
    for name in ("step", "run", "force_flush_one", "force_wb"):
        monkeypatch.setattr(E, name, boom)
    torch.cuda.synchronize()
    n0 = fmmu_fsm.LAUNCHES[0]
    torch.cuda.set_sync_debug_mode("error")
    try:
        steps = fmmu_fsm.fmmu_fsm_run(g, eng.state, 100_000, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fmmu_fsm.LAUNCHES[0] - n0 == 1 and int(steps) > 0
    eng.flush_all()
    assert fmmu_fsm.LAUNCHES[0] - n0 > 1
    assert int(eng.state.cmt_dirty) == 0 and int(eng.state.ctp_dirty) == 0
    assert not eng.pending_work()


def test_fmmu_fsm_divisor_body_equals_plain_on_the_card(cuda):
    """A geometry whose cache divisors are not powers of two (6 x 3 CMT,
    3 x 3 CTP pages of 12 entries, 3 chunks a page, queues of 1000):
    the kernel's floor_div body against the plain step loop, every state
    tensor after every run and after flush_all."""
    from repro_torch.core.fmmu.engine import FMMUEngine
    from repro_torch.core.fmmu.types import FMMUGeometry
    from repro_torch.kernels import fmmu_fsm
    g = FMMUGeometry(**FSM_GEOMETRIES["divisors"])
    assert -1 in list(fmmu_fsm._geom(g))[19:27]
    kern = FMMUEngine(g, device=cuda)
    ref = FMMUEngine(g, device=cuda, kernel_impl="ref")
    _fsm_lockstep([kern, ref], g, _fsm_requests(g, 1, 500), 2, 40)
    assert kern.stats()["steps"] > 500


def test_fmmu_fsm_wide_sets_equal_plain_on_the_card(cuda):
    """Every lane of the control warp busy: 32 ways a CMT and CTP set,
    32 entries a CMT block (a packet of 37 words), 70 DTL entries (the
    last lanes of a scan past the end), 40 CTP MSHR rows; the kernel
    against the plain step loop, every state tensor after every run and
    after flush_all."""
    from repro_torch.core.fmmu.engine import FMMUEngine
    from repro_torch.core.fmmu.types import FMMUGeometry
    g = FMMUGeometry(**FSM_GEOMETRIES["wide"])
    kern = FMMUEngine(g, device=cuda)
    ref = FMMUEngine(g, device=cuda, kernel_impl="ref")
    _fsm_lockstep([kern, ref], g, _fsm_requests(g, 1, 600), 2, 100)
    assert kern.stats()["flush_tvpns"] > 0


def test_fmmu_fsm_paper_geometry_fills_and_programs_on_the_card(cuda):
    """The paper geometry on a miss-heavy trace long enough that
    translation pages are programmed and read back: the copy warps' page
    moves (fills waited for, write-backs started and waited for later),
    the replay from the staged page, against the plain step loop bit for
    bit after every run and after flush_all."""
    from repro_torch.core.fmmu import state as S
    from repro_torch.core.fmmu.engine import FMMUEngine
    from repro_torch.core.fmmu.types import FMMUGeometry
    g = FMMUGeometry()
    kern = FMMUEngine(g, device=cuda)
    ref = FMMUEngine(g, device=cuda, kernel_impl="ref")
    _fsm_lockstep([kern, ref], g, _fsm_requests(g, 1, 1200), 2, 256)
    stats = kern.stats()
    assert stats["programs"] > 0 and stats["fc_reads"] > 0
    assert int(kern.state.qhead[S.Q_FC_RESP]) > 0      # pages filled


def test_fmmu_fsm_oversized_geometry_raises_on_the_card(cuda):
    """A geometry whose resident set exceeds the card's shared memory
    raises ValueError before any launch, and leaves the state as it
    was."""
    from repro_torch.core.fmmu import state as S
    from repro_torch.core.fmmu.types import FMMUGeometry
    from repro_torch.kernels import fmmu_fsm
    g = FMMUGeometry(cmt_sets=4096)
    st = S.init_state(g, cuda)
    before = S.clone_state(st)
    n0 = fmmu_fsm.LAUNCHES[0]
    with pytest.raises(ValueError, match="shared memory"):
        fmmu_fsm.fmmu_fsm_run(g, st, 100)
    assert fmmu_fsm.LAUNCHES[0] == n0
    assert all(torch.equal(x, y) for x, y in zip(st, before))


# ------------------------------------------- GQA groups and the MoE layer
@pytest.mark.parametrize("h,kv", [(16, 8), (48, 8), (56, 8), (64, 8),
                                  (32, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_the_served_gqa_groups(cuda, h, kv, dtype):
    """head_dim 128 at G = 2, 6 (dbrx), 7 (arctic), 8 (qwen2) and 16
    (glm4): paged attention's 16-row head tile runs partly empty below
    16 (f32: its head chunk of 8 partly empty at 6 and 7, twice at 16);
    flash attention maps a query head to its KV head by H / KV. Both
    against their plain versions, paged with (m, l) and repeats
    bit-identical."""
    d, page, maxp, b = 128, 16, 24, 4
    args = _paged_inputs(cuda, b, h, kv, d, page, maxp, dtype, seed=h + kv)
    ctx = torch.tensor([1, 100, 257, maxp * page], dtype=torch.int32,
                       device=cuda)
    for kw in (dict(), dict(window=40, softcap=50.0)):
        got, m, l = _check_paged(args, ctx, dtype, **kw)
        again, (m2, l2) = paged_attention(*args, ctx, return_stats=True,
                                          **kw)
        assert torch.equal(got, again) and torch.equal(m, m2) \
            and torch.equal(l, l2)
    g = torch.Generator(device=cuda).manual_seed(h)
    q, k, v = (torch.randn((1, 300, n, d), generator=g, device=cuda).to(dtype)
               for n in (h, kv, kv))
    for kw in (dict(), dict(window=64, softcap=50.0)):
        torch.testing.assert_close(
            flash_attention(q, k, v, **kw).float(),
            flash_attention_ref(q, k, v, **kw).float(), atol=TOL[dtype],
            rtol=TOL[dtype])


def _moe_cfg(arch, d=256, ff=256):
    """``arch``'s MoE (its experts and top-k) at narrow widths."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    return dataclasses.replace(
        cfg, n_layers=2, d_model=d, d_ff=ff, vocab_size=1024,
        moe=dataclasses.replace(cfg.moe, d_ff=ff))


@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b"])
def test_apply_moe_on_the_card_matches_the_cpu(cuda, arch):
    """apply_moe on the card against the plain CPU result of the same
    weights and tokens (float32, at the default capacity, which drops
    slots here): the same slots kept, the outputs within 1e-4, and
    repeats on the card bit-identical, in float32 and bfloat16."""
    from repro_torch.models import Runtime, build_model, moe
    from repro_torch.models.transformer import layer_params
    cfg = _moe_cfg(arch)
    rt = Runtime(compute_dtype=torch.float32, param_dtype=torch.float32)
    m = build_model(cfg, rt, device="cpu")
    ffn = layer_params(m.init(torch.Generator().manual_seed(0))["stack"],
                       0, 0)["ffn"]
    g = torch.Generator().manual_seed(1)
    x = torch.randn((5, 8, cfg.d_model), generator=g) \
        + torch.randn(cfg.d_model, generator=g)

    def on(tree, dtype=torch.float32):
        """``tree`` on the card in ``dtype``, the router in float32."""
        return {k: on(v, dtype) if isinstance(v, dict)
                else v.to(cuda, torch.float32 if k == "router" else dtype)
                for k, v in tree.items()}

    want, want_aux = moe.apply_moe(ffn["moe"], x, cfg, rt,
                                   dense_params=ffn.get("dense"))
    cap = moe._capacity(40, cfg.moe.n_experts, cfg.moe.top_k,
                        cfg.moe.capacity_factor)
    keep = moe.route(x.view(40, -1), ffn["moe"]["router"], cfg.moe.top_k,
                     cap).keep
    assert not keep.all()
    gffn = on(ffn)
    got, aux = moe.apply_moe(gffn["moe"], x.to(cuda), cfg, rt,
                             dense_params=gffn.get("dense"))
    assert torch.equal(moe.route(x.view(40, -1).to(cuda),
                                 gffn["moe"]["router"], cfg.moe.top_k,
                                 cap).keep.cpu(), keep)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=1e-5)
    for dtype in (torch.float32, torch.bfloat16):
        rtd = Runtime(compute_dtype=dtype, param_dtype=dtype)
        p = on(ffn, dtype)
        xd = x.to(cuda, dtype)
        first = moe.apply_moe(p["moe"], xd, cfg, rtd,
                              dense_params=p.get("dense"))[0]
        for _ in range(3):
            assert torch.equal(first, moe.apply_moe(
                p["moe"], xd, cfg, rtd, dense_params=p.get("dense"))[0])


def test_moe_decode_step_graph_replay_equals_eager_without_host_sync(cuda):
    """A dbrx-shaped MoE decode step (16 experts, top-4, 8 lanes: 4 slots
    an expert for 32, G = 6 at head_dim 128, bf16): run eagerly and
    captured into a CUDA graph under
    ``torch.cuda.set_sync_debug_mode("error")`` (the sort, top-k,
    counts, capacity cut and scatter sync nothing), the replay's logits
    and pools equal the eager step's bit for bit, twice."""
    import dataclasses
    from repro_torch.models import Runtime, build_model
    from repro_torch.models import transformer as ttr
    from repro_torch.serving.macro import capture
    cfg = dataclasses.replace(_moe_cfg("dbrx-132b", d=768, ff=512),
                              n_heads=6, n_kv_heads=1, head_dim=128)
    rt = Runtime(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                 page_size=16)
    m = build_model(cfg, rt, device=cuda)
    params = m.init(torch.Generator(device=cuda).manual_seed(0))
    b, maxp = 8, 8
    nb = b * maxp + 1
    g = torch.Generator(device=cuda).manual_seed(1)
    caches0 = ttr.init_decode_caches(cfg, rt, b, nb, torch.bfloat16,
                                     device=cuda)
    for c in caches0.values():
        c.copy_(torch.randn(c.shape, generator=g, device=cuda))
    table = torch.randperm(nb, generator=g, device=cuda)[:b * maxp].reshape(
        b, maxp).to(torch.int32)
    ctx = torch.randint(1, maxp * 16 - 1, (b,), generator=g, device=cuda,
                        dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (b,), generator=g, device=cuda,
                         dtype=torch.int32)

    def step(caches):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return m.decode_step(params, toks, caches, ctx_lens=ctx,
                                 block_table=table)[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")

    eager = {k: v.clone() for k, v in caches0.items()}
    want = step(eager)
    step({k: v.clone() for k, v in caches0.items()})        # warm-up
    static = {k: v.clone() for k, v in caches0.items()}
    out = []
    graph, _ = capture(lambda: out.append(step(static)))
    for _ in range(2):
        for k, v in static.items():
            v.copy_(caches0[k])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want)
        for k in static:
            assert torch.equal(static[k], eager[k]), k


# ------------------------------------------- segments in the flash kernel
def _valid_ids(lens, s, dev):
    return (torch.arange(s, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)


def _packed_ids(b, s, g, dev):
    """Packed segment ids [b, s]: four runs of seeded lengths a row."""
    cuts = torch.stack([torch.randperm(s - 1, generator=g,
                                       device=dev)[:3].sort().values + 1
                        for _ in range(b)])
    pos = torch.arange(s, device=dev)[None, :, None]
    return (pos >= cuts[:, None, :]).sum(-1).to(torch.int32)


# (tag, B, Sq, Skv, H, KV, D, kwargs, segment ids): the decoder's
# cross-attention at decode (one query, per-lane valid frames, one lane
# with none) and at prefill, the encoder's shape with packed segments,
# and head_dim 128 GQA with packed causal segments and a window
SEG_SHAPES = (
    ("decode_cross", 8, 1, 512, 16, 16, 64, dict(causal=False,
     bidirectional=True), lambda dev, g: (
        torch.ones((8, 1), dtype=torch.int32, device=dev),
        _valid_ids([512, 1, 96, 200, 0, 333, 480, 511], 512, dev))),
    ("prefill_cross", 1, 64, 512, 16, 16, 64, dict(causal=False,
     bidirectional=True), lambda dev, g: (
        torch.ones((1, 64), dtype=torch.int32, device=dev),
        _valid_ids([480], 512, dev))),
    ("encoder_packed", 2, 512, 512, 16, 16, 64, dict(causal=False,
     bidirectional=True), lambda dev, g: (_packed_ids(2, 512, g, dev),) * 2),
    ("d128_packed", 2, 300, 300, 8, 2, 128, dict(window=64),
     lambda dev, g: (_packed_ids(2, 300, g, dev),) * 2),
)


@pytest.mark.parametrize("shape", SEG_SHAPES, ids=[s[0] for s in SEG_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_segments(cuda, shape, dtype):
    """The segmented kernel against the plain version at the slice's
    shapes, one launch a call, and a row with no valid key exactly 0 (in
    both)."""
    _, b, sq, skv, h, kv, d, kw, ids = shape
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, skv, kv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, skv, kv, d), generator=g, device=cuda).to(dtype)
    segs = ids(cuda, g)
    n0 = COUNTERS.launches().get("flash_attention", 0)
    got = flash_attention(q, k, v, segment_ids=segs, **kw)
    assert COUNTERS.launches()["flash_attention"] - n0 == 1
    want = flash_attention_ref(q, k, v, segment_ids=segs, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    empty = segs[1].sum(dim=1) == 0 if sq == 1 else \
        torch.zeros(b, dtype=torch.bool, device=cuda)
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))
    assert torch.equal(want[empty], torch.zeros_like(want[empty]))


def test_flash_attention_segments_rejects_bad_ids(cuda):
    q = torch.zeros((1, 8, 4, 16), device=cuda)
    ones = torch.ones((1, 8), dtype=torch.int32, device=cuda)
    for bad in ((ones.long(), ones), (ones, ones[:, :4]),
                (ones, ones.cpu())):
        with pytest.raises(ValueError):
            flash_attention(q, q, q, segment_ids=bad)


def _embed_engine(cuda, arch, dtype, macro_k):
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import Runtime, build_model
    from repro_torch.serving import ServeConfig, ServeEngine
    m = build_model(smoke_config(get_arch(arch)),
                    Runtime(compute_dtype=dtype, param_dtype=dtype,
                            page_size=8), device=cuda)
    params = m.init(torch.Generator(device=cuda).manual_seed(0))
    return ServeEngine(m, params, config=ServeConfig(
        n_slots=4, max_ctx=128, macro_k=macro_k, admit_tokens=12),
        device=cuda)


def _embed_requests(eng, cuda):
    """MACRO_REQS with seeded source frames (encoder-decoder) or 8
    prefix embeddings on every other request (VLM)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    d, rids = eng.cfg.d_model, []
    for i, (t, n) in enumerate(MACRO_REQS):
        kw = {}
        if eng.cfg.n_enc_layers:
            kw["src_emb"] = 0.02 * torch.randn((16 + 9 * i, d), generator=g,
                                               device=cuda)
        elif i % 2 == 0:
            kw["prefix_emb"] = 0.02 * torch.randn((8, d), generator=g,
                                                  device=cuda)
        rids.append(eng.submit(list(t), max_new=n, **kw))
    return rids


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llava-next-mistral-7b"])
def test_embedding_engine_replays_match_eager_program(cuda, arch):
    """An encoder-decoder's and a VLM's K-step graphs: every replay
    equals one eager run of the same program bit for bit
    (``_check_replays``), over all four (simple, forced) variants; the
    encoder-decoder's graphs hold the segmented flash kernel, one launch
    a decoder layer and step; the tokens equal a single-step engine's
    (bf16)."""
    eng = _embed_engine(cuda, arch, torch.float32, MACRO_K)
    seen = _check_replays(eng, cuda)
    rids = _embed_requests(eng, cuda)
    done = eng.run()
    assert {(s, f) for s, f, _ in seen} == {(True, True), (True, False),
                                            (False, True), (False, False)}
    n_cross = eng.cfg.n_layers if eng.cfg.n_enc_layers else 0
    for delta in eng._graphs.deltas.values():
        assert delta.get("kernel.flash_attention", 0) == MACRO_K * n_cross
    assert [len(done[r]) for r in rids] == [n for _, n in MACRO_REQS]
    toks = {}
    for k in (0, MACRO_K):
        e = _embed_engine(cuda, arch, torch.bfloat16, k)
        rids = _embed_requests(e, cuda)
        out = e.run()
        toks[k] = [out[r] for r in rids]
    assert toks[0] == toks[MACRO_K]


def test_cross_attention_decode_step_graph_without_host_sync(cuda):
    """A seamless-shaped decode step (bf16, 8 lanes, per-lane valid
    frames, one lane with none) run eagerly and captured into a CUDA
    graph under ``torch.cuda.set_sync_debug_mode("error")``: the replay's
    logits and caches equal the eager step's bit for bit, and the graph
    holds one flash kernel node a decoder layer (the cross-attention)."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.kernels._graph import kernel_names
    from repro_torch.models import Runtime, build_model
    from repro_torch.models import transformer as ttr
    from repro_torch.serving.macro import capture
    cfg = smoke_config(get_arch("seamless-m4t-large-v2"))
    rt = Runtime(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                 page_size=16)
    m = build_model(cfg, rt, device=cuda)
    params = m.init(torch.Generator(device=cuda).manual_seed(0))
    b, maxp, src = 8, 8, 128
    nb = b * maxp + 1
    g = torch.Generator(device=cuda).manual_seed(1)
    caches0 = ttr.init_decode_caches(cfg, rt, b, nb, torch.bfloat16,
                                     device=cuda, src_len=src)
    for c in caches0.values():
        c.copy_(torch.randn(c.shape, generator=g, device=cuda))
    table = torch.randperm(nb, generator=g, device=cuda)[:b * maxp].reshape(
        b, maxp).to(torch.int32)
    ctx = torch.randint(1, maxp * 16 - 1, (b,), generator=g, device=cuda,
                        dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (b,), generator=g, device=cuda,
                         dtype=torch.int32)
    valid = _valid_ids([128, 1, 0, 50, 77, 128, 3, 100], src, cuda)

    def step(caches):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return m.decode_step(params, toks, caches, ctx_lens=ctx,
                                 block_table=table, src_valid=valid)[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")

    eager = {k: v.clone() for k, v in caches0.items()}
    want = step(eager)
    step({k: v.clone() for k, v in caches0.items()})        # warm-up
    static = {k: v.clone() for k, v in caches0.items()}
    out = []
    graph, _ = capture(lambda: out.append(step(static)))
    names = kernel_names(graph)
    assert sum("flash_attention" in n for n in names) == cfg.n_layers
    for _ in range(2):
        for k, v in static.items():
            v.copy_(caches0[k])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want)
        for k in static:
            assert torch.equal(static[k], eager[k]), k


# ---------------------------------------------------------------------
# the flash attention backward kernel (training)
BWD_VARIANTS = (
    ("causal", dict(), False), ("window_softcap", dict(window=40,
                                                       softcap=20.0), False),
    ("ids", dict(), True), ("bidirectional_ids",
                            dict(causal=False, bidirectional=True), True),
)


def _bwd_case(cuda, b, sq, skv, h, kv, d, dtype, kw, ids, seed=21):
    from repro_torch.kernels.ref import attention_lse
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, skv, kv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, skv, kv, d), generator=g, device=cuda).to(dtype)
    do = torch.randn((b, sq, h, d), generator=g, device=cuda).to(dtype)
    segs = (_packed_ids(b, sq, g, cuda),) * 2 if ids else None
    out, lse = attention_lse(q, k, v, segment_ids=segs, **kw)
    return q, k, v, out.contiguous(), lse, do, segs


@pytest.mark.parametrize("d,g", [(16, 1), (32, 4), (64, 4), (64, 8),
                                 (128, 1), (128, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_bwd_kernel(cuda, d, g, dtype):
    """The backward kernel against ``flash_attention_bwd_ref`` on the
    same (out, lse): causal, window + softcap, packed ids, bidirectional
    with ids; one launch a call."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref)
    kv = 2
    for _, kw, ids in BWD_VARIANTS:
        args = _bwd_case(cuda, 2, 150, 150, g * kv, kv, d, dtype, kw, ids)
        n0 = COUNTERS.launches().get("flash_attention_bwd", 0)
        got = flash_attention_bwd(*args[:6], segment_ids=args[6], **kw)
        assert COUNTERS.launches()["flash_attention_bwd"] - n0 == 1
        want = flash_attention_bwd_ref(*args[:6], segment_ids=args[6], **kw)
        for x, y in zip(got, want):
            assert x.dtype == dtype
            torch.testing.assert_close(x.float(), y.float(), atol=TOL[dtype],
                                       rtol=TOL[dtype])


def test_flash_attention_bwd_rows_without_keys_and_d256(cuda):
    """Sq > Skv (causal rows before the first key: lse -inf, zero dq),
    and head_dim 256 (gemma2's) in f32 and bf16."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref)
    args = _bwd_case(cuda, 2, 80, 48, 4, 2, 64, torch.float32, {}, False)
    got = flash_attention_bwd(*args[:6])
    want = flash_attention_bwd_ref(*args[:6])
    assert torch.isinf(args[4][:, :, :32]).all()
    assert not got[0][:, :32].abs().sum()
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4)
    for dtype in (torch.float32, torch.bfloat16):
        kw = dict(window=50, softcap=50.0)
        args = _bwd_case(cuda, 1, 130, 130, 4, 2, 256, dtype, kw, True)
        got = flash_attention_bwd(*args[:6], segment_ids=args[6], **kw)
        want = flash_attention_bwd_ref(*args[:6], segment_ids=args[6], **kw)
        for x, y in zip(got, want):
            torch.testing.assert_close(x.float(), y.float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])


def _crossing_ids(b, s, dev, shuffled=False, seed=4):
    """Segment ids [b, s] int32 whose documents cross 64- and 32-row
    tile edges (runs of 5..83 rows); ``shuffled``: the same ids in a
    seeded random order (no tile skip can help)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(b):
        lens = rng.integers(5, 84, s)
        ids = np.repeat(np.arange(len(lens)), lens)[:s]
        rows.append(rng.permutation(ids) if shuffled else ids)
    return torch.tensor(np.stack(rows), dtype=torch.int32, device=dev)


# (tag, Sq, Skv, kwargs, ids): the tensor-core backward's cases
BWD_TC_CASES = (
    ("causal", 192, 192, dict(), None),
    ("rows_before_first_key", 230, 150, dict(), None),
    ("sq_lt_skv", 70, 200, dict(), None),
    ("window_softcap", 200, 200, dict(window=45, softcap=20.0), None),
    ("packed_across_tiles", 260, 260, dict(), "packed"),
    ("shuffled_ids", 130, 130, dict(), "shuffled"),
    ("bidirectional_packed", 150, 150,
     dict(causal=False, bidirectional=True), "packed"),
    ("cross_packed", 130, 260, dict(), "packed"),
    ("cross_packed_bidirectional", 130, 260,
     dict(causal=False, bidirectional=True), "packed"),
)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_bwd_tensor_core_bodies(cuda, d, g, dtype):
    """The bf16 / f16 tensor-core bodies at head_dim 64 and 128, G = 1 /
    4 / 8, against ``flash_attention_bwd_ref`` on the same (out, lse):
    causal, Sq > Skv (rows before the first key: lse -inf, zero dq),
    Sq < Skv, window + softcap, packed ids whose documents cross tile
    edges, shuffled ids, bidirectional with ids, and ids at Sq < Skv
    (the queries carry the ids of the last Sq key positions), causal and
    bidirectional; one launch a call."""
    _hold_bwd_tc_cases(cuda, d, g, dtype)


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_bwd_d256_tensor_core_bodies(cuda, g, dtype):
    """The head_dim 256 bodies (eight warps, dQ / dK / dV split along D,
    P and dS staged in shared memory) at G = 1 / 2 / 8 against
    ``flash_attention_bwd_ref`` on the same (out, lse), at the cases of
    the head_dim 64 / 128 bodies: the window binding (45 of 200), ids
    whose documents cross the 32- and 64-row tile edges, shuffled ids,
    Sq < Skv, Sq > Skv (rows with no key: zero dq), bidirectional; one
    launch a call."""
    _hold_bwd_tc_cases(cuda, 256, g, dtype)


def _hold_bwd_tc_cases(cuda, d, g, dtype):
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref)
    from repro_torch.kernels.ref import attention_lse
    kv = 2
    gen = torch.Generator(device=cuda).manual_seed(31)
    for tag, sq, skv, kw, ids in BWD_TC_CASES:
        q, do = (torch.randn((2, sq, g * kv, d), generator=gen,
                             device=cuda).to(dtype) for _ in range(2))
        k, v = (torch.randn((2, skv, kv, d), generator=gen,
                            device=cuda).to(dtype) for _ in range(2))
        segs = None
        if ids:
            seg = _crossing_ids(2, skv, cuda, shuffled=ids == "shuffled")
            segs = (seg[:, skv - sq:].contiguous(), seg)
        out, lse = attention_lse(q, k, v, segment_ids=segs, **kw)
        args = (q, k, v, out.contiguous(), lse, do)
        n0 = COUNTERS.launches().get("flash_attention_bwd", 0)
        got = flash_attention_bwd(*args, segment_ids=segs, **kw)
        assert COUNTERS.launches()["flash_attention_bwd"] - n0 == 1
        want = flash_attention_bwd_ref(*args, segment_ids=segs, **kw)
        for x, y in zip(got, want):
            assert x.dtype == dtype
            torch.testing.assert_close(x.float(), y.float(), atol=TOL[dtype],
                                       rtol=TOL[dtype], msg=tag)
        if tag == "rows_before_first_key":
            dead = sq - skv
            assert torch.isinf(lse[:, :, :dead]).all()
            assert not got[0][:, :dead].abs().sum()


def test_flash_attention_fwd_equal_ids_bit_identical_to_no_ids(cuda):
    """Ids all equal give the no-ids output bit for bit, with and
    without the lse (the four instantiations of each tensor-core body:
    head_dim 64 and 128, and the eight-warp body at 256), and the same
    lse."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    gen = torch.Generator(device=cuda).manual_seed(8)
    for dtype in (torch.bfloat16, torch.float16):
        for d in (64, 128, 256):
            for sq, skv, kw in ((300, 300, dict()),
                                (90, 260, dict(window=70, softcap=20.0)),
                                (1, 512, dict(causal=False,
                                              bidirectional=True))):
                q = torch.randn((2, sq, 8, d), generator=gen,
                                device=cuda).to(dtype)
                k, v = (torch.randn((2, skv, 2, d), generator=gen,
                                    device=cuda).to(dtype) for _ in range(2))
                segs = (torch.full((2, sq), 7, dtype=torch.int32,
                                   device=cuda),
                        torch.full((2, skv), 7, dtype=torch.int32,
                                   device=cuda))
                plain = flash_attention_fwd(q, k, v, **kw)
                assert torch.equal(flash_attention_fwd(
                    q, k, v, segment_ids=segs, **kw), plain)
                out, lse = flash_attention_fwd(q, k, v, with_lse=True, **kw)
                out_s, lse_s = flash_attention_fwd(
                    q, k, v, segment_ids=segs, with_lse=True, **kw)
                assert torch.equal(out, plain) and torch.equal(out_s, plain)
                assert torch.equal(lse, lse_s)


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_fwd_d256_tensor_core_body(cuda, g, dtype):
    """The forward's head_dim 256 body (eight warps, S split by key
    columns and O by D, P staged in shared memory, the id-span tile
    skip) at G = 1 / 2 / 8 against ``attention_lse`` on out and lse, at
    the backward's cases: the window binding (45 of 200) with softcap,
    ids whose documents cross the 32- and 64-row tile edges, shuffled
    ids, Sq < Skv, Sq > Skv (rows with no key: 0, lse -inf),
    bidirectional with ids; one launch a call."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import attention_lse
    kv, d = 2, 256
    gen = torch.Generator(device=cuda).manual_seed(33)
    for tag, sq, skv, kw, ids in BWD_TC_CASES:
        q = torch.randn((2, sq, g * kv, d), generator=gen,
                        device=cuda).to(dtype)
        k, v = (torch.randn((2, skv, kv, d), generator=gen,
                            device=cuda).to(dtype) for _ in range(2))
        segs = None
        if ids:
            seg = _crossing_ids(2, skv, cuda, shuffled=ids == "shuffled")
            segs = (seg[:, skv - sq:].contiguous(), seg)
        n0 = COUNTERS.launches().get("flash_attention", 0)
        out, lse = flash_attention_fwd(q, k, v, segment_ids=segs,
                                       with_lse=True, **kw)
        assert COUNTERS.launches()["flash_attention"] - n0 == 1
        want, want_lse = attention_lse(q, k, v, segment_ids=segs, **kw)
        assert out.dtype == dtype
        torch.testing.assert_close(out.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype], msg=tag)
        dead = torch.isinf(want_lse)
        assert torch.equal(torch.isinf(lse), dead), tag
        torch.testing.assert_close(lse[~dead], want_lse[~dead], atol=1e-4,
                                   rtol=1e-4, msg=tag)
        assert not out.transpose(1, 2)[dead].abs().sum(), tag
        if tag == "rows_before_first_key":
            assert dead[:, :, :sq - skv].all()


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_fwd_relabelled_ids_bit_identical(cuda, d):
    """Ids relabelled (each document's label mapped through a seeded
    permutation: the same mask, other tile spans, so the id-span skip
    walks other key tiles) give out and lse bit for bit, with and
    without lse, causal, at Sq < Skv and bidirectional, in bf16 and
    f16: a tile the skip drops has every entry masked."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import fwd_tile_walk
    gen = torch.Generator(device=cuda).manual_seed(12)
    rng = np.random.default_rng(12)
    tiles = (64, 64) if d <= 128 else (64, 32)
    walked_other = False
    for dtype in (torch.bfloat16, torch.float16):
        for sq, skv, kw in ((300, 300, dict(softcap=20.0)),
                            (130, 260, dict()),
                            (260, 260, dict(causal=False,
                                            bidirectional=True))):
            q = torch.randn((2, sq, 8, d), generator=gen,
                            device=cuda).to(dtype)
            k, v = (torch.randn((2, skv, 2, d), generator=gen,
                                device=cuda).to(dtype) for _ in range(2))
            seg = _crossing_ids(2, skv, cuda)
            labels = torch.tensor(
                rng.permutation(int(seg.max()) + 1) * 7 - 40,
                dtype=torch.int32, device=cuda)
            other = labels[seg.long()]
            runs = []
            for ids in (seg, other):
                segs = (ids[:, skv - sq:].contiguous(), ids)
                runs.append(flash_attention_fwd(q, k, v, segment_ids=segs,
                                                with_lse=True, **kw) +
                            (flash_attention_fwd(q, k, v, segment_ids=segs,
                                                 **kw),))
                walk_kw = {n: x for n, x in kw.items() if n != "softcap"}
                runs[-1] += (fwd_tile_walk(
                    sq, skv, tiles, segment_ids=tuple(x.cpu() for x in segs),
                    **walk_kw),)
            for a, b in zip(runs[0][:3], runs[1][:3]):
                assert torch.equal(a, b), (d, dtype, sq, skv, kw)
            walked_other |= not torch.equal(runs[0][3], runs[1][3])
    assert walked_other


@pytest.mark.parametrize("ids", [False, True])
@pytest.mark.parametrize("d", [64, 256])
def test_flash_attention_fwd_one_kernel_a_call(cuda, ids, d):
    """One forward call, with lse and ids or without, captured in a CUDA
    graph is one kernel node of the body its head_dim takes (the id
    spans are reduced inside it: no other launch, no scratch), and one
    count."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    args = _bwd_case(cuda, 2, 200, 200, 4, 2, d, torch.bfloat16, {}, ids)
    n0 = COUNTERS.launches().get("flash_attention", 0)
    _, names = _graph_kernels(lambda: flash_attention_fwd(
        *args[:3], segment_ids=args[6], with_lse=True))
    assert COUNTERS.launches()["flash_attention"] - n0 == 1
    body = ("flash_attention_wide_tc_kernel<" if d == 256
            else "flash_attention_tc_kernel<")
    assert len(names) == 1 and body in names[0], names


def test_flash_attention_bwd_repeats_bit_identical(cuda):
    """No float atomics: 100 calls at a packed GQA shape give the same
    bits."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    args = _bwd_case(cuda, 2, 300, 300, 32, 8, 64, torch.bfloat16, {}, True)
    first = flash_attention_bwd(*args[:6], segment_ids=args[6])
    for _ in range(100):
        again = flash_attention_bwd(*args[:6], segment_ids=args[6])
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_attention_bwd_d256_repeats_bit_identical(cuda):
    """No float atomics in the head_dim 256 bodies either: 100 calls at
    gemma2's heads (16 / 8) with packed ids and softcap 50 give the same
    bits."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    kw = dict(softcap=50.0)
    args = _bwd_case(cuda, 2, 300, 300, 16, 8, 256, torch.bfloat16, kw,
                     True)
    first = flash_attention_bwd(*args[:6], segment_ids=args[6], **kw)
    for _ in range(100):
        again = flash_attention_bwd(*args[:6], segment_ids=args[6], **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("ids", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_bwd_d256_kernels_a_call(cuda, ids, dtype):
    """One head_dim 256 call captured in a CUDA graph holds the eight-warp
    route's kernel nodes and nothing else: its dq and dk/dv kernels, and
    with ids first the two span launches (key tiles, query tiles). The
    counter takes one count a call."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    args = _bwd_case(cuda, 1, 200, 200, 4, 2, 256, dtype, {}, ids)
    n0 = COUNTERS.launches().get("flash_attention_bwd", 0)
    _, names = _graph_kernels(
        lambda: flash_attention_bwd(*args[:6], segment_ids=args[6]))
    assert COUNTERS.launches()["flash_attention_bwd"] - n0 == 1
    parts = {"flash_bwd_dq_wide_tc_kernel<": 1,
             "flash_bwd_dkdv_wide_tc_kernel<": 1,
             "flash_bwd_spans_kernel": 2 if ids else 0}
    assert len(names) == sum(parts.values()), names
    for part, n in parts.items():
        assert sum(part in k for k in names) == n, (part, names)


def test_flash_attention_fwd_lse(cuda):
    """The forward's lse against ``attention_lse`` (both bodies), and
    serving's output unchanged by asking for it."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import attention_lse
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for kw, ids in ((dict(), True), (dict(window=30, softcap=10.0),
                                         False)):
            q, k, v, _, want, _, segs = _bwd_case(
                cuda, 2, 140, 140, 8, 2, 64, dtype, kw, ids)
            out, lse = flash_attention_fwd(q, k, v, segment_ids=segs,
                                           with_lse=True, **kw)
            torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-4)
            assert torch.equal(out, flash_attention_fwd(
                q, k, v, segment_ids=segs, **kw))


def test_flash_attention_grads_on_cuda_equal_cpu(cuda):
    """``ops.flash_attention`` under autograd on the card (forward and
    backward kernels) against autograd of the plain version on the
    CPU, f32 and bf16, packed ids and GQA."""
    from repro_torch.kernels import ops
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _, _, do, segs = _bwd_case(cuda, 2, 200, 200, 8, 2, 64,
                                            dtype, {}, True)
        grads = []
        for dev in (cuda, torch.device("cpu")):
            xs = [t.detach().to(dev).requires_grad_(True) for t in (q, k, v)]
            sg = tuple(s.to(dev) for s in segs)
            n0 = COUNTERS.launches().get("flash_attention_bwd", 0)
            out = ops.flash_attention(*xs, segment_ids=sg)
            grads.append([out] + list(torch.autograd.grad(out, xs,
                                                          do.to(dev))))
            n1 = COUNTERS.launches().get("flash_attention_bwd", 0)
            assert n1 - n0 == (1 if dev.type == "cuda" else 0)
        for a, b in zip(*grads):
            torch.testing.assert_close(a.float().cpu(), b.float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])


def test_train_step_flash_launch_counts(cuda):
    """One smoke llama train step on the card (bf16 compute, remat
    'dots'): per layer one forward launch, one more when the backward
    recomputes the period, and one backward launch; loss finite."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import Runtime, build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    cfg = smoke_config(get_arch("llama3.2-1b"))
    for remat, fwd_per_layer in (("dots", 2), ("none", 1)):
        m = build_model(cfg, Runtime(remat=remat), device=cuda)
        step, init = make_train_step(m, opt.AdamWConfig(lr=1e-3))
        state = init(torch.Generator(device=cuda).manual_seed(0))
        batch = make_batch(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=128, global_batch=2), 0)
        COUNTERS.reset()
        state, metrics = step(state, batch)
        n = COUNTERS.launches()
        assert torch.isfinite(metrics["loss"])
        assert n["flash_attention"] == fwd_per_layer * cfg.n_layers
        assert n["flash_attention_bwd"] == cfg.n_layers


def test_train_step_gemma2_on_card(cuda):
    """One gemma2-9b train step on the card at its published widths and
    2 layers (a local and a global one; bf16 compute, f32 parameters,
    remat 'dots', 2 x 256 packed tokens): the loss and the gradient norm
    finite, per layer two flash_attention launches and one
    flash_attention_bwd launch (the head_dim 256 route)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import Runtime, build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    cfg = dataclasses.replace(get_arch("gemma2-9b"), n_layers=2)
    m = build_model(cfg, Runtime(compute_dtype=torch.bfloat16,
                                 param_dtype=torch.float32, remat="dots"),
                    device=cuda)
    step, init = make_train_step(m, opt.AdamWConfig(lr=1e-4))
    state = init(torch.Generator(device=cuda).manual_seed(0))
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                  global_batch=2), 0)
    COUNTERS.reset()
    state, metrics = step(state, batch)
    n = COUNTERS.launches()
    assert torch.isfinite(metrics["loss"])
    assert torch.isfinite(metrics["grad_norm"])
    assert n["flash_attention"] == 2 * cfg.n_layers
    assert n["flash_attention_bwd"] == cfg.n_layers
    del m, state
    torch.cuda.empty_cache()


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
def test_train_step_embedding_family_kernel_vs_ref(cuda, arch):
    """One smoke-size f32 training step's loss and gradients of the
    embedding families on the card, with the kernels against
    kernel_impl="ref" from one seeded state (remat 'dots', 2 unpacked
    rows of 128 tokens): llava with 8 seeded prefix embeddings before
    each row, seamless with 24 source frames, the second row's first 9
    valid. The loss within 1e-5 relative, every gradient leaf within
    1e-4 of its largest magnitude; the flash backward launched once a
    mixer site (seamless: encoder self-, decoder self- and
    cross-attention) and the forward twice."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import Runtime, build_model
    from repro_torch.training.train_loop import to_device, trainable
    from repro_torch.training.tree import leaves
    cfg = smoke_config(get_arch(arch))
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=2, pack=False), 0)
    rng = np.random.default_rng(0)
    if cfg.prefix_len:
        del batch["positions"]
        batch["prefix_emb"] = (0.02 * rng.standard_normal(
            (2, 8, cfg.d_model))).astype(np.float32)
    if cfg.n_enc_layers:
        batch["src_emb"] = (0.02 * rng.standard_normal(
            (2, 24, cfg.d_model))).astype(np.float32)
        batch["src_valid"] = (np.arange(24)[None, :]
                              < np.array([[24], [9]])).astype(np.int32)
    runs = {}
    for impl in (None, "ref"):
        m = build_model(cfg, Runtime(compute_dtype=torch.float32,
                                     param_dtype=torch.float32,
                                     remat="dots", kernel_impl=impl),
                        device=cuda)
        params = trainable(m.init(torch.Generator(device=cuda).manual_seed(0)))
        COUNTERS.reset()
        loss, _ = m.loss_fn(params, to_device(batch, m.device))
        grads = torch.autograd.grad(loss, leaves(params))
        runs[impl] = (float(loss.detach()), [g.cpu() for g in grads],
                      COUNTERS.launches())
    sites = cfg.n_enc_layers + cfg.n_layers * (2 if cfg.n_enc_layers else 1)
    (l_k, g_k, n_k), (l_r, g_r, _) = runs[None], runs["ref"]
    assert n_k["flash_attention_bwd"] == sites
    assert n_k["flash_attention"] == 2 * sites
    assert abs(l_k - l_r) <= 1e-5 * abs(l_r)
    for i, (a, b) in enumerate(zip(g_k, g_r)):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max(), i


def test_scan_and_paged_refuse_grad(cuda):
    """The raw kernel wrappers without a backward raise under autograd
    on the card instead of returning a result that carries no gradient
    (the scan's raw forward wrapper too: only ``ops.mamba_chunk_scan``,
    through ``MambaChunkScanFn``, differentiates it); under no_grad they
    run."""
    from repro_torch.kernels import ops
    x = torch.randn((1, 64, 2, 16), device=cuda, requires_grad=True)
    dt = torch.rand((1, 64, 2), device=cuda)
    a = -torch.rand(2, device=cuda)
    bc = torch.randn((1, 64, 16), device=cuda)
    with pytest.raises(NotImplementedError, match="MambaChunkScanFn"):
        mamba_chunk_scan(x, dt, a, bc, bc, torch.ones(2, device=cuda),
                         chunk=32)
    with torch.no_grad():
        mamba_chunk_scan(x, dt, a, bc, bc, torch.ones(2, device=cuda),
                         chunk=32)
        ops.mamba_chunk_scan(x, dt, a, bc, bc, torch.ones(2, device=cuda),
                             chunk=32)
    q = torch.randn((2, 4, 16), device=cuda, requires_grad=True)
    pool = torch.randn((5, 8, 2, 16), device=cuda)
    table = torch.arange(4, dtype=torch.int32, device=cuda).reshape(2, 2)
    ctx = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError):
        ops.paged_attention(q, pool, pool, table, ctx)
    ops.paged_attention(q.detach(), pool, pool, table, ctx)
    # the plain versions stay differentiable (impl="ref")
    out = ops.paged_attention(q, pool, pool, table, ctx, impl="ref")
    assert out.requires_grad


# ---------------------------------------------------------------- the
# scan's backward (training)
def _scan_bwd_case(cuda, bt, s, h, p, n, dtype, init, dfinal):
    """Inputs in mamba2's ranges (init_ssm's dt and A) and cotangents:
    ((x, dt, A, B, C, D, dy, dfinal), the initial state or None), drawn
    as the smoke draws them (``chip_smoke.scan_bwd_inputs``)."""
    return _smoke().scan_bwd_inputs(bt, s, h, p, n, dtype, init, dfinal)


def _hold_scan_grads(got, want, dtype):
    """The smoke's gate (``chip_smoke.scan_grad_errs``): f32 each
    gradient within 1e-4 of its max |value|; bf16 dx, dB, dC (rounded to
    bf16) within 1e-2 of max(1, |want|) element by element, the f32
    outputs within 1e-4 of their max; every gradient finite, None where
    the plain version's is."""
    share, worst = _smoke().scan_grad_errs(got, want, dtype)
    assert share <= 1.0, (share, worst)


@pytest.mark.parametrize("bt,s,h,p,n,init,dfinal", [
    (2, 100, 4, 64, 16, False, False), (2, 100, 4, 64, 16, True, True),
    (1, 64, 3, 80, 16, True, False), (2, 33, 2, 16, 16, False, True),
    (1, 256, 4, 64, 128, False, False), (2, 130, 3, 64, 128, True, True),
    (1, 1, 2, 64, 128, True, True), (1, 200, 20, 48, 128, True, True),
    (2, 70, 9, 20, 16, True, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_chunk_scan_bwd_kernel(cuda, bt, s, h, p, n, init, dfinal,
                                     dtype):
    """The backward kernel against ``mamba_chunk_scan_bwd_ref`` on the
    same inputs, both d_states and dtypes, ragged S and P (80: the bf16
    first version's two row slices; 48 and 20 on the tensor-core body,
    20 with element loads), more than one group of eight heads (the last
    partial), with and without an initial state and dfinal; one count a
    call."""
    from repro_torch.kernels.mamba_scan import (mamba_chunk_scan_bwd,
                                                mamba_chunk_scan_bwd_ref)
    args, s0 = _scan_bwd_case(cuda, bt, s, h, p, n, dtype, init, dfinal)
    n0 = COUNTERS.launches().get("mamba_chunk_scan_bwd", 0)
    got = mamba_chunk_scan_bwd(*args, initial_state=s0)
    assert COUNTERS.launches()["mamba_chunk_scan_bwd"] - n0 == 1
    assert got[0].dtype == got[3].dtype == got[4].dtype == dtype
    assert all(t.dtype == torch.float32 for t in got[1:3] + got[5:6])
    want = mamba_chunk_scan_bwd_ref(*args, initial_state=s0)
    _hold_scan_grads(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_chunk_scan_bwd_repeats_bit_identical(cuda, dtype):
    """mamba2's widths (H=64 P=64 N=128) at S=300: ten calls equal bit
    for bit (a fixed-order reduction, no float atomics)."""
    from repro_torch.kernels.mamba_scan import mamba_chunk_scan_bwd
    args, s0 = _scan_bwd_case(cuda, 2, 300, 64, 64, 128, dtype, True, True)
    first = mamba_chunk_scan_bwd(*args, initial_state=s0)
    for _ in range(10):
        again = mamba_chunk_scan_bwd(*args, initial_state=s0)
        assert all(torch.equal(u, v) for u, v in zip(first, again))


@pytest.mark.parametrize("n", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_chunk_scan_bwd_kernels_a_call(cuda, n, dtype):
    """One call captured in a CUDA graph holds the kernel nodes of its
    route and nothing else that launches a kernel: bf16 (P = 64) three,
    the tensor-core body's walk, chunk-local gradients and fixed-order
    reduction; f32 two, the first version's scan and its reduction. The
    counter takes one count a call."""
    from repro_torch.kernels.mamba_scan import mamba_chunk_scan_bwd
    args, s0 = _scan_bwd_case(cuda, 2, 100, 4, 64, n, dtype, True, True)
    n0 = COUNTERS.launches().get("mamba_chunk_scan_bwd", 0)
    _, names = _graph_kernels(
        lambda: mamba_chunk_scan_bwd(*args, initial_state=s0))
    assert COUNTERS.launches()["mamba_chunk_scan_bwd"] - n0 == 1
    if dtype == torch.bfloat16:
        parts = ("mamba_scan_bwd_walk<", "mamba_scan_bwd_grads<",
                 "mamba_scan_bwd_tc_reduce(")
    else:
        parts = ("mamba_scan_bwd_kernel<", "mamba_scan_bwd_reduce<")
    assert len(names) == len(parts), names
    for part in parts:
        assert sum(part in k for k in names) == 1, (part, names)


def test_mamba_chunk_scan_grads_on_cuda_equal_cpu(cuda):
    """``ops.mamba_chunk_scan`` under autograd on the card (forward
    kernel, then the backward kernel through ``MambaChunkScanFn``)
    against autograd of the plain scan on the CPU, f32 and bf16, with
    the final state used."""
    from repro_torch.kernels import ops
    for dtype in (torch.float32, torch.bfloat16):
        args, s0 = _scan_bwd_case(cuda, 2, 70, 3, 64, 16, dtype, True,
                                  True)
        x, dt, a, b, c, d, dy, df = args
        grads = []
        for dev in (cuda, torch.device("cpu")):
            leaves = [t.detach().to(dev).requires_grad_(True)
                      for t in (x, dt, a, b, c, d, s0)]
            n0 = COUNTERS.launches().get("mamba_chunk_scan_bwd", 0)
            y, fin = ops.mamba_chunk_scan(*leaves[:6], chunk=32,
                                          initial_state=leaves[6])
            loss = (y.float() * dy.to(dev).float()).sum() + \
                (fin * df.to(dev)).sum()
            grads.append(torch.autograd.grad(loss, leaves))
            n1 = COUNTERS.launches().get("mamba_chunk_scan_bwd", 0)
            assert n1 - n0 == (1 if dev.type == "cuda" else 0)
        _hold_scan_grads(grads[0], grads[1], dtype)


def test_train_step_mamba_launch_counts(cuda):
    """One smoke mamba2 train step on the card (bf16 compute): per layer
    one scan forward launch, one more when the backward recomputes the
    period under remat 'dots', and one backward launch; loss finite."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import Runtime, build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    cfg = smoke_config(get_arch("mamba2-1.3b"))
    for remat, fwd_per_layer in (("dots", 2), ("none", 1)):
        m = build_model(cfg, Runtime(remat=remat), device=cuda)
        step, init = make_train_step(m, opt.AdamWConfig(lr=1e-3))
        state = init(torch.Generator(device=cuda).manual_seed(0))
        batch = make_batch(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=128, global_batch=2), 0)
        COUNTERS.reset()
        state, metrics = step(state, batch)
        n = COUNTERS.launches()
        assert torch.isfinite(metrics["loss"])
        assert n["mamba_chunk_scan"] == fwd_per_layer * cfg.n_layers
        assert n["mamba_chunk_scan_bwd"] == cfg.n_layers
