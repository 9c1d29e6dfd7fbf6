"""The port's CUDA kernels against their plain torch versions on the
card (marker ``gpu``; each test skips without a CUDA device). Imports no
JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.counters import COUNTERS  # noqa: E402
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


def test_paged_attention_one_launch_per_call(cuda):
    """One kernel on the device per call, split combine included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = _paged_inputs(cuda, 8, 32, 8, 64, 16, 64, torch.bfloat16)
    ctx = torch.full((8,), 1024, dtype=torch.int32, device=cuda)
    paged_attention(*args, ctx)                # counters allocated once
    torch.cuda.synchronize()
    n0 = COUNTERS.launches()["paged_attention"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        paged_attention(*args, ctx)
        torch.cuda.synchronize()
    assert COUNTERS.launches()["paged_attention"] - n0 == 1
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
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
    tensor-core body: one device kernel per call, named for its body."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args, s0 = _scan_model_inputs(cuda, 1, 200, 4, 64, 128, dtype, True)
    _scan_held(args, s0, dtype)
    for _ in range(2):        # a first profile after a while warms CUPTI
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mamba_chunk_scan(*args, chunk=256, initial_state=s0)
            torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA and "mamba" in e.name]
    assert len(kernels) == 1 and f"{body}<" in kernels[0], kernels


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


def _state_clone(ms):
    from repro_torch.serving import macro
    return macro._with_tensors(ms, [t.clone() for t in macro._tensors(ms)])


def test_macro_graph_replay_matches_eager_program(cuda):
    """Every replay against one eager run of the same K-step program on
    clones of the same map state and caches: tokens, oob, map state and
    caches bit-identical, and the replay's launch counts equal the eager
    run's. The runs take the simple, full and forced variants, with the
    page bucket alternating 4 / 8 between rounds, so graphs of two
    buckets are replayed in turns."""
    from repro_torch.serving import macro
    eng = _macro_engine(cuda, admit_tokens=12)
    graphs = eng._graphs
    replay = graphs.run
    seen = []

    def checked(ms, buf, simple, forced, pages):
        ms0 = _state_clone(ms)
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
        for a, b in zip(macro._tensors(st), macro._tensors(ms_e)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for n, c in eng.caches.items():
            assert torch.equal(c, caches0[n]), n
        assert {k: n1[k] - n0.get(k, 0) for k in n1} == \
            {k: n2[k] - n1.get(k, 0) for k in n2}
        assert n1["fmmu_translate"] - n0.get("fmmu_translate", 0) == MACRO_K
        seen.append((simple, forced, pages))
        return st, out

    graphs.run = checked
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
    K fmmu_translate launches (and K per attention layer of
    paged_attention) counted per replay."""
    from repro_torch.serving import macro
    eng = _macro_engine(cuda, arch)
    eng.min_page_bucket = 16          # one bucket for the whole test
    for t in (range(1, 9), range(20, 31)):
        eng.submit(list(t), max_new=10 ** 6)
    done: dict = {}
    eng.step(done)                    # admission, prefill, first capture
    ms0 = _state_clone(eng.kvm.state)
    caches0 = {n: c.clone() for n, c in eng.caches.items()}
    before = COUNTERS.snapshot()
    eng._graphs._capture((False, True, (16,) * MACRO_K))  # not yet used
    torch.cuda.synchronize()
    d = COUNTERS.delta(before)
    assert d.pop("engine.macro_captures") == 1
    assert not any(d.values()), d
    for a, b in zip(macro._tensors(eng.kvm.state), macro._tensors(ms0)):
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
        assert d["kernel.fmmu_translate"] == MACRO_K
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
    at step 2 of the first K-step run. Paged attention's split plan, and
    so its rounding, follows the table's width, so that run must cut
    its tables to bucket 4 for steps 0-1 and 8 for steps 2-3, as single
    steps do: tokens and the KV pools are then bit-identical."""
    reqs = [(range(1, 63), 13), (range(200, 240), 13), (range(300, 320), 13)]
    dt = torch.bfloat16
    eng = _macro_engine(cuda, dtype=dt, page=16, max_ctx=256)
    got, keys = _serve(eng, reqs)
    assert keys[0][2] == (4, 4, 8, 8)
    single = _macro_engine(cuda, dtype=dt, page=16, max_ctx=256, macro_k=0)
    want, _ = _serve(single, reqs)
    assert got == want
    live = eng.scratch_block                     # the last block: scratch
    for name in ("pool_k", "pool_v"):
        assert torch.equal(eng.caches[name][:, :, :live],
                           single.caches[name][:, :, :live]), name
