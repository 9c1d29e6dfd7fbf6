"""The port's CUDA kernels against their plain torch versions on the
card (marker ``gpu``; each test skips without a CUDA device). Imports no
JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.counters import COUNTERS  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.fmmu_translate import (  # noqa: E402
    fmmu_translate, fmmu_translate_ref)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_ref)

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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
