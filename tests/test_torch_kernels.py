"""The port's plain kernel versions against the JAX Pallas kernels run
in interpret mode on the CPU, on the small shapes of
tests/test_kernels_pallas.py. The same numpy inputs (from a seed) go
into both packages. Attention is held within TOL (f32 2e-5, bf16 2e-2);
the fused translate probe and the probe-only lookup are held bit-exact
on every output. (The Mamba2 scan is in tests/test_torch_ssm.py.)"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import fmmu_lookup as jfl  # noqa: E402
from repro.kernels import fmmu_translate as jft  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.counters import COUNTERS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.fmmu_lookup import fmmu_lookup  # noqa: E402
from repro_torch.kernels.fmmu_translate import fmmu_translate  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(a, dtype="float32"):
    """One numpy array -> (jax array, torch tensor) of the same values
    (bf16 rounding from f32 is round-to-nearest-even on both sides)."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
        return jnp.asarray(a).astype(JDT[dtype]), \
            torch.from_numpy(a).to(TDT[dtype])
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if
                      jnp.issubdtype(x.dtype, jnp.floating) else x)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("sq,skv,h,kv,d", [
    (128, 128, 4, 4, 32),
    (128, 128, 4, 2, 64),     # GQA
    (64, 192, 2, 1, 32),      # cross-length (right-aligned causal)
    (256, 256, 2, 2, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ref_vs_pallas(sq, skv, h, kv, d, dtype):
    rng = np.random.default_rng(0)
    q, tq = _both(rng.standard_normal((2, sq, h, d)), dtype)
    k, tk = _both(rng.standard_normal((2, skv, kv, d)), dtype)
    v, tv = _both(rng.standard_normal((2, skv, kv, d)), dtype)
    want = jfa.flash_attention(q, k, v, causal=True, q_block=64,
                               kv_block=64, interpret=True)
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == TDT[dtype] and got.shape == (2, sq, h, d)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("kwargs", [
    dict(window=64), dict(softcap=30.0), dict(window=96, softcap=20.0),
    dict(causal=False, bidirectional=True),
])
def test_flash_attention_ref_variants_vs_pallas(kwargs):
    rng = np.random.default_rng(1)
    q, tq = _both(rng.standard_normal((1, 256, 4, 64)))
    k, tk = _both(rng.standard_normal((1, 256, 2, 64)))
    v, tv = _both(rng.standard_normal((1, 256, 2, 64)))
    kwargs.setdefault("causal", True)
    want = jfa.flash_attention(q, k, v, q_block=64, kv_block=64,
                               interpret=True, **kwargs)
    got = flash_attention(tq, tk, tv, **kwargs)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["float32"],
                               rtol=TOL["float32"])


def test_flash_attention_ref_unaligned_seq_vs_pallas():
    rng = np.random.default_rng(2)
    q, tq = _both(rng.standard_normal((1, 100, 2, 32)))
    k, tk = _both(rng.standard_normal((1, 100, 2, 32)))
    v, tv = _both(rng.standard_normal((1, 100, 2, 32)))
    want = jfa.flash_attention(q, k, v, q_block=64, kv_block=64,
                               interpret=True)
    got = flash_attention(tq, tk, tv)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["float32"],
                               rtol=TOL["float32"])


def test_flash_attention_segment_ids_raise():
    t = torch.zeros((1, 8, 2, 16))
    with pytest.raises(NotImplementedError):
        flash_attention(t, t, t, segment_ids=(t, t))
    with pytest.raises(NotImplementedError):
        ops.flash_attention(t, t, t, segment_ids=(t, t))


# ----------------------------------------------------------------------
def _paged_inputs(rng, b, h, kv, d, page, maxp, dtype, ctx=None):
    nb = b * maxp + 4
    q = _both(rng.standard_normal((b, h, d)), dtype)
    kp = _both(rng.standard_normal((nb, page, kv, d)), dtype)
    vp = _both(rng.standard_normal((nb, page, kv, d)), dtype)
    table = _both(rng.permutation(nb)[:b * maxp].reshape(b, maxp)
                  .astype(np.int32))
    if ctx is None:
        ctx = [(maxp * page * (i + 1)) // (b + 1) + 1 for i in range(b)]
    ctx = _both(np.asarray(ctx, np.int32))
    return q, kp, vp, table, ctx


@pytest.mark.parametrize("b,h,kv,d,page,maxp", [
    (2, 4, 4, 32, 16, 8),
    (3, 8, 2, 64, 8, 6),      # GQA
    (1, 4, 1, 128, 32, 4),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_ref_vs_pallas(b, h, kv, d, page, maxp, dtype):
    rng = np.random.default_rng(3)
    args = _paged_inputs(rng, b, h, kv, d, page, maxp, dtype)
    want, (wm, wl) = jpa.paged_attention(*[a[0] for a in args],
                                         return_stats=True, interpret=True)
    got, (m, l) = paged_attention(*[a[1] for a in args], return_stats=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    np.testing.assert_allclose(_np(m), _np(wm), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(l), _np(wl), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kwargs", [dict(softcap=25.0), dict(window=13),
                                    dict(window=5, softcap=10.0)])
def test_paged_attention_ref_variants_vs_pallas(kwargs):
    rng = np.random.default_rng(4)
    args = _paged_inputs(rng, 2, 4, 2, 32, 8, 4, "float32", ctx=[17, 30])
    want = jpa.paged_attention(*[a[0] for a in args], interpret=True,
                               **kwargs)
    got = paged_attention(*[a[1] for a in args], **kwargs)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5, rtol=3e-5)


def test_paged_attention_ctx0_lane_returns_zero_like_pallas():
    """A ctx=0 lane skips every page in the Pallas kernel and returns 0
    (m=-1e30, l=0); the port's plain version returns the same (the jnp
    oracles return the mean of the masked values instead)."""
    rng = np.random.default_rng(5)
    args = _paged_inputs(rng, 3, 4, 2, 16, 8, 4, "float32", ctx=[0, 9, 0])
    want, (wm, wl) = jpa.paged_attention(*[a[0] for a in args],
                                         return_stats=True, interpret=True)
    got, (m, l) = paged_attention(*[a[1] for a in args], return_stats=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    assert (_np(got)[[0, 2]] == 0).all()
    np.testing.assert_array_equal(_np(m)[[0, 2]], _np(wm)[[0, 2]])
    np.testing.assert_array_equal(_np(l)[[0, 2]], 0.0)


def test_combine_partial_attention_vs_reference():
    """The port's combine (the plain version of the paged kernel's
    in-launch reduction) against the reference's on the same numpy
    partials, empty splits (m = -1e30, l = 0) and an all-empty lane
    included."""
    rng = np.random.default_rng(6)
    k, b, h, d = 5, 3, 4, 16
    outs = rng.standard_normal((k, b, h, d)).astype(np.float32)
    ms = (3 * rng.standard_normal((k, b, h))).astype(np.float32)
    ls = rng.uniform(0.5, 40.0, (k, b, h)).astype(np.float32)
    empty = rng.random((k, b, h)) < 0.3
    empty[:, 2, 1] = True                       # a lane with no key at all
    ms[empty], ls[empty], outs[empty] = -1e30, 0.0, 0.0
    want = jref.combine_partial_attention(
        jnp.asarray(outs), jnp.asarray(ms), jnp.asarray(ls))
    got, (m, l) = tref.combine_partial_attention(
        torch.from_numpy(outs), torch.from_numpy(ms), torch.from_numpy(ls),
        return_stats=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(_np(got)[2, 1], 0.0)
    np.testing.assert_array_equal(_np(m), ms.max(axis=0))
    assert _np(l)[2, 1] == 0.0 and _np(m)[2, 1] == np.float32(-1e30)


def _split_partials(args, page, pps, window):
    """paged_attention_naive over each range of ``pps`` pages, lane by
    lane, with the lane's context and window moved into the range."""
    q, kp, vp, table, ctx = args
    b, maxp = table.shape
    outs, ms, ls = [], [], []
    for p0 in range(0, maxp, pps):
        pn = min(pps, maxp - p0)
        o_k, m_k, l_k = [], [], []
        for i in range(b):
            c = int(ctx[i])
            ck = min(max(c - p0 * page, 0), pn * page)
            wk = 0
            if window:
                lo = max(c - window, 0) - p0 * page   # first live row, local
                if lo > 0:
                    wk = ck - lo
                    if wk <= 0:                       # wholly below window
                        ck, wk = 0, 0
            o, (m, l) = tref.paged_attention_naive(
                q[i:i + 1], kp, vp, table[i:i + 1, p0:p0 + pn],
                torch.tensor([ck], dtype=torch.int32), window=wk,
                return_stats=True)
            o_k.append(o.float())
            m_k.append(m)
            l_k.append(l)
        outs.append(torch.cat(o_k))
        ms.append(torch.cat(m_k))
        ls.append(torch.cat(l_k))
    return torch.stack(outs), torch.stack(ms), torch.stack(ls)


@pytest.mark.parametrize("page,maxp,pps", [(16, 8, 2), (8, 12, 5), (4, 9, 1)])
@pytest.mark.parametrize("window", [0, 21])
def test_paged_split_partials_combine_to_whole(page, maxp, pps, window):
    """Split-context flash-decoding in plain torch: the partials of page
    ranges, combined, equal one pass over the whole table (f32, 1e-5),
    with a ctx = 0 lane, a ctx at a split boundary and one past it."""
    rng = np.random.default_rng(7)
    edge = pps * page
    ctx = [0, 1, edge, edge + 1, maxp * page, maxp * page // 2 + 3]
    args = [a[1] for a in _paged_inputs(rng, len(ctx), 8, 2, 16, page,
                                        maxp, "float32", ctx=ctx)]
    outs, ms, ls = _split_partials(args, page, pps, window)
    got, (m, l) = tref.combine_partial_attention(outs, ms, ls,
                                                 return_stats=True)
    want, (wm, wl) = tref.paged_attention_naive(*args, window=window,
                                                return_stats=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(m), _np(wm), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(l), _np(wl), atol=1e-5, rtol=1e-5)
    assert (_np(got)[0] == 0).all() and (_np(l)[0] == 0).all()


@pytest.mark.parametrize("b,h,kv,maxp,page", [
    (8, 32, 8, 64, 16), (8, 32, 8, 128, 16), (1, 32, 8, 4, 16),
    (3, 8, 2, 6, 8), (2, 8, 2, 2, 256), (64, 32, 8, 128, 16),
    (2, 24, 2, 33, 16), (4, 4, 4, 0, 16), (1, 4, 1, 512, 16)])
def test_paged_plan_covers_every_page_from_shapes(b, h, kv, maxp, page):
    """The paged kernel's launch plan: whole pages per split, every page
    in exactly one split, no split past the table, no split under one
    64-row tile unless the table is, at most MAX_SPLITS splits; at the
    llama serving shape (8 slots, ctx 1024, 132 SMs) at least 2 blocks
    per SM."""
    from repro_torch.kernels import paged_attention as pa
    pl = pa.plan(b, h, kv, maxp, page, 132)
    g = h // kv
    assert pl.heads_per_block in (1, 4, 8)
    assert pl.head_chunks * pl.heads_per_block >= g
    assert (pl.head_chunks - 1) * pl.heads_per_block < g
    assert 1 <= pl.n_split <= pa.MAX_SPLITS and pl.pages_per_split >= 1
    if maxp:
        assert (pl.n_split - 1) * pl.pages_per_split < maxp
        assert pl.n_split * pl.pages_per_split >= maxp
        if pl.n_split > 1:
            assert pl.pages_per_split * page >= pa.MIN_SPLIT_TOKENS
    if (b, maxp) == (8, 64):
        assert b * kv * pl.head_chunks * pl.n_split >= 2 * 132
        assert 128 <= pl.pages_per_split * page <= 256


@pytest.mark.parametrize("b,h,kv,page,n_sm", [
    (8, 32, 8, 16, 132), (4, 4, 2, 16, 132), (1, 32, 8, 16, 132),
    (64, 32, 8, 16, 132), (3, 8, 2, 8, 114), (2, 8, 2, 256, 132)])
def test_paged_plan_split_length_ignores_table_width(b, h, kv, page, n_sm):
    """The split length comes from (b, h, kv, page, n_sm) alone: the
    same pages_per_split at table widths 16, 64, 128 and 256, so a wider
    table only appends splits (which hold no live page of a context the
    narrower table covers), and n_split splits cover the table."""
    from repro_torch.kernels import paged_attention as pa
    plans = {w: pa.plan(b, h, kv, w, page, n_sm) for w in (16, 64, 128, 256)}
    assert len({p.pages_per_split for p in plans.values()}) == 1
    for w, p in plans.items():
        assert p.n_split * p.pages_per_split >= w
        assert (p.n_split - 1) * p.pages_per_split < w
        assert p.heads_per_block == plans[16].heads_per_block


@pytest.mark.parametrize("b,h,kv,page,n_sm", [
    (8, 32, 8, 16, 132), (1, 32, 8, 16, 132), (2, 8, 2, 256, 132),
    (3, 8, 2, 8, 114)])
def test_paged_plan_wide_tables_grow_splits_in_steps(b, h, kv, page, n_sm):
    """Past MAX_SPLITS splits of the width-free length, a table takes
    splits of that length times the least power of two that keeps them
    at most MAX_SPLITS: every width up to MAX_SPLITS such splits keeps
    the width-free length, and widths inside one step share theirs."""
    from repro_torch.kernels import paged_attention as pa
    base = pa.plan(b, h, kv, 1, page, n_sm).pages_per_split
    edge = base * pa.MAX_SPLITS
    for w in (edge - 1, edge, edge + 1, 2 * edge, 2 * edge + 1, 3 * edge,
              100_000):
        pl = pa.plan(b, h, kv, w, page, n_sm)
        step = pl.pages_per_split // base
        assert pl.pages_per_split == base * step and step & (step - 1) == 0
        assert pl.n_split <= pa.MAX_SPLITS
        assert (pl.n_split - 1) * pl.pages_per_split < w
        assert pl.n_split * pl.pages_per_split >= w
        assert (step == 1) == (w <= edge)
        if step > 1:            # the least such power of two
            assert -(-w // (pl.pages_per_split // 2)) > pa.MAX_SPLITS
    assert pa.plan(b, h, kv, edge + 1, page, n_sm).pages_per_split == \
        pa.plan(b, h, kv, 2 * edge, page, n_sm).pages_per_split


# ----------------------------------------------------------------------
def _translate_inputs(seed, n_sets, n_ways, e, bq, np_sz, dup_tags=False):
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 64, (n_sets, n_ways)) * n_sets \
        + np.arange(n_sets)[:, None]
    if dup_tags:                      # degenerate: a block in two ways
        tags[:, -1] = tags[:, 0]
    valid = rng.random((n_sets, n_ways)) < 0.7
    if dup_tags:
        valid[:, 0] = valid[:, -1] = True
    refb = rng.random((n_sets, n_ways)) < 0.3
    # values cross 1<<24: host-tier ids must come out exact
    data = rng.integers(-1, 1 << 26, (n_sets, n_ways, e))
    backing = rng.integers(-1, 1 << 26, (np_sz,))
    # dlpns below 0 (inactive) and beyond NP (clipped read)
    dlpns = rng.integers(-2, np_sz + 3, (bq,))
    dlpns[-5:] = [np_sz, np_sz + 2, -1, -2, -1]
    if dup_tags:                      # make sure duplicated blocks are hit
        dlpns[: n_sets] = tags[:, 0] * e + 1
    touch = rng.random((bq,)) < 0.6
    return [tags.astype(np.int32), valid, refb, data.astype(np.int32),
            backing.astype(np.int32), dlpns.astype(np.int32), touch]


@pytest.mark.parametrize("n_sets,n_ways,e,bq,np_sz,dup", [
    (8, 2, 4, 64, 256, False), (16, 4, 8, 300, 5000, False),
    (4, 1, 4, 33, 100, False), (8, 4, 8, 64, 512, True),
    (16, 4, 8, 1024, 1024, False)])
def test_fmmu_translate_ref_bit_exact_vs_pallas(n_sets, n_ways, e, bq, np_sz,
                                                dup):
    arrs = _translate_inputs(7, n_sets, n_ways, e, bq, np_sz, dup)
    want = jft.fmmu_translate(*[jnp.asarray(a) for a in arrs],
                              entries_per_block=e, block_size=32,
                              backing_chunk=96, interpret=True)
    got = fmmu_translate(*[torch.from_numpy(a.copy()) for a in arrs],
                         entries_per_block=e)
    for name, g, w in zip(["hit", "dppn", "set", "way", "ref"], got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    assert got[1].dtype == torch.int32 and got[4].dtype == torch.bool
    assert (_np(got[1]) >= 1 << 24).any()       # ids past f32's range
    inactive = arrs[5] < 0
    assert inactive.any()
    assert (_np(got[1])[inactive] == -1).all()
    # floor semantics: dlpn -1 reports set S-1, as jnp does
    m1 = arrs[5] == -1
    if m1.any():
        assert (_np(got[2])[m1] == n_sets - 1).all()


@pytest.mark.parametrize("n_sets,n_ways,e,bq,np_sz,dup", [
    (8, 2, 4, 64, 256, False), (16, 4, 8, 300, 5000, True),
    (4, 1, 4, 33, 100, False), (512, 4, 8, 1024, 16384, False)])
def test_fmmu_lookup_ref_bit_exact_vs_pallas(n_sets, n_ways, e, bq, np_sz,
                                             dup):
    """Data values past 1<<24 come out exact on both sides (the Pallas
    kernel moves them as 16-bit halves); inactive lanes miss with -1."""
    tags, valid, _, data, _, dlpns, _ = _translate_inputs(
        11, n_sets, n_ways, e, bq, np_sz, dup)
    k = min(n_sets, bq - 5)                 # a hit in each of k sets
    valid[:k, 0] = True
    dlpns[:k] = tags[:k, 0] * e + np.arange(k) % e
    arrs = [tags, valid, data, dlpns]
    want = jfl.fmmu_lookup(*[jnp.asarray(a) for a in arrs],
                           entries_per_block=e, block_size=32,
                           interpret=True)
    want_ref = jref.fmmu_lookup_ref(*[jnp.asarray(a) for a in arrs],
                                    entries_per_block=e)
    got = fmmu_lookup(*[torch.from_numpy(a.copy()) for a in arrs],
                      entries_per_block=e)
    for name, g, w, r in zip(["hit", "dppn", "set", "way"], got, want,
                             want_ref):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(_np(g), np.asarray(r), err_msg=name)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    assert _np(got[0]).any() and (_np(got[1]) >= 1 << 24).any()
    assert (_np(got[1])[dlpns < 0] == -1).all()
    assert (_np(got[2])[dlpns == -1] == n_sets - 1).all()


def test_fmmu_lookup_ref_exact_on_block_ids_past_f32_range():
    """Block ids at and above 1<<24 compare as integers: a query one
    block id off a cached tag misses (the TPU kernel's f32 compare
    would alias the two), the exact id hits."""
    n_sets, n_ways, e = 4, 2, 4
    base = (1 << 24) * n_sets                      # block id, set 0
    tags = np.asarray([[base, base + 4 * n_sets]] + [[-1, -1]] * 3,
                      np.int32)
    valid = np.zeros((n_sets, n_ways), bool)
    valid[0] = True
    data = np.arange(n_sets * n_ways * e, dtype=np.int32).reshape(
        n_sets, n_ways, e) + (1 << 25)
    # same set 0 in both: base and base + n_sets (one set-stride away,
    # equal to base in f32)
    dl = np.asarray([base * e + 1, (base + n_sets) * e + 1,
                     (base + 4 * n_sets) * e + 3], np.int32)
    assert np.float32(base) == np.float32(base + n_sets)
    args = [torch.from_numpy(a) for a in (tags, valid, data, dl)]
    hit, dppn, set_idx, way = fmmu_lookup(*args, entries_per_block=e)
    want = jref.fmmu_lookup_ref(*[jnp.asarray(a) for a in
                                  (tags, valid, data, dl)],
                                entries_per_block=e)
    for g, w in zip((hit, dppn, set_idx, way), want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert hit.tolist() == [True, False, True]
    assert dppn.tolist() == [int(data[0, 0, 1]), -1, int(data[0, 1, 3])]


def test_dispatch_follows_tensor_device_and_impl():
    arrs = [torch.from_numpy(a.copy()) for a in
            _translate_inputs(3, 8, 2, 4, 40, 128)]
    before = COUNTERS.launches()
    a = ops.fmmu_translate(*arrs, entries_per_block=4)
    b = ops.fmmu_translate(*arrs, entries_per_block=4, impl="ref")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # CPU tensors take the plain version: no kernel launch is counted
    assert COUNTERS.launches() == before
    with pytest.raises(ValueError):
        ops.fmmu_translate(*arrs, entries_per_block=4, impl="pallas")
    look = [arrs[i] for i in (0, 1, 3, 5)]
    for x, y in zip(ops.fmmu_lookup(*look, entries_per_block=4),
                    ops.fmmu_lookup(*look, entries_per_block=4, impl="ref")):
        assert torch.equal(x, y)
    assert COUNTERS.launches() == before


def test_port_imports_neither_jax_nor_repro():
    """Every module of repro_torch imports with jax and repro blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "assert 'repro_torch.kernels.fmmu_commit' in mods\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 25
