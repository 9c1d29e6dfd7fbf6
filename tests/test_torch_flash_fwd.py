"""The flash forward kernels' tile walk on the CPU: ``ref.fwd_tile_walk``
(the causal / window key range, then the segment-id span skip) and
``ref.flash_attention_fwd_blocked`` (the online softmax over that walk)
held against ``attention_lse`` at 1e-5 in f32, under packed, shuffled
and relabelled ids, causal, windowed and bidirectional masks, Sq < Skv
and Sq > Skv, and rows with no key; the walk never drops a tile pair
that holds a visible pair, and relabelled ids (the same mask, other tile
spans) give the blocked walk's out and lse bit for bit. Pure torch (the
reference's blocked lowering is held in ``test_torch_kernels.py``)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.kernels import ref  # noqa: E402

TOL = 1e-5                       # float32, summation order
# the kernels' (q tile rows, key tile rows): head_dim 16-128 and 256
TILES = {"d128": (64, 64), "d256": (64, 32)}
MASKS = {"causal": dict(), "window": dict(window=37, softcap=5.0),
         "bidirectional": dict(causal=False, bidirectional=True)}
SHAPES = {"square": (130, 130), "sq_lt_skv": (70, 160),
          "sq_gt_skv": (160, 70)}


def _ids(kind, b, sq, skv, rng):
    """(seg_q, seg_k) int32 [B,Sq] / [B,Skv]: ``packed``: documents of
    mean length 12 (crossing the 32- and 64-row tile edges), right-aligned
    between the queries and keys; ``shuffled``: the same ids permuted
    along the sequence; ``relabelled``: packed, each document's label
    mapped through a seeded permutation (the same mask, other spans);
    ``foreign``: packed, with some query ids that no key carries (rows
    with no key)."""
    s = max(sq, skv)
    seg = np.cumsum(rng.random((b, s)) < 1 / 12, axis=1).astype(np.int32)
    if kind == "shuffled":
        seg = rng.permuted(seg, axis=1)
    elif kind == "relabelled":
        seg = relabel(seg, rng)
    seg_q, seg_k = seg[:, s - sq:].copy(), seg[:, s - skv:].copy()
    if kind == "foreign":
        seg_q[:, ::9] = -5
    return torch.from_numpy(seg_q), torch.from_numpy(seg_k)


def relabel(seg, rng):
    """ids mapped through a permutation of their labels, spread and
    shifted below zero: equal ids stay equal, unequal ones unequal."""
    labels = (rng.permutation(int(seg.max()) + 1) * 7 - 40).astype(np.int32)
    return labels[seg]


def _inputs(b, sq, skv, h, kv, d, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g)
    k, v = (torch.randn((b, skv, kv, d), generator=g) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("ids", ["none", "packed", "shuffled", "relabelled",
                                 "foreign"])
def test_fwd_blocked_matches_attention_lse(ids, mask, tiles):
    """The blocked walk's (out, lse) equal ``attention_lse`` within 1e-5
    at every shape of SHAPES (Sq == Skv, Sq < Skv, Sq > Skv: causal rows
    before the first key have no key), G = 2; rows with no valid key are
    0 with lse -inf in both."""
    kw = MASKS[mask]
    rng = np.random.default_rng(7)
    for n, (sq, skv) in enumerate(SHAPES.values()):
        q, k, v = _inputs(2, sq, skv, 4, 2, 16, n)
        segs = None if ids == "none" else _ids(ids, 2, sq, skv, rng)
        got, got_lse = ref.flash_attention_fwd_blocked(
            q, k, v, segment_ids=segs, tiles=TILES[tiles], **kw)
        want, want_lse = ref.attention_lse(q, k, v, segment_ids=segs, **kw)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        dead = torch.isinf(want_lse)
        assert torch.equal(torch.isinf(got_lse), dead)
        torch.testing.assert_close(got_lse[~dead], want_lse[~dead],
                                   atol=TOL, rtol=TOL)
        assert not got.transpose(1, 2)[dead].abs().sum()
        if ids == "foreign" or (mask != "bidirectional" and sq > skv):
            assert dead.any()


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("ids", ["packed", "shuffled", "relabelled"])
def test_fwd_walk_never_drops_a_visible_pair(ids, mask, tiles):
    """Every (q tile, key tile) pair that holds a visible (query, key)
    pair is walked, at each shape of SHAPES; with packed ids the walk
    drops tile pairs that the causal / window range alone would keep."""
    kw = MASKS[mask]
    causal = kw.get("causal", True) and not kw.get("bidirectional", False)
    rq, rk = TILES[tiles]
    walk_kw = {n: x for n, x in kw.items() if n != "softcap"}
    rng = np.random.default_rng(11)
    dropped = 0
    for sq, skv in SHAPES.values():
        segs = _ids(ids, 3, sq, skv, rng)
        _, _, vis = ref._attention_logits(
            torch.zeros((3, sq, 1, 4)), torch.zeros((3, skv, 1, 4)),
            causal=causal, window=kw.get("window", 0), softcap=0.0,
            segment_ids=segs, bidirectional=False)
        nq, nk = -(-sq // rq), -(-skv // rk)
        held = torch.nn.functional.pad(
            vis[:, 0], (0, nk * rk - skv, 0, nq * rq - sq)).reshape(
                3, nq, rq, nk, rk).any(4).any(2)
        walk = ref.fwd_tile_walk(sq, skv, (rq, rk), segment_ids=segs,
                                 **walk_kw)
        assert not (held & ~walk).any(), (sq, skv)
        dropped += int((ref.fwd_tile_walk(sq, skv, (rq, rk), **walk_kw)
                        & ~walk).sum())
    assert dropped > 0 or ids != "packed"


@pytest.mark.parametrize("tiles", sorted(TILES))
@pytest.mark.parametrize("mask", ["causal", "bidirectional"])
def test_relabelled_ids_give_the_blocked_walk_bit_for_bit(mask, tiles):
    """Relabelled ids walk other tiles (a skipped tile's entries are all
    masked, so a walked one adds p = 0 with alpha = 1): the blocked
    walk's out and lse equal the packed ids' bit for bit."""
    kw = MASKS[mask]
    rng = np.random.default_rng(3)
    sq = skv = 200
    q, k, v = _inputs(2, sq, skv, 4, 2, 16, 1)
    seg_q, seg_k = _ids("packed", 2, sq, skv, rng)
    other = torch.from_numpy(relabel(seg_q.numpy(), rng))
    walks = [ref.fwd_tile_walk(sq, skv, TILES[tiles], segment_ids=(s, s),
                               **kw) for s in (seg_q, other)]
    assert not torch.equal(*walks)
    got = [ref.flash_attention_fwd_blocked(
        q, k, v, segment_ids=(s, s), tiles=TILES[tiles], **kw)
        for s in (seg_q, other)]
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])
