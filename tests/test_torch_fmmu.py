"""The port's batched FMMU map path against the JAX reference: every
``ServingMapState``/``BatchFMMUState`` leaf bit-identical to JAX
``translate_serving`` after each random mixed-op batch (duplicate
blocks, set overflow, host-tier ids, inactive and out-of-contract
lanes), the port's unfused three-call path (``*_unfused``, the
``fmmu_lookup`` probe) bit-identical to JAX's and to the port's own
fused path on order-insensitive batches, and the port's
``KVPageManager`` bit-identical to the JAX manager under random
new/extend/free interleavings. The device allocator transitions
(``alloc_serving``, ``free_serving``, ``set_allocator``,
``serving_grow``) are bit-identical to JAX's, and a grow commit with
every lane masked changes nothing. Inputs come from a seeded numpy
generator and go into both packages."""
import functools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fmmu_lockstep import _split_order_sensitive  # noqa: E402
from repro.core.fmmu import batch as JB  # noqa: E402
from repro.core.fmmu.types import small_geometry as j_small  # noqa: E402
from repro.paging.kv_manager import KVPageManager as JKVM  # noqa: E402
from repro.paging.pool import OutOfBlocks as JOOB  # noqa: E402
from repro_torch.core.fmmu import batch as TB  # noqa: E402
from repro_torch.core.fmmu.types import (COND_UPDATE, HOST_BASE, LOOKUP,  # noqa: E402
                                         NIL, UPDATE, small_geometry)
from repro_torch.paging import kv_manager as TKM  # noqa: E402
from repro_torch.paging.kv_manager import KVPageManager as TKVM  # noqa: E402
from repro_torch.paging.pool import OutOfBlocks as TOOB  # noqa: E402

CPU = torch.device("cpu")
BQ = 48      # lanes per batch, padded with inactive lanes


def _assert_state_equal(t_state, j_state, tag):
    """Every leaf: same values AND same dtype (int32 lanes, bool flags)."""
    for name in t_state._fields:
        tv, jv = getattr(t_state, name), getattr(j_state, name)
        if name == "fmmu":
            _assert_state_equal(tv, jv, f"{tag}.fmmu")
            continue
        if tv is None or jv is None:
            assert tv is None and jv is None, f"{tag}.{name}"
            continue
        jn = np.asarray(jv)
        tn = tv.numpy()
        assert tn.dtype == jn.dtype, f"{tag}.{name}: {tn.dtype} vs {jn.dtype}"
        np.testing.assert_array_equal(tn, jn, err_msg=f"{tag}.{name}")


def _gen_batch(rng, g, shadow, overflow):
    """One mixed-op batch. Write dlpns are unique (the caller contract);
    lookups may repeat; several lanes share cache blocks (MSHR merge);
    with ``overflow`` more than W new blocks land in one set and a few
    lookups address past the map (the clipped read)."""
    n_pages = g.n_tvpns * g.entries_per_tp
    e = g.cmt_entries
    n_blocks = n_pages // e
    blocks = rng.choice(n_blocks, size=int(rng.integers(1, 9 if overflow
                                                        else 4)),
                        replace=False)
    dl = []
    for b in blocks:
        dl += [int(b) * e + int(x) for x in
               rng.choice(e, size=int(rng.integers(1, 4)), replace=False)]
    lanes = []
    for d in dl:
        op = int(rng.choice([LOOKUP, UPDATE, UPDATE, COND_UPDATE]))
        if rng.random() < 0.1:
            dp = NIL                          # unmap (a free)
        elif rng.random() < 0.3:
            dp = HOST_BASE + int(rng.integers(0, 1 << 20))   # host tier
        else:
            dp = int(rng.integers(0, 4096))
        cur = shadow.get(d, NIL)
        old = cur if rng.random() < 0.6 else int(rng.integers(-1, 4096))
        lanes.append((op, d, dp, old))
    for d in rng.choice(dl, size=int(rng.integers(0, 4))):   # dup reads
        lanes.append((LOOKUP, int(d), 0, 0))
    for _ in range(int(rng.integers(0, 3))):                 # inactive
        lanes.append((int(rng.integers(0, 3)), -1, 5, 5))
    if overflow and rng.random() < 0.5:
        lanes.append((LOOKUP, n_pages + int(rng.integers(0, 9)), 0, 0))
    order = rng.permutation(len(lanes))
    # pad to one lane count (inactive lanes change nothing) so the JAX
    # side compiles once
    arr = np.asarray([lanes[i] for i in order]
                     + [(LOOKUP, -1, 0, 0)] * (BQ - len(lanes)), np.int32)
    return arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]


@pytest.mark.parametrize("seed,geom_kw,overflow", [
    (0, {}, False), (1, {}, True), (2, dict(cmt_sets=8, cmt_ways=4), True),
    (3, dict(cmt_sets=2, cmt_ways=1), True)])
def test_translate_serving_bit_identical_to_jax(seed, geom_kw, overflow):
    g = small_geometry(**geom_kw)
    jg = j_small(**geom_kw)
    rng = np.random.default_rng(seed)
    n_dev, n_lanes = 12, 3
    ts = TB.init_serving_state(g, n_dev, n_lanes, device=CPU)
    js = JB.init_serving_state(jg, n_dev, 0, n_lanes)
    _assert_state_equal(ts, js, "init")
    shadow = {}
    n_pages = g.n_tvpns * g.entries_per_tp
    jfn = jax.jit(functools.partial(JB.translate_serving, jg))
    for it in range(40):
        opc, dl, dp, old = _gen_batch(rng, g, shadow, overflow)
        js, jout, jok = jfn(
            js, jnp.asarray(opc), jnp.asarray(dl), jnp.asarray(dp),
            jnp.asarray(old))
        ts, tout, tok = TB.translate_serving(
            g, ts, *(torch.from_numpy(a.copy()) for a in (opc, dl, dp, old)))
        _assert_state_equal(ts, js, f"batch {it}")
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert tout.dtype == torch.int32 and tok.dtype == torch.bool
        # the shadow map (pre-batch reads, writes applied together)
        for o, d, p, od in zip(opc, dl, dp, old):
            if 0 <= d < n_pages:
                cur = shadow.get(int(d), NIL)
                if o == UPDATE or (o == COND_UPDATE and cur == od):
                    shadow[int(d)] = int(p)
    # table == shadow, host-tier ids exact
    table = ts.table.numpy()
    for d, p in shadow.items():
        assert table[d] == p
    assert (table >= HOST_BASE).any()
    assert int(ts.fmmu.stats[2]) > 0                  # fills happened


def test_batch_wrappers_bit_identical_to_jax():
    g, jg = small_geometry(), j_small()
    ts, js = TB.init_batch_state(g, CPU), JB.init_batch_state(jg)
    rng = np.random.default_rng(9)
    for _ in range(10):
        dl = rng.choice(g.n_tvpns * g.entries_per_tp, 6,
                        replace=False).astype(np.int32)
        dp = rng.integers(0, 1 << 25, 6).astype(np.int32)
        t = [torch.from_numpy(a.copy()) for a in (dl, dp)]
        ts = TB.update_batch(g, ts, *t)
        js = JB.update_batch(jg, js, jnp.asarray(dl), jnp.asarray(dp))
        ts, tout = TB.lookup_batch(g, ts, t[0])
        js, jout = JB.lookup_batch(jg, js, jnp.asarray(dl))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        old = np.where(rng.random(6) < 0.5, dp, dp + 1).astype(np.int32)
        ts, tok = TB.cond_update_batch(g, ts, t[0], t[1] + 7,
                                       torch.from_numpy(old))
        js, jok = JB.cond_update_batch(jg, js, jnp.asarray(dl),
                                       jnp.asarray(dp + 7), jnp.asarray(old))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        _assert_state_equal(ts, js, "wrappers")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_ops_bit_identical_to_jax(seed):
    """alloc_serving / free_serving / set_allocator / serving_grow on a
    seeded op stream: every state leaf and every output (blocks, ok)
    equal to the JAX functions', including pops from a stack that runs
    dry (oob raised), frees of host-tier ids and NIL lanes, and pushes
    past the stack's capacity."""
    g, jg = small_geometry(), j_small()
    rng = np.random.default_rng(seed)
    n_dev, b = 10, 6
    ts = TB.init_serving_state(g, n_dev, b, device=CPU)
    js = JB.init_serving_state(jg, n_dev, 0, b)
    jgrow = jax.jit(functools.partial(JB.serving_grow, jg))
    jalloc, jfree = jax.jit(JB.alloc_serving), jax.jit(JB.free_serving)
    n_pages = g.n_tvpns * g.entries_per_tp
    held, dry = [], 0
    for it in range(40):
        op = ["alloc", "grow", "grow", "free", "set"][int(rng.integers(5))]
        want = rng.random(b) < 0.6
        if op == "alloc":
            ts, tb, tok = TB.alloc_serving(ts, torch.from_numpy(want))
            js, jb, jok = jalloc(js, jnp.asarray(want))
        elif op == "grow":
            dl = rng.choice(n_pages, b, replace=False).astype(np.int32)
            ts, tb, tok = TB.serving_grow(g, ts, torch.from_numpy(want),
                                          torch.from_numpy(dl))
            js, jb, jok = jgrow(js, jnp.asarray(want), jnp.asarray(dl))
        if op in ("alloc", "grow"):
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
            assert tb.dtype == torch.int32 and tok.dtype == torch.bool
            held += [int(x) for x in tb.numpy()[tok.numpy()]]
            dry += int((want & ~tok.numpy()).any())
        elif op == "free":
            rng.shuffle(held)
            give = held[:int(rng.integers(0, min(len(held), n_dev) + 1))]
            held = held[len(give):]
            # NIL lanes pad to one length (the JAX side compiles once)
            blocks = np.full(n_dev + 4, NIL, np.int32)
            extra = [HOST_BASE + it] + [int(rng.integers(0, n_dev))] * (it % 3)
            blocks[:len(give) + len(extra)] = give + extra
            ts = TB.free_serving(ts, torch.from_numpy(blocks))
            js = jfree(js, jnp.asarray(blocks))
        else:
            stack = rng.permutation(n_dev).astype(np.int32)
            n = np.int32(rng.integers(0, n_dev + 1))
            pend = rng.random(b) < 0.3
            host = np.zeros(0, np.int32)
            ts = TB.set_allocator(ts, stack, n, host, np.int32(0), pend)
            js = JB.set_allocator(js, stack, n, host, np.int32(0), pend)
            held = [int(x) for x in stack[n:]]
        _assert_state_equal(ts, js, f"op {it} {op}")
        for tf, jf in ((TB.oob_vec, JB.oob_vec),
                       (TB.commit_seq_vec, JB.commit_seq_vec)):
            np.testing.assert_array_equal(tf(ts).numpy(), np.asarray(jf(js)))
    assert dry > 0                    # the stack ran dry at least once


def test_masked_grow_commit_leaves_state_bit_identical():
    """A grow commit with every lane masked (what a captured K-step
    program runs on a step without a page boundary) changes no tensor
    of the state: no pop, zeros added to the stats, commit_seq and the
    clock."""
    g = small_geometry()
    rng = np.random.default_rng(3)
    ts = TB.init_serving_state(g, 16, 4, device=CPU)
    n_pages = g.n_tvpns * g.entries_per_tp
    for _ in range(6):                # a state with history
        dl = rng.choice(n_pages, 4, replace=False).astype(np.int32)
        ts, _, _ = TB.serving_grow(g, ts, torch.from_numpy(rng.random(4) < .7),
                                   torch.from_numpy(dl))
    assert int(ts.commit_seq) > 0 and int(ts.fmmu.clock.sum()) > 0
    dl = torch.from_numpy(rng.choice(n_pages, 4, replace=False)
                          .astype(np.int32))
    after, blocks, ok = TB.serving_grow(g, ts, torch.zeros(4, dtype=torch.bool),
                                        dl)
    assert not ok.any() and (blocks == NIL).all()
    flat = [(f, getattr(ts, f), getattr(after, f)) for f in ts._fields
            if f != "fmmu"]
    flat += [(f, getattr(ts.fmmu, f), getattr(after.fmmu, f))
             for f in ts.fmmu._fields]
    for name, x, y in flat:
        if x is None:
            assert y is None, name
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), name


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@pytest.mark.parametrize("seed,geom_kw", [
    (0, {}), (1, dict(cmt_sets=8, cmt_ways=4)),
    (2, dict(cmt_sets=2, cmt_ways=1))])
def test_unfused_calls_bit_identical_to_jax(seed, geom_kw):
    """lookup/update/cond_update_batch_unfused on random batches (set
    overflow, duplicate blocks and reads, host-tier ids, inactive and
    out-of-contract lanes): every state leaf and output equal to JAX's
    unfused calls, which probe through fmmu_lookup."""
    g, jg = small_geometry(**geom_kw), j_small(**geom_kw)
    ts, js = TB.init_batch_state(g, CPU), JB.init_batch_state(jg)
    jlook, jupd, jcond = (jax.jit(functools.partial(f, jg)) for f in (
        JB.lookup_batch_unfused, JB.update_batch_unfused,
        JB.cond_update_batch_unfused))
    rng = np.random.default_rng(seed)
    shadow = {}
    p0 = TB.PROBE_CALLS[0]
    for it in range(25):
        opc, dl, dp, old = _gen_batch(rng, g, shadow, overflow=True)

        def lanes(mask, *cols):
            # each call's lanes padded with inactive ones (a no-op) to
            # BQ, so the JAX side compiles once per call
            n = BQ - int(mask.sum())
            return [np.concatenate([c[mask], np.full(n, f, np.int32)])
                    for c, f in zip(cols, (-1, 0, 0))]
        dl_l, = lanes(opc == LOOKUP, dl)
        dl_u, dp_u = lanes(opc == UPDATE, dl, dp)
        dl_c, dp_c, old_c = lanes(opc == COND_UPDATE, dl, dp, old)
        ts, tout = TB.lookup_batch_unfused(g, ts, _t(dl_l))
        js, jout = jlook(js, jnp.asarray(dl_l))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        assert tout.dtype == torch.int32
        _assert_state_equal(ts, js, f"batch {it} lookup")
        ts = TB.update_batch_unfused(g, ts, _t(dl_u), _t(dp_u))
        js = jupd(js, jnp.asarray(dl_u), jnp.asarray(dp_u))
        _assert_state_equal(ts, js, f"batch {it} update")
        ts, tok = TB.cond_update_batch_unfused(g, ts, _t(dl_c), _t(dp_c),
                                               _t(old_c))
        js, jok = jcond(js, jnp.asarray(dl_c), jnp.asarray(dp_c),
                        jnp.asarray(old_c))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        _assert_state_equal(ts, js, f"batch {it} cond")
        for o, d, p_ in zip(opc, dl, dp):
            if o == UPDATE and d >= 0:
                shadow[int(d)] = int(p_)
    assert TB.PROBE_CALLS[0] - p0 == 25 * 4       # lookup 1, update 1, cond 2
    assert (ts.data.numpy() >= HOST_BASE).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_lockstep_vs_unfused_and_shadow(seed):
    """The port of tests/test_fmmu_batch.py's lockstep (constrained
    mode of tests/fmmu_lockstep.batch_lockstep): random mixed batches
    through the fused translate_batch and through the three unfused
    calls; on every batch where the split is order-insensitive the two
    states are bit-identical, and both follow dict semantics."""
    g = small_geometry(cmt_sets=8, cmt_ways=4)
    rng, nprng = random.Random(seed), np.random.RandomState(seed)
    n_blocks = g.n_tvpns * g.entries_per_tp // g.cmt_entries
    stf, stu = TB.init_batch_state(g, CPU), TB.init_batch_state(g, CPU)
    shadow, compared = {}, 0

    def gen_lanes(pool, kind):
        blks = nprng.choice(pool, rng.randint(1, 3), replace=False)
        dl = [int(b) * g.cmt_entries + rng.randrange(g.cmt_entries)
              for b in blks for _ in range(rng.randint(1, 3))]
        return [(kind, d) for d in dict.fromkeys(dl)]

    for it in range(40):
        lo = np.arange(0, 2 * n_blocks // 3)
        hi = np.arange(2 * n_blocks // 3, n_blocks)
        batch = (gen_lanes(lo, LOOKUP) + gen_lanes(lo, UPDATE)
                 + gen_lanes(hi, COND_UPDATE))
        rng.shuffle(batch)
        if _split_order_sensitive(g, stf, batch):
            continue
        kinds = np.array([k for k, _ in batch], np.int32)
        dls = np.array([d for _, d in batch], np.int32)
        dps = nprng.randint(0, 10 ** 6, len(batch)).astype(np.int32)
        olds = np.array([shadow.get(int(d), NIL) if rng.random() < .6
                         else rng.randrange(10 ** 6) for d in dls], np.int32)
        stf, out, ok = TB.translate_batch(g, stf, _t(kinds), _t(dls),
                                          _t(dps), _t(olds))
        out, ok = out.numpy(), ok.numpy()
        for i, (k, d) in enumerate(batch):
            assert out[i] == shadow.get(d, NIL), (it, i)
            if k == COND_UPDATE:
                assert bool(ok[i]) == (shadow.get(d, NIL) == olds[i])
        for i, (k, d) in enumerate(batch):
            if k == UPDATE or (k == COND_UPDATE and ok[i]):
                shadow[d] = int(dps[i])
        ml, mu, mc = kinds == LOOKUP, kinds == UPDATE, kinds == COND_UPDATE
        if ml.any():
            stu, ou = TB.lookup_batch_unfused(g, stu, _t(dls[ml]))
            np.testing.assert_array_equal(ou.numpy(), out[ml])
        if mu.any():
            stu = TB.update_batch_unfused(g, stu, _t(dls[mu]), _t(dps[mu]))
        if mc.any():
            stu, oku = TB.cond_update_batch_unfused(
                g, stu, _t(dls[mc]), _t(dps[mc]), _t(olds[mc]))
            np.testing.assert_array_equal(oku.numpy(), ok[mc])
        for f in stf._fields:
            np.testing.assert_array_equal(getattr(stf, f).numpy(),
                                          getattr(stu, f).numpy(),
                                          err_msg=f"batch {it}: {f}")
        compared += 1
    assert compared >= 20


@pytest.mark.parametrize("seed", [0, 1])
def test_kv_manager_bit_identical_to_jax(seed):
    """Random new/extend/free interleavings: map state, block tables,
    page lists and the pool's free list match the JAX manager, and the
    incremental table equals the from-scratch retranslation."""
    rng = np.random.default_rng(seed)
    n_slots, max_pages, n_dev = 4, 8, 20
    jk = JKVM(n_slots, max_pages, n_dev)
    tk = TKVM(n_slots, max_pages, n_dev, device="cpu")
    assert tk.geom.cmt_sets == jk.geom.cmt_sets
    live = set()
    for step in range(60):
        ops_ = (["new"] if len(live) < n_slots else []) + \
            (["extend", "extend_multi", "free"] if live else [])
        op = ops_[int(rng.integers(len(ops_)))]
        outcome = []
        for k, OOB in ((jk, JOOB), (tk, TOOB)):
            r = np.random.default_rng(seed * 1000 + step)
            try:
                if op == "new":
                    slot = sorted(set(range(n_slots)) - live)[
                        int(r.integers(n_slots - len(live)))]
                    k.new_seq(slot, int(r.integers(1, 4)))
                elif op == "extend":
                    slot = sorted(live)[int(r.integers(len(live)))]
                    k.extend_seq(slot, int(r.integers(0, 3)))
                elif op == "extend_multi":
                    k.extend_seqs({s: int(r.integers(0, 3))
                                   for s in sorted(live)})
                else:
                    slot = sorted(live)[int(r.integers(len(live)))]
                    k.free_seq(slot)
                outcome.append("ok")
            except OOB:
                outcome.append("oob")
        assert outcome[0] == outcome[1], (step, op, outcome)
        live = set(tk.seq_pages)
        assert live == set(jk.seq_pages)
        assert tk.seq_pages == {s: list(map(int, p))
                                for s, p in jk.seq_pages.items()}
        assert tk.pool._free_dev == jk.pool._free_dev
        _assert_state_equal(tk.state, jk.state, f"step {step} {op}")
        np.testing.assert_array_equal(tk.block_tables().numpy(),
                                      np.asarray(jk.block_tables()))
    x0, f0 = TKM.XLATE_CALLS[0], TKM.FULL_TABLE_CALLS[0]
    inc = tk.block_tables().numpy().copy()
    assert TKM.XLATE_CALLS[0] == x0           # a view: no map call
    np.testing.assert_array_equal(inc, tk.retranslate_tables().numpy())
    assert TKM.FULL_TABLE_CALLS[0] - f0 == 1
    np.testing.assert_array_equal(inc, np.asarray(jk.retranslate_tables()))
    _assert_state_equal(tk.state, jk.state, "after retranslation")
    js_, ts_ = jk.hit_stats(), tk.hit_stats()
    for key in ("hits", "misses", "fills", "updates", "host_writes"):
        assert ts_[key] == js_[key], key


def test_extend_seqs_one_map_call_and_atomic_on_exhaustion():
    kvm = TKVM(n_slots=4, max_pages=8, n_device_blocks=32, device="cpu")
    for s in range(3):
        kvm.new_seq(s, 2)
    x0 = TKM.XLATE_CALLS[0]
    got = kvm.extend_seqs({0: 1, 1: 2, 2: 1})
    assert TKM.XLATE_CALLS[0] - x0 == 1
    assert sorted(got) == [0, 1, 2] and len(got[1]) == 2
    with pytest.raises(TOOB):
        kvm.extend_seqs({0: 20, 1: 20})
    assert len(kvm.seq_pages[0]) == 3 and len(kvm.seq_pages[1]) == 4
    assert kvm.extend_seqs({0: 0, 1: 0}) == {}


def _edge_batch(rng, g, n_lanes=BQ):
    """A mixed batch of the commit's edge cases: more than W new blocks
    in one set (overflow), several lanes of one block with mixed op
    kinds (the priority collapse), unmaps (NIL) and host-tier ids past
    1<<24, duplicate reads, lanes just past the map and far past it (up
    to int32's max), and inactive lanes. Write dlpns are unique (the
    caller contract). Padded with inactive lanes to ``n_lanes``."""
    n_pages = g.n_tvpns * g.entries_per_tp
    e, s = g.cmt_entries, g.cmt_sets
    per_set = n_pages // e // s
    set0 = int(rng.integers(s))
    blocks = set0 + s * rng.choice(per_set, min(g.cmt_ways + 2, per_set),
                                   replace=False)
    lanes = []
    for b in blocks:
        for off in rng.choice(e, int(rng.integers(1, 4)), replace=False):
            op = int(rng.choice([LOOKUP, UPDATE, COND_UPDATE]))
            dp = int(rng.choice([NIL, HOST_BASE + int(rng.integers(1 << 20)),
                                 int(rng.integers(0, 4096))]))
            old = int(rng.choice([NIL, dp, int(rng.integers(0, 4096))]))
            lanes.append((op, int(b) * e + int(off), dp, old))
    for _, d, _, _ in lanes[:int(rng.integers(0, 3))]:
        lanes.append((LOOKUP, d, 0, 0))                       # dup reads
    far = [n_pages, n_pages + int(rng.integers(1, 9)), 1 << 30,
           (1 << 31) - 1 - int(rng.integers(0, 3))]
    for d in rng.choice(far, 2, replace=False):
        lanes.append((int(rng.choice([LOOKUP, UPDATE])), int(d),
                       HOST_BASE + 5, 0))
    lanes += [(int(rng.integers(0, 3)), int(rng.choice([-1, -7])), 5, 5)
              for _ in range(int(rng.integers(1, 3)))]
    order = rng.permutation(len(lanes))
    arr = np.asarray([lanes[i] for i in order]
                     + [(LOOKUP, -1, 0, 0)] * (n_lanes - len(lanes)), np.int32)
    return arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]


@pytest.mark.parametrize("entry", ["translate_serving", "translate_batch",
                                   "serving_grow"])
@pytest.mark.parametrize("geom_kw", [{}, dict(cmt_sets=2, cmt_ways=1)])
def test_in_place_commit_equals_functional_and_jax(entry, geom_kw):
    """The in-place entries (``translate_serving_``, ``translate_batch_``,
    ``serving_grow_``) leave exactly the tensors the functional ones
    return, both bit-identical to JAX after every edge-case batch, with
    equal outputs; the functional call leaves its input untouched. The
    grow stream pops a stack that runs dry mid-batch (oob) and is
    refilled; the last batch is empty."""
    g, jg = small_geometry(**geom_kw), j_small(**geom_kw)
    rng = np.random.default_rng(11)
    n_dev, n_lanes = 7, 3
    n_pages = g.n_tvpns * g.entries_per_tp
    if entry == "translate_batch":
        tf, js = TB.init_batch_state(g, CPU), JB.init_batch_state(jg)
    else:
        tf = TB.init_serving_state(g, n_dev, n_lanes, device=CPU)
        js = JB.init_serving_state(jg, n_dev, 0, n_lanes)
    ti = TB.clone_state(tf)
    jfn = jax.jit(functools.partial(getattr(JB, entry), jg))
    dry = 0
    for it in range(31):
        bq = 0 if it == 30 else BQ
        if entry == "serving_grow":
            if it % 6 == 5:                                 # refill
                stack = rng.permutation(n_dev).astype(np.int32)
                args = (stack, np.int32(n_dev), np.zeros(0, np.int32),
                        np.int32(0), np.zeros(n_lanes, bool))
                tf = TB.set_allocator(tf, *args)
                ti = TB.set_allocator(ti, *args)
                js = JB.set_allocator(js, *args)
            want = rng.random(bq) < 0.4
            dl = rng.choice(n_pages + 6, bq, replace=False).astype(np.int32)
            dl[rng.random(bq) < 0.1] = -1
            lanes = (want, dl)
        else:
            lanes = tuple(a[:bq] for a in _edge_batch(rng, g))
        src, before = tf, TB.clone_state(tf)
        tf, *t_out = getattr(TB, entry)(g, src, *map(torch.from_numpy, lanes))
        for x, y in zip(TB.state_tensors(src), TB.state_tensors(before)):
            assert torch.equal(x, y)             # the input is untouched
        i_out = getattr(TB, entry + "_")(g, ti, *map(torch.from_numpy, lanes))
        js, *j_out = jfn(js, *map(jnp.asarray, lanes))
        _assert_state_equal(tf, js, f"{entry} functional batch {it}")
        _assert_state_equal(ti, js, f"{entry} in place batch {it}")
        for t, i, j in zip(t_out, i_out, j_out):
            assert t.numpy().dtype == i.numpy().dtype == np.asarray(j).dtype
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            np.testing.assert_array_equal(i.numpy(), np.asarray(j))
        if entry == "serving_grow":
            dry += int((lanes[0] & ~t_out[1].numpy()).any())
    if entry == "serving_grow":
        assert dry > 0                   # the stack ran dry mid-batch
    else:
        st = tf if entry == "translate_batch" else tf.fmmu
        assert int(st.stats[2]) > 0 and (st.data.numpy() >= HOST_BASE).any()


def test_fmmu_commit_lane_cap_and_plain_dispatch():
    """The commit kernel's wrapper refuses more lanes than one block's
    shared memory holds (ValueError naming the cap, on any device);
    CPU tensors take the plain version (no launch counted), which
    equals ``impl="ref"``; ``impl="ref"`` has no cap."""
    from repro_torch.core.counters import COUNTERS
    from repro_torch.kernels import fmmu_commit as fc
    from repro_torch.kernels import ops
    assert fc.LANE_CAP >= 8192
    assert fc.smem_bytes(fc.LANE_CAP) <= fc.SMEM_MAX
    assert fc.smem_bytes(fc.LANE_CAP + 1) > fc.SMEM_MAX
    g = small_geometry()
    rng = np.random.default_rng(5)
    n_pages = g.n_tvpns * g.entries_per_tp
    st0 = TB.init_serving_state(g, 8, 2, device=CPU)

    def lanes(bq):
        opc, dl, dp, old = (np.full(bq, v, np.int32) for v in (0, -1, 0, 0))
        k = min(bq, n_pages)
        dl[:k] = rng.permutation(n_pages)[:k]
        opc[:k] = rng.integers(0, 3, k)
        dp[:k] = rng.integers(0, HOST_BASE + 9, k)
        return torch.from_numpy(dl), dict(
            opcodes=torch.from_numpy(opc), dppns=torch.from_numpy(dp),
            old_dppns=torch.from_numpy(old))
    dl, kw = lanes(fc.LANE_CAP + 1)
    with pytest.raises(ValueError, match=str(fc.LANE_CAP)):
        ops.fmmu_commit(g, TB.clone_state(st0), dl, **kw)
    ops.fmmu_commit(g, TB.clone_state(st0), dl, impl="ref", **kw)
    with pytest.raises(ValueError):
        ops.fmmu_commit(g, TB.clone_state(st0), dl, impl="pallas", **kw)
    dl, kw = lanes(fc.LANE_CAP)
    a, b = TB.clone_state(st0), TB.clone_state(st0)
    before = COUNTERS.launches()
    got = ops.fmmu_commit(g, a, dl, **kw)
    want = ops.fmmu_commit(g, b, dl, impl="ref", **kw)
    assert COUNTERS.launches() == before
    assert got[2] is None and want[2] is None
    for x, y in zip(got[:2], want[:2]):
        assert torch.equal(x, y)
    for x, y in zip(TB.state_tensors(a), TB.state_tensors(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(a.commit_seq) > 0
