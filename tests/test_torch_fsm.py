"""The port's sequential FMMU packet engine (the paper's FSM, §4) against
the reference, on the CPU.

- The port's oracle copy (``repro_torch.core.fmmu.oracle``) against the
  reference's ``FMMUOracle`` on the scenarios of tests/test_fmmu_oracle.py
  and tests/test_fmmu_policies.py (``set_gc_pressure`` among them): the
  same drives give the same response, flash-read and program streams,
  stats, GTD, flash pages, block states, DTL, FIFO, queues and
  ``resolve`` of every touched dlpn.
- The port's plain torch engine (``core/fmmu/engine.py``) in lockstep
  with the port's oracle on the four traces of tests/test_fmmu_engine.py
  (seeds 0 and 1, tiny MSHRs with seed 7, one way with seed 8): after
  every step the same return code and architectural state (as
  tests/fmmu_lockstep.py compares it); at the end the same streams and
  stats. No JAX compile.
- At one geometry (``small_geometry(queue_cap=2048)``) the plain engine
  equals the JAX engine field by field (all 43 ``FMMUState`` fields)
  after every step of the seed-0 trace, after ``run(auto_flash=True)``
  and after ``flush_all``, and on the trace of
  tests/test_fmmu_engine.py::test_engine_semantics_jit. One jitted step
  and the engines' compiled ``run`` are shared by the module.
- The reference's index semantics where an index comes from data: pages
  programmed past ``tppn_cap`` (dropped) and read back (clamped), chunk
  slices out of range (clamped), a negative dlpn (its TVPN counts from
  the end of the GTD), and a queue head moved back past slot 0 (floor
  mod), held field by field against JAX from a mid-trace state carried
  across (``convert.fsm_state_from_jax``).
- ``FMMUEngine`` needs a card unless given ``device="cpu"``; the kernel
  wrapper takes the plain version for a CPU state.
"""
import dataclasses
import functools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.fmmu import engine as JE  # noqa: E402
from repro.core.fmmu import oracle as JO  # noqa: E402
from repro.core.fmmu import state as JS  # noqa: E402
from repro.core.fmmu import types as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.counters import COUNTERS  # noqa: E402
from repro_torch.core.fmmu import engine as TE  # noqa: E402
from repro_torch.core.fmmu import oracle as TO  # noqa: E402
from repro_torch.core.fmmu import state as TS  # noqa: E402
from repro_torch.core.fmmu import types as TT  # noqa: E402
from repro_torch.kernels import fmmu_fsm  # noqa: E402

PKGS = {"ref": (JO.FMMUOracle, JT), "port": (TO.FMMUOracle, TT)}


# ======================================================================
# the oracle copy against the reference's oracle
# ======================================================================
class Recorded:
    """An oracle whose drained outputs are also kept, in order."""

    def __init__(self, unit):
        self.u = unit
        self.resps, self.fcs, self.progs = [], [], []

    def __getattr__(self, name):
        return getattr(self.u, name)

    def drain_outputs(self):
        r, f, p = self.u.drain_outputs()
        self.resps += [(x.req_id, x.kind, x.dppn, x.status) for x in r]
        self.fcs += [tuple(x) for x in f]
        self.progs += [tuple(x) for x in p]
        return r, f, p


class Harness:
    """tests/test_fmmu_oracle.py's HIL-style harness over one package's
    types: serializes per dlpn, reorders flash responses with the rng."""

    def __init__(self, unit, T, rng):
        self.u, self.T, self.rng = unit, T, rng
        self.resps, self.inflight, self.rid2dlpn = {}, set(), {}
        self.rid = 0
        self.trace = []

    def pump(self):
        self.u.run()
        r, f, _ = self.u.drain_outputs()
        for resp in r:
            self.resps[resp.req_id] = resp
            self.inflight.discard(self.rid2dlpn[resp.req_id])
        f = list(f)
        self.rng.shuffle(f)
        for t, s, w in f:
            self.u.push_flash_response(t, s, w)
        return f

    def submit(self, kind, dlpn, dppn=-1, old=-1):
        spins = 0
        while dlpn in self.inflight:
            self.pump()
            spins += 1
            assert spins < 10_000, "harness livelock"
        T = self.T
        self.u.push_request(T.Request(kind, dlpn, dppn=dppn, old_dppn=old,
                                      req_id=self.rid,
                                      src=1 if kind == T.COND_UPDATE else 0))
        self.trace.append((kind, dlpn, self.rid, dppn, old))
        self.inflight.add(dlpn)
        self.rid2dlpn[self.rid] = dlpn
        self.rid += 1
        if self.rng.random() < 0.3:
            self.pump()

    def finish(self):
        for _ in range(5000):
            f = self.pump()
            if not self.u.pending_work() and not f and not self.inflight:
                break
        assert not self.inflight, "responses lost"

    def replay_and_check(self):
        T, shadow = self.T, {}
        for kind, dlpn, rid, dppn, old in self.trace:
            if kind == T.UPDATE:
                shadow[dlpn] = dppn
            elif kind == T.COND_UPDATE:
                if shadow.get(dlpn, T.NIL) == old:
                    shadow[dlpn] = dppn
            else:
                assert self.resps[rid].dppn == shadow.get(dlpn, T.NIL)
        return shadow


def _random_trace(O, T, seed, n_ops):
    o = Recorded(O(T.small_geometry()))
    rng = random.Random(seed)
    g = o.g
    n_pages = g.n_tvpns * g.entries_per_tp
    d = Harness(o, T, rng)
    shadow = {}
    for _ in range(n_ops):
        dlpn = rng.randrange(n_pages)
        kind = rng.choice([T.LOOKUP, T.UPDATE, T.UPDATE, T.COND_UPDATE])
        if kind == T.LOOKUP:
            d.submit(T.LOOKUP, dlpn)
        elif kind == T.UPDATE:
            v = rng.randrange(10 ** 6)
            d.submit(T.UPDATE, dlpn, dppn=v)
            shadow[dlpn] = v
        else:
            old = rng.choice([shadow.get(dlpn, T.NIL), rng.randrange(10 ** 6)])
            v = rng.randrange(10 ** 6)
            d.submit(T.COND_UPDATE, dlpn, dppn=v, old=old)
            if shadow.get(dlpn, T.NIL) == old:
                shadow[dlpn] = v
    d.finish()
    return o, d


def _sc_sequential(O, T, seed):
    o, d = _random_trace(O, T, seed, 1500)
    shadow = d.replay_and_check()
    for dlpn, v in shadow.items():
        assert o.resolve(dlpn) == v
    return o, sorted(shadow), {}


def _sc_flush_all_persists(O, T, seed):
    o, d = _random_trace(O, T, seed + 10, 800)
    shadow = d.replay_and_check()
    o.flush_all()
    assert o.cmt_dirty == 0 and o.ctp_dirty == 0
    return o, sorted(shadow), {}


def _sc_mshr_merging(O, T):
    g = T.small_geometry()
    o = Recorded(O(g))
    o.push_request(T.Request(T.UPDATE, 0, dppn=7, req_id=0))
    o.run(auto_flash=True)
    o.flush_all()
    for i in range(1, g.n_tvpns):
        o.push_request(T.Request(T.UPDATE, i * g.entries_per_tp, dppn=i,
                                 req_id=100 + i))
    o.run(auto_flash=True)
    o.flush_all()
    for j in range(g.mshr_cap):
        o.push_request(T.Request(T.LOOKUP, j, req_id=1000 + j))
    o.run(auto_flash=False)
    _, fc, _ = o.drain_outputs()
    assert len(fc) == 1
    for t, s, w in fc:
        o.push_flash_response(t, s, w)
    o.run()
    o.drain_outputs()
    return o, list(range(g.mshr_cap)), {}


def _sc_condupdate_race(O, T):
    o = Recorded(O(T.small_geometry()))
    for r in (T.Request(T.UPDATE, 5, dppn=100, req_id=0),
              T.Request(T.UPDATE, 5, dppn=200, req_id=1),
              T.Request(T.COND_UPDATE, 5, dppn=300, old_dppn=100, req_id=2,
                        src=1)):
        o.push_request(r)
        o.run(auto_flash=True)
    o.drain_outputs()
    assert o.resolve(5) == 200
    return o, [5], {}


def _sc_flush_batches(O, T):
    g = T.small_geometry()
    o = Recorded(O(g))
    for j in range(4):
        o.push_request(T.Request(T.UPDATE, j * g.cmt_entries, dppn=j,
                                 req_id=j))
    o.run(auto_flash=True)
    o.flush_all()
    assert o.stats["programs"] == 1 and o.stats["flush_blocks"] == 4
    return o, [j * g.cmt_entries for j in range(4)], {}


# tests/test_fmmu_oracle.py's pinned @example programs, and seeded ones
_PROGRAMS = [
    ([(1, 0, 5), (0, 0, 0), (2, 0, 9), (0, 0, 0), (1, 0, 3), (2, 0, 9),
      (0, 0, 0)], 1234),
    ([(1, j, j) for j in range(8)] + [(0, j, 0) for j in range(8)], 7),
] + [([(r.randrange(3), r.randrange(128), r.randrange(1000))
       for _ in range(r.randrange(1, 121))], r.randrange(2 ** 30))
     for r in (random.Random(s) for s in range(4))]


def _sc_program(O, T, i):
    ops, flash_seed = _PROGRAMS[i]
    o = Recorded(O(T.small_geometry()))
    d = Harness(o, T, random.Random(flash_seed))
    shadow = {}
    for op, dlpn, val in ops:
        if op == 0:
            d.submit(T.LOOKUP, dlpn)
        elif op == 1:
            d.submit(T.UPDATE, dlpn, dppn=val)
            shadow[dlpn] = val
        else:
            old = shadow.get(dlpn, T.NIL) if val % 2 else val
            d.submit(T.COND_UPDATE, dlpn, dppn=val, old=old)
            if shadow.get(dlpn, T.NIL) == old:
                shadow[dlpn] = val
    d.finish()
    d.replay_and_check()
    return o, sorted({dlpn for _, dlpn, _ in ops}), {}


def _fill_set(o, T, set_idx, n, write=False, base_rid=0):
    g = o.g
    for i in range(n):
        block_id = set_idx + i * g.cmt_sets
        o.push_request(T.Request(T.UPDATE if write else T.LOOKUP,
                                 block_id * g.cmt_entries, dppn=100 + i,
                                 req_id=base_rid + i))
    o.run(auto_flash=True)
    o.drain_outputs()


def _sc_second_chance(O, T):
    g = T.small_geometry(cmt_ways=2)
    o = Recorded(O(g))
    _fill_set(o, T, 0, 2)
    o.cmt[0][0].refbit = True          # white-box, as the policy test
    o.cmt[0][1].refbit = False
    o.cmt_clock[0] = 0
    o.push_request(T.Request(T.LOOKUP, 2 * g.cmt_sets * g.cmt_entries,
                             req_id=70))
    o.run(auto_flash=True)
    o.drain_outputs()
    return o, [0, 2 * g.cmt_sets * g.cmt_entries], {}


def _sc_watermark(O, T):
    g = T.small_geometry()
    o = Recorded(O(g))
    target = g.cmt_blocks - g.cmt_low() + 1
    i = 0
    while o.cmt_dirty < target and i < 10 * g.cmt_blocks:
        o.push_request(T.Request(T.UPDATE, (i * g.cmt_entries) %
                                 (g.n_tvpns * g.entries_per_tp),
                                 dppn=i, req_id=i))
        o.run(auto_flash=True)
        o.drain_outputs()
        i += 1
    assert o.stats["flush_tvpns"] > 0
    return o, [(j * g.cmt_entries) % (g.n_tvpns * g.entries_per_tp)
               for j in range(i)], {}


def _sc_dtl_greedy(O, T):
    g = T.small_geometry()
    o = Recorded(O(g))
    for j in range(3):
        o.push_request(T.Request(T.UPDATE,
                                 g.entries_per_tp + j * g.cmt_entries,
                                 dppn=j, req_id=j))
    o.push_request(T.Request(T.UPDATE, 0, dppn=9, req_id=9))
    o.run(auto_flash=True)
    o.drain_outputs()
    return o, [0], {"victim": dict(o._pick_flush_victim())}


def _sc_gc_pressure(O, T):
    g = T.small_geometry()
    o = Recorded(O(g))
    o.set_gc_pressure(valid_pages_in_victim=240, pages_per_block=256)
    for i in range(8):        # HRM against GCM under the new weights
        o.push_request(T.Request(T.LOOKUP, i * g.cmt_entries, req_id=i))
        o.push_request(T.Request(T.LOOKUP, (i + 8) * g.cmt_entries,
                                 req_id=100 + i, src=1))
    o.run(auto_flash=True)
    o.drain_outputs()
    o.set_gc_pressure(valid_pages_in_victim=3, pages_per_block=256)
    return o, [i * g.cmt_entries for i in range(16)], {}


def _sc_arbitration(O, T):
    g = T.small_geometry()
    o = Recorded(O(g))
    for i in range(8):
        o.push_request(T.Request(T.LOOKUP, i * g.cmt_entries, req_id=i))
        o.push_request(T.Request(T.LOOKUP, (i + 8) * g.cmt_entries,
                                 req_id=100 + i, src=1))
    o.run(auto_flash=True)
    o.drain_outputs()
    return o, [i * g.cmt_entries for i in range(16)], {}


def _sc_flush_idempotent(O, T):
    g = T.small_geometry()
    o = Recorded(O(g))
    for i in range(20):
        o.push_request(T.Request(T.UPDATE, i * 3, dppn=i, req_id=i))
    o.run(auto_flash=True)
    o.flush_all()
    p1 = o.stats["programs"]
    o.flush_all()
    assert o.stats["programs"] == p1
    return o, [i * 3 for i in range(20)], {}


SCENARIOS = {
    **{f"sequential_{s}": functools.partial(_sc_sequential, seed=s)
       for s in range(4)},
    **{f"flush_all_persists_{s}": functools.partial(
        _sc_flush_all_persists, seed=s) for s in range(2)},
    "mshr_merging": _sc_mshr_merging,
    "condupdate_race": _sc_condupdate_race,
    "flush_batches_same_tvpn": _sc_flush_batches,
    **{f"program_{i}": functools.partial(_sc_program, i=i)
       for i in range(len(_PROGRAMS))},
    "second_chance": _sc_second_chance,
    "watermark_flush": _sc_watermark,
    "dtl_greedy": _sc_dtl_greedy,
    "gc_pressure": _sc_gc_pressure,
    "arbitration_interleaves": _sc_arbitration,
    "flush_all_idempotent": _sc_flush_idempotent,
}


def _norm(x):
    """Queue items and payloads as plain nested tuples (a Request of
    either package becomes its field tuple)."""
    if dataclasses.is_dataclass(x):
        return tuple(dataclasses.astuple(x))
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v) for v in x)
    return x


def _blocks(rows):
    return [[(b.tag, b.valid, b.dirty, b.transient, b.refbit, b.next,
              tuple(b.data), _norm(b.mshrs)) for b in row] for row in rows]


def _oracle_view(o):
    return dict(
        cmt=_blocks(o.cmt), ctp=_blocks(o.ctp), cmt_clock=o.cmt_clock,
        ctp_clock=o.ctp_clock, gtd=o.gtd,
        flash_tp={k: tuple(v) for k, v in o.flash_tp.items()},
        tppn_next=o.tppn_next, dtl=[dict(e) for e in o.dtl],
        ctp_fifo=list(o.ctp_fifo), queues=[_norm(list(q)) for q in o.queues],
        credits=o.credits, cmt_dirty=o.cmt_dirty, ctp_dirty=o.ctp_dirty,
        stalls=o._stalls_in_row, stats=o.stats,
        weights=tuple(o.g.wrr_weights), resps=o.resps, fcs=o.fcs,
        progs=o.progs, undrained=_norm([o.out_resps, o.out_fc_reads,
                                        o.out_programs]))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_oracle_copy_equals_the_reference_oracle(name):
    views = {}
    for pkg, (O, T) in PKGS.items():
        o, dlpns, extra = SCENARIOS[name](O, T)
        views[pkg] = (_oracle_view(o), [o.resolve(d) for d in dlpns], extra)
    ref, port = views["ref"], views["port"]
    for key in ref[0]:
        assert port[0][key] == ref[0][key], key
    assert port[1] == ref[1] and port[2] == ref[2]


# ======================================================================
# the plain engine in lockstep with the oracle copy
# ======================================================================
def _oracle_flags(blk):
    return ((TS.F_VALID * blk.valid) | (TS.F_DIRTY * blk.dirty)
            | (TS.F_TRANS * blk.transient) | (TS.F_REF * blk.refbit))


def _arch_diff(g, o, st, resp_base):
    """tests/fmmu_lockstep.py's architectural compare: flags, data of
    valid blocks, next links of dirty CMT blocks, queue lengths,
    credits, responses emitted, tppn_next and the GTD."""
    cf, cd, cn = st.cmt_flags.tolist(), st.cmt_data.tolist(), \
        st.cmt_next.tolist()
    for s in range(g.cmt_sets):
        for w in range(g.cmt_ways):
            blk = o.cmt[s][w]
            if cf[s][w] != _oracle_flags(blk):
                return f"cmt flags {s},{w}"
            if blk.valid and cd[s][w] != blk.data:
                return f"cmt data {s},{w}"
            if blk.dirty and cn[s][w] != blk.next:
                return f"cmt next {s},{w}"
    tf, td = st.ctp_flags.tolist(), st.ctp_data.tolist()
    for s in range(g.ctp_sets):
        for w in range(g.ctp_ways):
            blk = o.ctp[s][w]
            if tf[s][w] != _oracle_flags(blk):
                return f"ctp flags {s},{w}"
            if blk.valid and td[s][w] != blk.data:
                return f"ctp data {s},{w}"
    if (st.qtail - st.qhead).tolist() != [len(q) for q in o.queues]:
        return "queue lengths"
    if st.credits.tolist() != o.credits:
        return "credits"
    if int(st.resp_n) != resp_base + len(o.out_resps):
        return "responses emitted"
    if int(st.tppn_next) != o.tppn_next:
        return "tppn_next"
    if st.gtd.tolist() != o.gtd:
        return "gtd"
    return None


def _requests(T, g, seed, n_reqs):
    """tests/fmmu_lockstep.lockstep's request trace (its rng draws)."""
    rng = random.Random(seed)
    n_pages = g.n_tvpns * g.entries_per_tp
    reqs = []
    for rid in range(n_reqs):
        dlpn = rng.randrange(n_pages)
        kind = rng.choice([T.LOOKUP, T.UPDATE, T.UPDATE, T.COND_UPDATE])
        d = rng.randrange(10 ** 6)
        old = rng.randrange(10 ** 6) if rng.random() < 0.5 else T.NIL
        reqs.append(T.Request(kind, dlpn, dppn=d, old_dppn=old, req_id=rid,
                              src=1 if kind == T.COND_UPDATE else 0))
    return rng, reqs


ENGINE_TRACES = {"seed0": (0, {}), "seed1": (1, {}),
                 "tiny_mshr": (7, dict(mshr_cap=2, ctp_mshr_cap=2)),
                 "one_way": (8, dict(cmt_ways=1, ctp_ways=1))}


@pytest.mark.parametrize("trace", sorted(ENGINE_TRACES))
def test_plain_engine_lockstep_with_the_oracle_copy(trace):
    seed, kw = ENGINE_TRACES[trace]
    g = TT.small_geometry(**dict(dict(queue_cap=2048), **kw))
    o = TO.FMMUOracle(g)
    eng = TE.FMMUEngine(g, device="cpu")
    rng, reqs = _requests(TT, g, seed, 150)
    for r in reqs:
        o.push_request(r)
        eng.push_request(r)
    resp_base, o_all, e_all, n_steps = 0, [], [], 0
    for stepno in range(40000):
        ocode = o.step()
        ecode = TE.step(g, eng.state)
        n_steps += 1
        assert ocode == ecode, f"step {stepno}: code {ocode} vs {ecode}"
        diff = _arch_diff(g, o, eng.state, resp_base)
        assert diff is None, f"step {stepno}: {diff}"
        if ocode != o.WORKED:
            ro, fo, po = o.drain_outputs()
            re_, fe, pe = eng.drain_outputs()
            resp_base += len(ro)
            o_all += [(x.req_id, x.kind, x.dppn, x.status) for x in ro]
            e_all += [(x.req_id, x.kind, x.dppn, x.status) for x in re_]
            assert fo == fe and po == pe, f"step {stepno}: flash streams"
            if not fo and not o.pending_work():
                break
            order = list(fo)
            rng.shuffle(order)
            for t, s, w in order:
                o.push_flash_response(t, s, w)
                eng.push_flash_response(t, s, w)
    assert o_all == e_all and len(o_all) == 150
    assert eng.stats() == o.stats
    assert eng.stats()["steps"] == n_steps


# ======================================================================
# the plain engine against the JAX engine, field by field
# ======================================================================
JGEOM = JT.small_geometry(queue_cap=2048)
TGEOM = TT.small_geometry(queue_cap=2048)


@pytest.fixture(scope="module")
def jax_programs():
    """One jitted JAX step and one JAX engine's compiled ``run`` at
    JGEOM, shared by every case of the module."""
    return dict(step=jax.jit(functools.partial(JE.step, JGEOM)),
                run=JE.FMMUEngine(JGEOM)._run)


def _jax_engine(programs):
    eng = JE.FMMUEngine(JGEOM)
    eng._run = programs["run"]
    return eng


def _assert_fields_equal(tst, jst, tag):
    assert len(tst) == len(jst) == 43
    for name, t, jn in zip(TS.FMMUState._fields, tst, jax.device_get(jst)):
        assert t.dtype == torch.int32 and jn.dtype == np.int32, name
        assert tuple(t.shape) == jn.shape, (tag, name)
        if not np.array_equal(t.numpy(), jn):
            np.testing.assert_array_equal(t.numpy(), jn,
                                          err_msg=f"{tag} {name}")


def _both_push(je, te, reqs):
    for r in reqs:
        je.push_request(JT.Request(**dataclasses.asdict(r)))
        te.push_request(r)


def _drive_both_stepwise(programs, je, te, rng, max_steps=40000):
    """Step the JAX engine (jitted step) and the port's plain step
    together to quiescence, comparing codes and every state field after
    each step and the drained streams at each pause."""
    step_jit = programs["step"]
    for stepno in range(max_steps):
        je.state, jcode = step_jit(je.state)
        tcode = TE.step(TGEOM, te.state)
        assert int(jcode) == tcode, f"step {stepno}"
        _assert_fields_equal(te.state, je.state, f"step {stepno}")
        if tcode != TS.WORKED:
            jr, jf, jp = je.drain_outputs()
            tr, tf, tp = te.drain_outputs()
            assert [dataclasses.astuple(x) for x in jr] == \
                [dataclasses.astuple(x) for x in tr]
            assert [tuple(x) for x in jf] == tf and \
                [tuple(x) for x in jp] == tp
            if not tf and not te.pending_work():
                return stepno + 1
            order = list(tf)
            rng.shuffle(order)
            for t, s, w in order:
                je.push_flash_response(t, s, w)
                te.push_flash_response(t, s, w)
    raise AssertionError("no quiescence")


def test_plain_engine_equals_jax_engine_field_by_field(jax_programs):
    je, te = _jax_engine(jax_programs), TE.FMMUEngine(TGEOM, device="cpu")
    _assert_fields_equal(te.state, je.state, "init")
    rng, reqs = _requests(TT, TGEOM, 0, 150)
    _both_push(je, te, reqs)
    _drive_both_stepwise(jax_programs, je, te, rng)
    # a second burst through the engines' run, then the shutdown flush
    _, more = _requests(TT, TGEOM, 100, 120)
    _both_push(je, te, more)
    assert je.run(auto_flash=True) == te.run(auto_flash=True)
    _assert_fields_equal(te.state, je.state, "run(auto_flash=True)")
    je.flush_all()
    te.flush_all()
    _assert_fields_equal(te.state, je.state, "flush_all")
    assert int(te.state.cmt_dirty) == 0 and int(te.state.ctp_dirty) == 0
    assert te.stats() == je.stats()


def test_engine_semantics_trace_equals_jax(jax_programs):
    """tests/test_fmmu_engine.py::test_engine_semantics_jit's trace,
    pumped through both engines' ``run`` together: the same responses,
    dict semantics, ``resolve``, state, and pages after ``flush_all``."""
    g = TGEOM
    je, te = _jax_engine(jax_programs), TE.FMMUEngine(g, device="cpu")
    rng = random.Random(3)
    n_pages = g.n_tvpns * g.entries_per_tp
    resps, inflight, rid2dlpn = {}, set(), {}

    def pump():
        assert je.run(auto_flash=False) == te.run(auto_flash=False)
        jr, jf, jp = je.drain_outputs()
        r, f, p = te.drain_outputs()
        assert [dataclasses.astuple(x) for x in jr] == \
            [dataclasses.astuple(x) for x in r]
        assert [tuple(x) for x in jf] == f and [tuple(x) for x in jp] == p
        for resp in r:
            resps[resp.req_id] = resp
            inflight.discard(rid2dlpn[resp.req_id])
        for t, s, w in f:
            je.push_flash_response(t, s, w)
            te.push_flash_response(t, s, w)

    trace = []
    for rid in range(400):
        dlpn = rng.randrange(n_pages)
        while dlpn in inflight:
            pump()
        kind = rng.choice([TT.LOOKUP, TT.UPDATE, TT.UPDATE])
        v = rng.randrange(10 ** 6)
        _both_push(je, te, [TT.Request(kind, dlpn, dppn=v, req_id=rid)])
        trace.append((kind, dlpn, rid, v))
        inflight.add(dlpn)
        rid2dlpn[rid] = dlpn
        if rng.random() < 0.25:
            pump()
    for _ in range(2000):
        pump()
        if not te.pending_work() and not inflight:
            break
    assert not inflight
    _assert_fields_equal(te.state, je.state, "trace")
    replay = {}
    for kind, dlpn, r, v in trace:
        if kind == TT.UPDATE:
            replay[dlpn] = v
        else:
            assert resps[r].dppn == replay.get(dlpn, TT.NIL)
    for dlpn, v in replay.items():
        assert te.resolve(dlpn) == je.resolve(dlpn) == v
    probe = sorted(replay) + [0, 1, n_pages - 1]
    assert te.resolve_many(probe).tolist() == [te.resolve(d) for d in probe]
    je.flush_all()
    te.flush_all()
    _assert_fields_equal(te.state, je.state, "flush_all")
    st = te.state
    for dlpn, v in replay.items():
        tppn = int(st.gtd[dlpn // g.entries_per_tp])
        assert tppn != TT.NIL
        assert int(st.flash_tp[tppn, dlpn % g.entries_per_tp]) == v


# ======================================================================
# index semantics where an index comes from data
# ======================================================================
def test_queue_head_wraps_below_zero_like_jax():
    """A head-of-line re-insertion at qhead 0 writes slot cap-1 and
    leaves qhead -1 (floor mod), then the pop reads that slot back; a
    tail past cap wraps too."""
    jst = JS.init_state(JGEOM)
    tst = TS.init_state(TGEOM, "cpu")
    pkt = list(range(100, 100 + TGEOM.pkt_width))
    jst = JE._qpush_front(jst, TS.Q_CTP_REQ, jnp.asarray(pkt, jnp.int32))
    TE._qpush_front(tst, TS.Q_CTP_REQ, pkt)
    _assert_fields_equal(tst, jst, "push_front")
    assert int(tst.qhead[TS.Q_CTP_REQ]) == -1
    assert tst.qbuf[TS.Q_CTP_REQ, -1].tolist() == pkt
    jst, jpkt = JE._qpop(jst, TS.Q_CTP_REQ)
    assert TE._qpop(tst, TS.Q_CTP_REQ) == np.asarray(jpkt).tolist() == pkt
    cap = TGEOM.queue_cap
    jst = jst._replace(qtail=jst.qtail.at[TS.Q_HRM].set(cap + 3),
                       qhead=jst.qhead.at[TS.Q_HRM].set(cap + 3))
    tst.qtail[TS.Q_HRM] = cap + 3
    tst.qhead[TS.Q_HRM] = cap + 3
    jst = JE._qpush(jst, TS.Q_HRM, jnp.asarray(pkt, jnp.int32))
    TE._qpush(tst, TS.Q_HRM, pkt)
    _assert_fields_equal(tst, jst, "push past cap")
    assert tst.qbuf[TS.Q_HRM, 3].tolist() == pkt


def test_out_of_range_indices_like_jax(jax_programs):
    """From one mid-trace state carried across the packages: pages
    programmed past tppn_cap are dropped and their reads clamp to page
    tppn_cap - 1; FLUSH_BLK and LOAD packets whose chunk slices start
    out of range clamp like lax.dynamic_slice; a negative dlpn's TVPN
    indexes the GTD from its end. Every field equals JAX's after every
    step, and after flush_all."""
    g, cap = TGEOM, TGEOM.tppn_cap
    je = _jax_engine(jax_programs)
    rng, reqs = _requests(TT, g, 5, 60)
    for r in reqs:
        je.push_request(JT.Request(**dataclasses.asdict(r)))
    for _ in range(200):
        je.state, _ = jax_programs["step"](je.state)
    te = TE.FMMUEngine(g, device="cpu")
    te.state = convert.fsm_state_from_jax(je.state, device="cpu")
    _assert_fields_equal(te.state, je.state, "carried")
    back = JS.FMMUState(*map(jnp.asarray, convert.fsm_state_to_numpy(
        te.state)))
    _assert_fields_equal(te.state, back, "round trip")
    # near the end of the translation space, out-of-range chunks, a
    # negative dlpn
    je.state = je.state._replace(tppn_next=jnp.asarray(cap - 2, jnp.int32))
    te.state.tppn_next.fill_(cap - 2)
    ept, e = g.entries_per_tp, g.cmt_entries
    data = list(range(7000, 7000 + e))
    for kind, tvpn, chunk, dest in ((TT.FLUSH_BLK, 1, g.chunks_per_tp + 3,
                                     TT.NIL),
                                    (TT.FLUSH_BLK, 2, -2, TT.NIL),
                                    (TT.LOAD, 1, g.chunks_per_tp + 1, 0)):
        pkt = [kind, tvpn, chunk, dest, TT.NIL] + data
        je.state = JE._qpush(je.state, TS.Q_CTP_REQ,
                             jnp.asarray(pkt, jnp.int32))
        TE._qpush(te.state, TS.Q_CTP_REQ, pkt)
    neg = TT.Request(TT.UPDATE, -5, dppn=4242, req_id=9000)
    _, more = _requests(TT, g, 6, 150)
    _both_push(je, te, [neg] + more)
    _drive_both_stepwise(jax_programs, je, te, rng)
    je.flush_all()
    te.flush_all()
    _assert_fields_equal(te.state, je.state, "flush_all")
    # the case was reached: programs past the cap, and reads of them
    assert int(te.state.tppn_next) > cap + 2
    assert int(te.state.gtd.max()) >= cap
    assert int((te.state.flash_tp[cap - 1] != TT.NIL).sum()) > 0
    probe = [-5, -1] + list(range(0, g.n_tvpns * ept, 3))
    assert te.resolve_many(probe).tolist() == \
        [int(je.resolve(d)) for d in probe]


# ======================================================================
# entry points and dispatch
# ======================================================================
def test_engine_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert TE.FMMUEngine(TGEOM).state.stats.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TE.FMMUEngine(TGEOM)
    with pytest.raises(ValueError):
        TE.FMMUEngine(TGEOM, device="cpu", kernel_impl="pallas")
    eng = TE.FMMUEngine(TGEOM, device="cpu")
    assert eng.state.stats.device.type == "cpu"
    with pytest.raises(ValueError):
        eng.push_flash_response(0, TGEOM.ctp_sets, 0)


def test_fsm_wrapper_takes_the_plain_version_on_a_cpu_state():
    """No launch is counted for a CPU state, the plain functions run in
    place, and an unknown impl raises."""
    g = TGEOM
    a, b = TE.FMMUEngine(g, device="cpu"), TE.FMMUEngine(g, device="cpu")
    _, reqs = _requests(TT, g, 2, 40)
    for r in reqs:
        a.push_request(r)
    before = COUNTERS.launches().get("fmmu_fsm", 0)
    b.push_requests(reqs)             # one copy per queue, same rows
    a.push_requests([])
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    n = fmmu_fsm.fmmu_fsm_run(g, a.state, 100_000, True)
    assert n == TE.run(g, b.state, 100_000, True)
    fmmu_fsm.fmmu_fsm_force_flush_one(g, a.state)
    TE.force_flush_one(g, b.state)
    assert fmmu_fsm.fmmu_fsm_force_wb(g, a.state, impl="ref") == \
        TE.force_wb(g, b.state)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    assert COUNTERS.launches().get("fmmu_fsm", 0) == before
    with pytest.raises(ValueError):
        fmmu_fsm.fmmu_fsm_run(g, a.state, 10, impl="cuda")


# ======================================================================
# the kernel's resident set and index arithmetic (no card)
# ======================================================================
def _repo_geometries():
    """Every geometry the repo runs the engine at: the tests', the
    smoke's and the SSD model's (FMMUGeometry()), the examples'."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "_cuda_tests", Path(__file__).with_name("test_torch_cuda.py"))
    cuda_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cuda_tests)
    return [TT.FMMUGeometry(), TGEOM, TT.small_geometry()] + [
        TT.FMMUGeometry(**kw) for kw in cuda_tests.FSM_GEOMETRIES.values()]


def test_fsm_resident_set_at_the_paper_geometry_and_every_repo_geometry():
    """At FMMUGeometry() the resident state is 105,972 B (the CMT's
    34,816 + 65,536, the CTP's 832, the DTL's 2,560, the FIFO's 1,028,
    the GTD's 1,024, 176 of scalars) and 212,468 B with the CTP_REQ and
    HRM rings (2 x 53,248); the launch's layout adds the staging page
    (16,384), the MSHR rows of a replay (2,816) and the control words
    (128): 231,796 B, under the card's 232,448. Every geometry the repo
    runs passes the check; the regions are 16-byte aligned and disjoint."""
    g = TT.FMMUGeometry()
    assert fmmu_fsm.resident_bytes(g, rings=()) == 105_972
    assert fmmu_fsm.resident_bytes(g) == 212_468
    assert fmmu_fsm.smem_bytes(g) == 231_796 <= fmmu_fsm.SMEM_LIMIT
    for geom in _repo_geometries():
        fmmu_fsm._check_geometry(geom)
        off, nbytes = fmmu_fsm._layout(geom)
        sizes = fmmu_fsm._region_ints(geom)
        spans = sorted((o, o + sizes[r]) for r, o in off.items() if o >= 0)
        assert all(o % 4 == 0 for o, _ in spans)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][1] * 4 == nbytes <= fmmu_fsm.SMEM_LIMIT
        assert len(fmmu_fsm._geom(geom)) == 56    # csrc/fmmu_fsm.cu Geom


@pytest.mark.parametrize("kw", [dict(cmt_sets=4096),
                                dict(queue_cap=4096),
                                dict(cmt_ways=33)])
def test_fsm_oversized_geometry_raises_before_any_launch(kw):
    """A geometry past the card's shared memory (or past a warp's lanes)
    raises ValueError from the wrapper's check, naming both byte counts,
    before a tensor is looked at or a kernel built."""
    g = TT.FMMUGeometry(**kw)
    with pytest.raises(ValueError) as err:
        fmmu_fsm._check_geometry(g)
    if "cmt_ways" not in kw:
        assert str(fmmu_fsm.smem_bytes(g)) in str(err.value)
        assert str(fmmu_fsm.SMEM_LIMIT) in str(err.value)
    st = TS.init_state(g, "meta")
    before = COUNTERS.launches().get("fmmu_fsm", 0)
    with pytest.raises(ValueError):
        fmmu_fsm._check(g, st)
    assert COUNTERS.launches().get("fmmu_fsm", 0) == before


def test_fsm_shift_and_mask_equal_python_floor_div_and_mod():
    """The kernel's power-of-two body: an arithmetic shift and a mask
    give Python's floor // and % for negative and positive int32
    operands; the wrapper passes log2 for a power-of-two divisor and -1
    (the floor_div body) for any other."""
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 4000),
                        np.arange(-70, 70),
                        [-2 ** 31, 2 ** 31 - 1, -1, 0]]).astype(np.int32)
    for lg in range(0, 13):
        d = 1 << lg
        assert fmmu_fsm._lg(d) == lg
        shift = (a >> np.int32(lg)).astype(np.int64)
        mask = (a & np.int32(d - 1)).astype(np.int64)
        assert (shift == a.astype(np.int64) // d).all()
        assert (mask == a.astype(np.int64) % d).all()
    assert [fmmu_fsm._lg(n) for n in (3, 6, 12, 257, 1000, 0)] == [-1] * 6
    paper = list(fmmu_fsm._geom(TT.FMMUGeometry()))[19:27]
    assert paper == [9, 2, 3, 4, 2, 12, 9, 10]
    odd = list(fmmu_fsm._geom(TT.FMMUGeometry(
        cmt_sets=6, cmt_ways=3, cmt_entries=4, ctp_sets=3, ctp_ways=3,
        entries_per_tp=12, n_tvpns=5, dtl_entries=5, queue_cap=1000,
        mshr_cap=3, ctp_mshr_cap=3)))[19:27]
    assert odd == [-1, -1, 2, -1, -1, -1, -1, -1]


def test_fsm_launch_checks_each_state_once(monkeypatch):
    """A StateCheck (the engine keeps one) checks a state's 43 tensors
    the first time it sees it, and again only when the tensors, their
    addresses or the geometry change; a changed tensor that is wrong
    still raises. Nothing is kept alive by it."""
    calls = []
    check = fmmu_fsm._check
    monkeypatch.setattr(fmmu_fsm, "_check",
                        lambda g, st: calls.append(1) or check(g, st))
    checked = fmmu_fsm.StateCheck()
    g = TGEOM
    st = TS.init_state(g, "cpu")

    def once(state, geom=g):
        checked(geom, state, tuple(t.data_ptr() for t in state))

    once(st)
    once(st)
    assert len(calls) == 1
    once(TS.clone_state(st))                       # new tensors
    once(st)
    assert len(calls) == 3
    once(st, dataclasses.replace(g, dtl_entries=g.dtl_entries))   # equal
    assert len(calls) == 3
    with pytest.raises(ValueError):
        once(st._replace(qhead=torch.zeros(4, dtype=torch.int32)))
    with pytest.raises(ValueError):
        once(st, dataclasses.replace(g, dtl_entries=g.dtl_entries + 1))
    ref = checked.refs[0]
    del st
    assert ref() is None
    assert isinstance(TE.FMMUEngine(g, device="cpu")._checked,
                      fmmu_fsm.StateCheck)
