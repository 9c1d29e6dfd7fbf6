"""The port's copy of the paper's SSD model against the reference, on the
CPU: the configuration, the calibrated cost model, the DFTL / CDFTL /
FMMU map caches, the event simulator and its workloads
(``repro_torch.configs.fmmu_paper``, ``repro_torch.core.ftl``,
``repro_torch.core.sim``).

- Every field and property of ``NAND_V1``, ``NAND_V2``, ``PAPER_SSD`` and
  tests/test_sim.py's small configuration, and the ``SW`` / ``HW``
  constants, are equal.
- Map-cache lockstep: for each scheme, at the small configuration and at
  ``PAPER_SSD``, a seeded stream of 20,000 accesses (sequential runs and
  uniform dlpns, 30-70% writes) gives an equal ``AccessPlan`` after
  every access; at the end every ``_SetCache`` list, ``clock``,
  ``n_dirty``, ``dirty_ix``, the FMMU DTL in order and ``stats`` are
  equal.
- ``benchmarks/fig10_ftl_exec.measured_paths``'s access sequences give
  equal microseconds through both packages' classes.
- The first 5,000 commands of every generator are equal.
- ``SSDSim`` cells at the small configuration (outstanding 128): result
  dicts equal by ``==`` and the final ``map``, ``rmap``, ``valid``,
  ``next_page``, ``free_blocks`` and ``active`` equal, over every scheme
  of ``benchmarks/fig11_synthetic.SCHEMES``, the trace surrogates, the
  fixed-cost mode of fig2 and a random-write run that erases.
- tests/test_sim.py's eight cases, run against the port.
- ``examples/ssd_repro_torch.py``'s MSHR demo on the CPU equals the
  reference oracle's on the same pushes.
"""
import dataclasses
import functools
import importlib.util
import itertools
import os
import random
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import fmmu_paper as rcfg  # noqa: E402
from repro.core.fmmu.oracle import FMMUOracle as RefOracle  # noqa: E402
from repro.core.fmmu.types import small_geometry as ref_small_geometry  # noqa: E402
from repro.core.ftl import costmodel as rcost  # noqa: E402
from repro.core.ftl import mapcache as rmc  # noqa: E402
from repro.core.sim import ssd as rssd  # noqa: E402
from repro.core.sim import workloads as RW  # noqa: E402
from repro_torch.configs import fmmu_paper as pcfg  # noqa: E402
from repro_torch.core.ftl import costmodel as pcost  # noqa: E402
from repro_torch.core.ftl import mapcache as pmc  # noqa: E402
from repro_torch.core.sim import ssd as pssd  # noqa: E402
from repro_torch.core.sim import workloads as PW  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmarks import fig10_ftl_exec, fig11_synthetic  # noqa: E402


def small_cfg(pkg, **kw):
    """tests/test_sim.py's configuration (1 GB, 4 channels x 2 ways) in
    the package ``pkg`` (``rcfg`` or ``pcfg``)."""
    base = dict(capacity_gb=1, channels=4, ways=2)
    base.update(kw)
    return dataclasses.replace(pkg.PAPER_SSD, **base)


CFGS = {"small": lambda pkg: small_cfg(pkg),
        "paper": lambda pkg: pkg.PAPER_SSD}


def _props(obj):
    """Every dataclass field and property of ``obj``, by name."""
    out = dataclasses.asdict(obj)
    for name, v in vars(type(obj)).items():
        if isinstance(v, property):
            out[name] = getattr(obj, name)
    return out


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("name", ["NAND_V1", "NAND_V2", "PAPER_SSD", "small"])
def test_configs_equal(name):
    if name == "small":
        ref, port = small_cfg(rcfg), small_cfg(pcfg)
    else:
        ref, port = getattr(rcfg, name), getattr(pcfg, name)
    assert _props(port) == _props(ref)
    nand_r = ref if name.startswith("NAND") else ref.nand
    nand_p = port if name.startswith("NAND") else port.nand
    for nb in (1, 4096, 16384, 65536):
        assert nand_p.transfer_us(nb) == nand_r.transfer_us(nb)
    assert type(port).__module__ == "repro_torch.configs.fmmu_paper"


def test_cost_constants_equal():
    assert pcost.CLOCK_MHZ == rcost.CLOCK_MHZ
    assert dataclasses.asdict(pcost.SW) == dataclasses.asdict(rcost.SW)
    assert dataclasses.asdict(pcost.HW) == dataclasses.asdict(rcost.HW)
    for c in (0, 1, 16, 64.5, 3963072.0):
        assert pcost.us(c) == rcost.us(c)


# -------------------------------------------------------- map-cache lockstep
def access_stream(seed, n_pages, n=20000):
    """Sequential runs (1-32 pages) mixed with uniform dlpns, about half
    of the accesses each; a write share drawn from 30-70%."""
    rng = random.Random(seed)
    write_p = rng.uniform(0.3, 0.7)
    out = []
    while len(out) < n:
        if rng.random() < 0.05:
            start = rng.randrange(n_pages)
            out += [((start + i) % n_pages, rng.random() < write_p)
                    for i in range(rng.randint(1, 32))]
        else:
            out.append((rng.randrange(n_pages), rng.random() < write_p))
    return out[:n]


def _plan(p):
    f = p.flush
    return (p.cycles, p.tp_read, p.fill_cycles,
            None if f is None else (f.cycles, list(f.tp_reads),
                                    list(f.tp_programs)))


def _set_cache(c):
    return (c.n_sets, c.n_ways, c.tag, c.valid, c.dirty, c.ref, c.clock,
            c.n_dirty, c.dirty_ix)


@pytest.mark.parametrize("cfg_name", ["small", "paper"])
@pytest.mark.parametrize("scheme", ["dftl", "cdftl", "fmmu"])
def test_map_cache_lockstep(scheme, cfg_name):
    rc, pc = CFGS[cfg_name](rcfg), CFGS[cfg_name](pcfg)
    ref, port = rmc.SCHEMES[scheme](rc), pmc.SCHEMES[scheme](pc)
    assert type(port).__module__ == "repro_torch.core.ftl.mapcache"
    seed = 1000 + 10 * ["dftl", "cdftl", "fmmu"].index(scheme) + \
        (cfg_name == "paper")
    stream = access_stream(seed, rc.logical_pages)
    writes = sum(w for _, w in stream)
    assert 0.3 * len(stream) <= writes <= 0.7 * len(stream)
    flush_plans = 0
    for i, (dlpn, write) in enumerate(stream):
        a, b = ref.access(dlpn, write), port.access(dlpn, write)
        assert _plan(b) == _plan(a), (i, dlpn, write)
        flush_plans += a.flush is not None
    levels = ("cmt", "ctp") if scheme != "dftl" else ("cmt",)
    for lv in levels:
        assert _set_cache(getattr(port, lv)) == _set_cache(getattr(ref, lv))
        assert list(getattr(port, lv).dirty_ix) == \
            list(getattr(ref, lv).dirty_ix)
    if scheme == "fmmu":
        assert list(port.dtl.items()) == list(ref.dtl.items())
        assert (port.low, port.high) == (ref.low, ref.high)
        assert port.merged_cycles() == ref.merged_cycles()
    assert port.stats == ref.stats
    # the stream reached hits, misses and flush work, except DFTL's flush
    # at the small configuration, whose cache holds the whole logical space
    assert ref.stats["hit"] > 0 and ref.stats["miss"] > 0
    if not (scheme == "dftl" and cfg_name == "small"):
        assert flush_plans + ref.stats["flushes"] > 0


@pytest.mark.parametrize("cfg_name", ["small", "paper"])
def test_fig10_measured_paths_equal(cfg_name, monkeypatch):
    want = fig10_ftl_exec.measured_paths(CFGS[cfg_name](rcfg))
    for name in ("DFTLCache", "CDFTLCache", "FMMUCache"):
        monkeypatch.setattr(fig10_ftl_exec, name, getattr(pmc, name))
    monkeypatch.setattr(fig10_ftl_exec, "us", pcost.us)
    got = fig10_ftl_exec.measured_paths(CFGS[cfg_name](pcfg))
    assert got == want
    assert set(got) == {f"{s}_{p}" for s in ("dftl", "cdftl", "fmmu")
                        for p in ("hit", "miss", "flush")}


# ---------------------------------------------------------------- workloads
def _gens(W, cfg):
    out = {"rand_read_4k": W.rand_read_4k(cfg, seed=3),
           "rand_write_4k": W.rand_write_4k(cfg, seed=4),
           "seq_read_64k": W.seq_read_64k(cfg),
           "seq_write_64k": W.seq_write_64k(cfg)}
    for name, spec in W.TRACES.items():
        out[name] = W.trace_surrogate(cfg, spec, seed=5)
    return out


@pytest.mark.parametrize("cfg_name", ["small", "paper"])
def test_workloads_equal(cfg_name):
    assert {k: dataclasses.asdict(v) for k, v in PW.TRACES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RW.TRACES.items()}
    ref = _gens(RW, CFGS[cfg_name](rcfg))
    port = _gens(PW, CFGS[cfg_name](pcfg))
    assert list(port) == list(ref)
    for name in ref:
        a = [dataclasses.astuple(c) for c in itertools.islice(ref[name], 5000)]
        b = [dataclasses.astuple(c) for c in itertools.islice(port[name], 5000)]
        assert b == a, name
        assert type(next(port[name])) is pssd.Cmd


# --------------------------------------------------------------- SSDSim cells
SIM_ARRAYS = ("map", "rmap", "valid", "next_page")
PKGS = {"ref": (rcfg, rssd, RW), "port": (pcfg, pssd, PW)}


def _sim_cell(pkg, wl, cmds, scheme, cores=1, **kw):
    """One SSDSim cell at the small configuration: precondition, then a
    closed loop of ``cmds`` commands of ``wl`` (a generator's or a
    trace's name) at outstanding 128. Returns (sim, result)."""
    cfg_pkg, ssd, W = PKGS[pkg]
    cfg = small_cfg(cfg_pkg)
    sim = ssd.SSDSim(cfg, scheme=scheme, n_cores=cores, **kw)
    sim.precondition_sequential()
    gen = W.trace_surrogate(cfg, W.TRACES[wl]) if wl in W.TRACES else \
        getattr(W, wl)(cfg)
    return sim, sim.run_closed_loop(gen, cmds, outstanding=128)


# the port's cells, shared with tests/test_sim.py's cases below (read only)
port_cell = functools.lru_cache(maxsize=None)(
    functools.partial(_sim_cell, "port"))


def run_both(wl, cmds, scheme="fmmu", cores=1, **kw):
    """A cell through both packages: equal result dicts and final
    physical state."""
    rs, rr = _sim_cell("ref", wl, cmds, scheme, cores, **kw)
    ps, pr = port_cell(wl, cmds, scheme, cores, **kw)
    assert pr == rr
    for name in SIM_ARRAYS:
        assert np.array_equal(getattr(ps, name), getattr(rs, name)), name
    assert ps.free_blocks == rs.free_blocks
    assert ps.active == rs.active
    assert ps.free_pages == rs.free_pages
    return rr


def _scheme_kw(scheme, cores):
    """fig11_synthetic.run_one's mapping: the paper's ideal is the fmmu
    scheme with zero exec time."""
    if scheme == "ideal":
        return dict(scheme="fmmu", zero_exec=True)
    return dict(scheme=scheme, cores=cores)


SYNTH = (("rand_read_4k", 4000), ("rand_write_4k", 1000),
         ("seq_read_64k", 1000), ("seq_write_64k", 1000))


@pytest.mark.parametrize("wl,cmds", SYNTH, ids=[w for w, _ in SYNTH])
@pytest.mark.parametrize("scheme,cores", fig11_synthetic.SCHEMES,
                         ids=[f"{s}{c}" for s, c in fig11_synthetic.SCHEMES])
def test_sim_synthetic_cells_equal(scheme, cores, wl, cmds):
    r = run_both(wl, cmds, **_scheme_kw(scheme, cores))
    assert r["cmds"] == cmds


@pytest.mark.parametrize("trace", sorted(RW.TRACES))
def test_sim_trace_cells_equal(trace):
    for scheme, cores in (("ideal", 1), ("fmmu", 1), ("dftl", 1),
                          ("cdftl", 1)):
        r = run_both(trace, 800, **_scheme_kw(scheme, cores))
        assert r["cmds"] == 800


@pytest.mark.parametrize("fixed_miss", [False, True])
def test_sim_fixed_cost_cells_equal(fixed_miss):
    """benchmarks/fig2_perf_model.py's mode: scheme 'ideal' with a fixed
    FTL time, with and without a forced translation-page read."""
    r = run_both("rand_read_4k", 2000, scheme="ideal", t_ftl_us=1.0,
                 fixed_miss=fixed_miss)
    assert (r["stats"]["tp_reads"] > 0) == fixed_miss


def test_sim_random_write_gc_equal():
    r = run_both("rand_write_4k", 12000)
    assert r["stats"]["erases"] > 0 and r["stats"]["gc_moves"] > 0


# ------------------------------------ tests/test_sim.py's cases, on the port
def prun(scheme, cores=1, wl=PW.rand_read_4k, cmds=4000, cfg=None, **kw):
    cfg = cfg or small_cfg(pcfg)
    sim = pssd.SSDSim(cfg, scheme=scheme, n_cores=cores, **kw)
    sim.precondition_sequential()
    res = sim.run_closed_loop(wl(cfg), cmds, outstanding=128)
    return sim, res


def test_port_ideal_randread_bus_or_chip_bound():
    _, r = prun("ideal")
    assert max(r["util_bus"], r["util_chip"]) > 0.85
    assert r["util_ftl"] == 0.0


def test_port_scheme_ordering_randread():
    """ideal >= fmmu > dftl-1c ; 4-core recovers most of the loss."""
    _, ideal = prun("ideal")
    _, fmmu = port_cell("rand_read_4k", 4000, "fmmu", 1)
    _, d1 = port_cell("rand_read_4k", 4000, "dftl", 1)
    _, d4 = port_cell("rand_read_4k", 4000, "dftl", 4)
    _, c1 = port_cell("rand_read_4k", 4000, "cdftl", 1)
    assert fmmu["iops"] >= 0.97 * ideal["iops"]
    assert d1["iops"] < fmmu["iops"]
    assert c1["iops"] < d1["iops"]
    assert d4["iops"] > d1["iops"]


def test_port_fmmu_not_bottleneck_fig14_style():
    cfg = small_cfg(pcfg, channels=8, ways=4, host_bw_gbps=31.52)
    _, r = prun("fmmu", cfg=cfg, cmds=6000)
    assert r["util_ftl"] < 0.9
    assert max(r["util_bus"], r["util_chip"]) > r["util_ftl"]


def test_port_write_gc_invariants():
    sim, r = port_cell("rand_write_4k", 12000, "fmmu", 1)
    assert r["stats"]["erases"] > 0, "GC never ran"
    mapped = np.nonzero(sim.map >= 0)[0]
    assert len(mapped) == sim.n_pages_logical
    dppns = sim.map[mapped]
    assert len(np.unique(dppns)) == len(dppns), "double-mapped dppn"
    assert (sim.rmap[dppns] == mapped).all()
    vc = np.bincount(dppns // sim.ppb, minlength=sim.n_blocks)
    assert (vc == sim.valid).all()
    assert sim.free_pages >= 0


def test_port_write_backpressure_no_oom():
    """Sustained random overwrite far beyond OP must not crash."""
    prun("ideal", wl=PW.rand_write_4k, cmds=20000)


def test_port_seq_read_faster_than_rand_read():
    _, seq = prun("ideal", wl=PW.seq_read_64k, cmds=1500)
    _, rnd = prun("ideal", wl=PW.rand_read_4k, cmds=1500)
    assert seq["gbps"] > rnd["gbps"]


def test_port_tp_read_merging_shared():
    """Concurrent misses on one TVPN produce one in-flight TP read."""
    cfg = small_cfg(pcfg)
    sim = pssd.SSDSim(cfg, scheme="fmmu")
    sim.precondition_sequential()
    got = []
    for i in range(16):
        sim.read_page(i * cfg.cmt_block_entries, 4096,
                      lambda: got.append(1))
    sim.ev.run()
    assert len(got) == 16
    assert sim.stats["tp_reads"] <= 2


def test_port_trace_surrogates_run_all_schemes():
    cfg = small_cfg(pcfg)
    for spec in PW.TRACES.values():
        for scheme in ("ideal", "fmmu", "dftl", "cdftl"):
            sim = pssd.SSDSim(cfg, scheme=scheme)
            sim.precondition_sequential()
            r = sim.run_closed_loop(PW.trace_surrogate(cfg, spec), 800)
            assert r["cmds"] == 800
            assert r["elapsed_us"] > 0


# ------------------------------------------------------- the example's demo
def _ref_mshr_demo(g):
    """examples/ssd_repro.py's MSHR demo on the reference oracle."""
    from repro.core.fmmu.types import LOOKUP, UPDATE, Request
    o = RefOracle(g)
    o.push_request(Request(UPDATE, 0, dppn=1234, req_id=0))
    o.run(auto_flash=True)
    o.flush_all()
    for i in range(1, g.n_tvpns):
        o.push_request(Request(UPDATE, i * g.entries_per_tp, dppn=i,
                               req_id=i))
    o.run(auto_flash=True)
    o.flush_all()
    for j in range(g.mshr_cap):
        o.push_request(Request(LOOKUP, j, req_id=100 + j))
    o.run(auto_flash=False)
    _, fc, _ = o.drain_outputs()
    for t, s, w in fc:
        o.push_flash_response(t, s, w)
    o.run()
    resps, _, _ = o.drain_outputs()
    return {"flash_reads": [tuple(x) for x in fc],
            "mshr_merge": o.stats["mshr_merge"],
            "responses": [(r.req_id, r.kind, r.dppn, r.status)
                          for r in resps]}


def test_example_mshr_demo_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "ssd_repro_torch", os.path.join(REPO, "examples", "ssd_repro_torch.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = ex.main(["--device", "cpu", "--skip-sweep"])
    want = _ref_mshr_demo(ref_small_geometry())
    assert len(want["flash_reads"]) == 1
    assert want["mshr_merge"] == ref_small_geometry().mshr_cap - 1
    for unit in ("oracle", "engine"):
        assert out[unit] == want, unit
    assert "1 flash read(s)" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cuda'"):
            ex.main(["--skip-sweep"])
