"""``chip_smoke.py``'s ssd phase on the CPU.

- The reference constants it holds the port's SSD model to
  (``SSD_REFERENCE``) are what the reference computes on each cell at
  ``PAPER_SSD`` (``cmds``, ``stats`` and ``cache`` exactly, ``elapsed_us``
  within the phase's tolerance).
- The translation stream it records by wrapping ``map_access`` equals the
  one recorded the same way from the reference's simulator.
- Its drive (``ssd_drive``) of a recorded stream through the plain torch
  packet engine and the oracle copy, cold and after the GTD warm-up, at
  a geometry cut to the small configuration: streams and stats equal,
  the warm-up's programs one a TVPN, flash reads only once warmed.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs.fmmu_paper import PAPER_SSD as REF_PAPER_SSD  # noqa: E402
from repro.core.sim import workloads as RW  # noqa: E402
from repro.core.sim.ssd import SSDSim as RefSSDSim  # noqa: E402
from repro_torch.configs.fmmu_paper import PAPER_SSD  # noqa: E402
from repro_torch.core.fmmu.engine import FMMUEngine  # noqa: E402
from repro_torch.core.fmmu.oracle import FMMUOracle  # noqa: E402
from repro_torch.core.fmmu.types import FMMUGeometry, LOOKUP  # noqa: E402


@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_workload(cfg, name):
    if name == "sim_randread4k":
        return RW.rand_read_4k(cfg)
    spec = {"sim_websearch": RW.WEBSEARCH, "sim_msr_proj": RW.MSR_PROJ}[name]
    return RW.trace_surrogate(cfg, spec, seed=0)


def _ref_recorded(cfg, name, n):
    """The reference's sim on a cell, its map accesses recorded as the
    smoke records the port's: (dlpn, write, dppn written or -1)."""
    sim = RefSSDSim(cfg, scheme="fmmu")
    sim.precondition_sequential()
    log, map_access = [], sim.map_access

    def recorded(dlpn, write, done):
        log.append((dlpn, bool(write), int(sim.map[dlpn]) if write else -1))
        map_access(dlpn, write, done)

    sim.map_access = recorded
    return sim.run_closed_loop(_ref_workload(cfg, name), n), log


@pytest.mark.parametrize("name", ["sim_randread4k", "sim_websearch",
                                  "sim_msr_proj"])
def test_smoke_constants_are_the_references(smoke, name):
    n = dict(smoke.SSD_CELLS)[name]
    sim = RefSSDSim(REF_PAPER_SSD, scheme="fmmu")
    sim.precondition_sequential()
    res = sim.run_closed_loop(_ref_workload(REF_PAPER_SSD, name), n)
    want = smoke.SSD_REFERENCE[name]
    for key in ("cmds", "stats", "cache"):
        assert res[key] == want[key], key
    assert abs(res["elapsed_us"] - want["elapsed_us"]) <= \
        smoke.SSD_ELAPSED_RTOL * want["elapsed_us"]
    smoke.ssd_hold(name, res)          # the phase's own check passes


def small(cfg):
    return dataclasses.replace(cfg, capacity_gb=1, channels=4, ways=2)


@pytest.mark.parametrize("name,n", [("sim_websearch", 400),
                                    ("sim_msr_proj", 300)])
def test_recorded_stream_equals_the_references(smoke, name, n):
    res, stream, warm, _ = smoke.ssd_sim(name, n, cfg=small(PAPER_SSD))
    ref_res, ref_log = _ref_recorded(small(REF_PAPER_SSD), name, n)
    assert res == ref_res
    assert [(r.dlpn, r.kind != LOOKUP, r.dppn) for r in stream] == ref_log
    assert [r.req_id for r in stream] == list(range(len(stream)))
    assert any(w for _, w, _ in ref_log)
    ept = PAPER_SSD.entries_per_tp
    assert [r.dlpn for r in warm] == list(range(0, 1 << 16, ept))


def test_drive_cold_and_warm_on_the_cpu(smoke):
    """The smoke's drive at the small configuration's 16 TVPNs (the
    paper's CMT; a CTP of 2 x 2 pages, so that warmed pages leave it;
    tppn_cap cut to 1024): the plain engine and the oracle copy agree,
    cold and warmed."""
    _, stream, warm, _ = smoke.ssd_sim("sim_msr_proj", 200,
                                       cfg=small(PAPER_SSD))
    g = FMMUGeometry(n_tvpns=16, tppn_cap=1024, ctp_sets=2, ctp_ways=2)
    got = {}
    for start, w in (("cold", None), ("warm_gtd", warm)):
        units = [FMMUEngine(g, device="cpu"), FMMUOracle(g)]
        run_s, steps, rounds, st, warm_progs = smoke.ssd_drive(
            units, stream[:500], 7, w)
        assert steps == st["steps"] > 0 and rounds >= 1
        assert units[0].stats()["programs"] == units[1].stats["programs"]
        got[start] = (st, warm_progs)
    assert got["cold"][1] == 0 and got["warm_gtd"][1] == len(warm) == 16
    assert got["cold"][0]["fc_reads"] == 0 < got["warm_gtd"][0]["fc_reads"]
