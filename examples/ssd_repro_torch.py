"""Paper reproduction demo through the PyTorch port: the FMMU inside the
DiskSim-style SSD simulator vs DFTL/CDFTL on 4KB random reads, plus the
MSHR-merging behaviour on a burst of lookups to one translation page,
through the port's oracle and beside it through the packet engine
(``FMMUEngine``: on the card its ``run`` is the ``fmmu_fsm`` kernel).

  PYTHONPATH=src python examples/ssd_repro_torch.py [--device cpu]
  PYTHONPATH=src python examples/ssd_repro_torch.py --skip-sweep

The engine runs on the card by default and raises without one; pass
``--device cpu`` for the plain torch version.
"""
import argparse
import dataclasses

from repro_torch.configs.fmmu_paper import PAPER_SSD
from repro_torch.core.fmmu.engine import FMMUEngine
from repro_torch.core.fmmu.oracle import FMMUOracle
from repro_torch.core.fmmu.types import LOOKUP, UPDATE, Request, small_geometry
from repro_torch.core.sim import workloads as W
from repro_torch.core.sim.ssd import SSDSim


def scheme_sweep(cmds=15000):
    cfg = dataclasses.replace(PAPER_SSD, capacity_gb=2, channels=8, ways=4)
    print("4KB random read, 8ch/4way, 2GB (schemes vs ideal):")
    for scheme, cores in [("ideal", 1), ("fmmu", 1), ("dftl", 1),
                          ("dftl", 4), ("cdftl", 1), ("cdftl", 4)]:
        sim = SSDSim(cfg, scheme=scheme, n_cores=cores)
        sim.precondition_sequential()
        r = sim.run_closed_loop(W.rand_read_4k(cfg), cmds, outstanding=256)
        print(f"  {scheme}-{cores}c: {r['iops']/1e3:7.1f} KIOPS "
              f"(ftl util {r['util_ftl']:.2f})")


def mshr_demo(unit, g):
    """One translation page per TVPN written and flushed, then
    ``g.mshr_cap`` lookups to one CMT block of TVPN 0 while its page is
    on flash: one flash read, the rest merged. Returns the flash reads,
    the MSHR merges and the responses as (req_id, kind, dppn, status)."""
    unit.push_request(Request(UPDATE, 0, dppn=1234, req_id=0))
    unit.run(auto_flash=True)
    unit.flush_all()
    for i in range(1, g.n_tvpns):
        unit.push_request(Request(UPDATE, i * g.entries_per_tp, dppn=i,
                                  req_id=i))
    unit.run(auto_flash=True)
    unit.flush_all()
    for j in range(g.mshr_cap):
        unit.push_request(Request(LOOKUP, j, req_id=100 + j))
    unit.run(auto_flash=False)
    _, fc, _ = unit.drain_outputs()
    fc = [tuple(x) for x in fc]
    for t, s, w in fc:
        unit.push_flash_response(t, s, w)
    unit.run()
    resps, _, _ = unit.drain_outputs()
    stats = unit.stats() if callable(unit.stats) else unit.stats
    return {"flash_reads": fc, "mshr_merge": stats["mshr_merge"],
            "responses": [(r.req_id, r.kind, r.dppn, r.status)
                          for r in resps]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the packet engine's device (default: cuda)")
    ap.add_argument("--skip-sweep", action="store_true",
                    help="only the MSHR-merge demo")
    args = ap.parse_args(argv)
    if not args.skip_sweep:
        scheme_sweep()
    g = small_geometry()
    print("\nFMMU non-blocking MSHR merge (one flash read, many requests):")
    out = {}
    for name, unit in (("oracle", FMMUOracle(g)),
                       ("engine", FMMUEngine(g, device=args.device))):
        d = out[name] = mshr_demo(unit, g)
        print(f"  {name}: {g.mshr_cap} concurrent lookups -> "
              f"{len(d['flash_reads'])} flash read(s), {d['mshr_merge']} "
              f"MSHR merges; responses delivered: {len(d['responses'])}; "
              f"dppn of DLPN 0 = "
              f"{[r[2] for r in d['responses'] if r[0] == 100]}")
    if out["engine"] != out["oracle"]:
        raise SystemExit("engine and oracle differ")
    return out


if __name__ == "__main__":
    main()
