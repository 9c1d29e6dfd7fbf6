#!/usr/bin/env python3
"""Where the paged attention kernel's bf16 time goes, at the served
decode shapes:

    python3 tools/paged_attention_probe.py [--variants kernel,no_cluster]
        [--shapes glm4,g2]

Builds modified copies of src/repro_torch/csrc/paged_attention.cu (bf16
entries only) into build/probe/ (the repo's source is not touched; the
copies are patched at literal lines of the tensor-core body and its
launch, so edit the anchors below with them) and calls each through the same C entry
point as the wrapper, at B=8 P=16 bf16 with a random block table, every
lane at one context. Shapes (H / KV, D): glm4 32/2 128, g2 16/8 128, g8
64/8 128, gemma2 16/8 256, llama 32/8 64, seamless 16/16 64.

For the unmodified kernel ("kernel") it prints, with the wrapper's plan:
the time at ctx 0 / 128 / 512 / 1024 under chip_smoke.Timer (the L2
flushed by a 64 MB write before each launch, so its lines are dirty
when the kernel reads), at ctx 1024 with the L2 warm (no flush) and
after a flush by a 64 MB read (clean lines), and at ctx 1024 with other
split lengths. Every variant is timed at ctx 1024 under
chip_smoke.Timer at 4, 8, 16, 32 and 64 pages a split (combined with
"+", e.g.
"no_cluster+no_combine"):
- "no_cluster": every split count combines through device memory and
  the ticket (no thread-block cluster);
- "no_combine": on that path, the last block of a cell does not combine
  (the splits' partials, fence and ticket stay);
- "ring3", "ring4": a ring of 3 (4) K/V stages at every head_dim (the
  kernel: 4 at head_dim <= 64, else 3);
- "no_products": no Q K^T, softmax or P V (the loads and the merge
  stay);
- "no_loads": no K / V cp.async (the products run on whatever shared
  memory holds);
- "addr_shift": a stage's row addresses with the page size fixed at the
  probe's 16 (a shift and a mask where the kernel divides by the
  runtime page size);
- "trace": %globaltimer stamps of one launch at the wrapper's plan (a
  line ``trace_<variant>`` a shape: see ``trace``).
SDPA over the pre-gathered pages is timed beside under each timer.
Prints the card's name and power limit, then one JSON line a shape.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "probe"

SHAPES = {"glm4": (32, 2, 128), "g2": (16, 8, 128), "g8": (64, 8, 128),
          "gemma2": (16, 8, 256), "llama": (32, 8, 64),
          "seamless": (16, 16, 64)}
B, PAGE, MAXP = 8, 16, 64

# bf16 entries only (a third of the build)
BF16_ONLY = [("    case kF32: return launch_f32_t(D, a);\n", ""),
             ("  return launch_tc_t<__half>(D, a);\n",
              "  return (int)cudaErrorInvalidValue;\n")]
# anchors: literal lines of the tensor-core body
VARIANTS = {
    "kernel": [],
    "no_cluster": [("  if (a.n_split > 1 && a.n_split <= kMaxCluster &&",
                    "  if (false && a.n_split <= kMaxCluster &&")],
    "no_combine": [("  if (!s_last) return;\n  __threadfence();\n",
                    "  if (s_last && tid == 0) counters[cell] = 0;\n"
                    "  if (nq >= 0) return;\n")],
    "no_products": [("    const bool live = k0 < t_end;",
                     "    const bool live = k0 < 0;")],
    "ring3": [("return D <= 64 ? 4 : 3;", "return 3;")],
    "ring4": [("return D <= 64 ? 4 : 3;", "return 4;")],
    "trace": [
        ("constexpr int kSliceKeys = 16;",
         "__device__ unsigned long long g_ts[64][6];\n"
         "__device__ unsigned long long g_span[2];\n"
         "#define PROBE_TS(k) do { if (tid == 0) { unsigned long long t_; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
         "if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z < 64) "
         "g_ts[blockIdx.z][k] = t_; if (k == 0) atomicMin(&g_span[0], t_); "
         "atomicMax(&g_span[1], t_); } } while (0)\n"
         "constexpr int kSliceKeys = 16;"),
        ("  const int ks = warp / NG, mt = (warp / CG) % MT, cg = warp % CG;\n",
         "  const int ks = warp / NG, mt = (warp / CG) % MT, cg = warp % CG;\n"
         "  PROBE_TS(0);\n"),
        ("  __syncthreads();  // the ring is free",
         "  PROBE_TS(1);\n  __syncthreads();  // the ring is free"),
        ("    cluster_sync();\n    float2* aw",
         "    PROBE_TS(2);\n    cluster_sync();\n    PROBE_TS(3);\n"
         "    float2* aw"),
        ("    cluster_sync();  // no block leaves",
         "    PROBE_TS(4);\n    cluster_sync();  // no block leaves"),
        ("  if (tid == 0) {  // a cumulative fence: the whole block's partial\n"
         "    __threadfence();\n"
         "    s_last = atomicAdd(&counters[cell], 1) == n_split - 1;\n  }\n",
         "  PROBE_TS(2);\n"
         "  if (tid == 0) {  // a cumulative fence: the whole block's partial\n"
         "    __threadfence();\n"
         "    s_last = atomicAdd(&counters[cell], 1) == n_split - 1;\n  }\n"
         "  PROBE_TS(3);\n"),
        ("  if (!s_last) return;\n  __threadfence();\n",
         "  if (!s_last) { PROBE_TS(5); return; }\n  __threadfence();\n"),
        ("  if (tid == 0) counters[cell] = 0;\n}\n",
         "  PROBE_TS(4);\n  if (tid == 0) counters[cell] = 0;\n}\n"),
    ],
    "addr_shift": [("          const int pg = pos / P;\n"
                    "          const size_t blk = (size_t)tbl[pg - p0];\n"
                    "          off = ((blk * P + (pos - pg * P)) * KV + kvh) "
                    "* D + cc * EPC;",
                    "          const int pg = pos >> 4;\n"
                    "          const size_t blk = (size_t)tbl[pg - p0];\n"
                    "          off = ((blk * 16 + (pos & 15)) * KV + kvh) "
                    "* D + cc * EPC;")],
    "no_loads": [("        cp_async16(kst + r * LD + cc * EPC, k_pool + off, "
                  "ok);\n        cp_async16(vst + r * LD + cc * EPC, "
                  "v_pool + off, ok);\n", "")],
}

TRACE_END = """
extern "C" int paged_probe_stamps(unsigned long long* ts,
                                  unsigned long long* span, int reset) {
  if (reset) {
    static unsigned long long zero[64 * 6] = {};
    const unsigned long long init[2] = {~0ull, 0ull};
    cudaMemcpyToSymbol(g_ts, zero, sizeof(zero));
    cudaMemcpyToSymbol(g_span, init, sizeof(init));
  } else {
    cudaMemcpyFromSymbol(ts, g_ts, 64 * 6 * 8);
    cudaMemcpyFromSymbol(span, g_span, 16);
  }
  return (int)cudaGetLastError();
}
"""


def build(names):
    """nvcc every variant at once; {name: ctypes library}."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "paged_attention.cu").read_text()
    jobs = {}
    for name in names:
        text = src
        body = text.index("// K/V stages in shared memory")
        head, text = text[:body], text[body:]
        patches = [pt for part in name.split("+") for pt in VARIANTS[part]]
        for old, new in BF16_ONLY + patches:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: anchor not found once: {old!r}")
            text = text.replace(old, new)
        text = head + text
        if "trace" in name:
            text += TRACE_END
        tag = name.replace("+", "_and_")
        cu = OUT / f"paged_{tag}.cu"
        cu.write_text(text)
        so = OUT / f"libpaged_{tag}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC}", "-o",
               str(so), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill")]
        lib = ctypes.CDLL(str(so))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention_launch.argtypes = [p] * 10 + [i] * 9 + \
            [f, f, i, i, p]
        lib.paged_attention_launch.restype = ctypes.c_int
        libs[name] = lib
        print(json.dumps({"variant": name, "spill_lines": spills}),
              flush=True)
    return libs


class Caller:
    """One shape's inputs and scratch, called through a library with a
    given plan."""

    def __init__(self, h, kv, d, seed=0):
        from repro_torch.kernels import paged_attention as pa
        self.pa, self.h, self.kv, self.d = pa, h, kv, d
        nb = B * MAXP + 1
        g = torch.Generator(device="cuda").manual_seed(seed)
        self.q = torch.randn((B, h, d), generator=g, device="cuda").bfloat16()
        self.kp, self.vp = (torch.randn((nb, PAGE, kv, d), generator=g,
                                        device="cuda").bfloat16()
                            for _ in range(2))
        rng = np.random.default_rng(seed)
        self.table = torch.from_numpy(rng.permutation(nb)[:B * MAXP].reshape(
            B, MAXP).astype(np.int32)).cuda()
        self.out = torch.empty_like(self.q)
        g_n = h // kv     # at most 16 splits (4 pages a split)
        self.part = torch.empty(B * kv * 16 * (g_n * d + 2 * g_n + 4),
                                dtype=torch.float32, device="cuda")
        self.counters = torch.zeros(B * kv * 2, dtype=torch.int32,
                                    device="cuda")
        self.plan = pa.plan(B, h, kv, MAXP, PAGE,
                            pa._sm_count(torch.cuda.current_device()))

    def ctx(self, n):
        return torch.full((B,), n, dtype=torch.int32, device="cuda")

    def fn(self, lib, ctx, pps=None):
        pps = pps or self.plan.pages_per_split
        n_split = -(-MAXP // pps)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            err = lib.paged_attention_launch(
                self.q.data_ptr(), self.kp.data_ptr(), self.vp.data_ptr(),
                self.table.data_ptr(), ctx.data_ptr(), self.out.data_ptr(),
                None, None, self.part.data_ptr(), self.counters.data_ptr(),
                B, self.h, self.kv, self.d, PAGE, MAXP,
                self.plan.heads_per_block, n_split, pps,
                1.0 / math.sqrt(self.d), 0.0, 0, 1, stream)
            if err:
                raise SystemExit(f"launch returned {err}")
        return call

    def sdpa(self, ctx_len):
        import chip_smoke as cs
        kg = self.kp[self.table.long()].reshape(B, MAXP * PAGE, self.kv,
                                                self.d)[:, :ctx_len]
        vg = self.vp[self.table.long()].reshape(B, MAXP * PAGE, self.kv,
                                                self.d)[:, :ctx_len]
        kg, vg = (t.transpose(1, 2).contiguous() for t in (kg, vg))
        q4 = self.q[:, :, None, :]
        return lambda: cs._sdpa(q4, kg, vg)


class Timers:
    """chip_smoke.Timer (a write flush: dirty L2 lines), the same with a
    read flush (clean lines), and warm (no flush)."""

    def __init__(self):
        import chip_smoke as cs
        self.cold = cs.Timer()
        self.buf = self.cold.flush

    def _ms(self, fn, flush, iters=20):
        import statistics
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.cold.SPIN_CYCLES)
            if flush:
                flush()
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def dirty(self, fn):
        return self.cold.ms(fn)

    def clean(self, fn):
        # a read of 64 MB: the L2 then holds clean lines of the buffer
        return self._ms(fn, lambda: self.buf.view(torch.int64).sum())

    def warm(self, fn):
        return self._ms(fn, None)


def trace(lib, c, ctx, timers):
    """One launch's %globaltimer stamps (ns), after a spin and the write
    flush: the first block's start to the last block's end, and for the
    blocks of cell (KV head 0, sequence 0), by split: start, loads done,
    partial written, ticket taken / cluster met, combine done (the
    combining block) or exit (the others), from the first start, in us."""
    ts = np.zeros((64, 6), dtype=np.uint64)
    span = np.zeros(2, dtype=np.uint64)
    p = ctypes.c_void_p
    lib.paged_probe_stamps.argtypes = [p, p, ctypes.c_int]
    call = c.fn(lib, ctx)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    lib.paged_probe_stamps(None, None, 1)
    torch.cuda._sleep(timers.cold.SPIN_CYCLES)
    timers.cold.flush.zero_()
    call()
    torch.cuda.synchronize()
    lib.paged_probe_stamps(ts.ctypes.data, span.ctypes.data, 0)
    t0 = int(span[0])
    n = c.plan.n_split
    rel = [[round((int(v) - t0) / 1e3, 3) if v else None for v in row]
           for row in ts[:n]]
    return {"span_us": round((int(span[1]) - t0) / 1e3, 3),
            "by_split_us": rel}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="kernel,no_cluster,"
                    "no_cluster+no_combine,ring3,ring4,trace,"
                    "no_cluster+trace,no_products,no_loads")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    a = ap.parse_args(argv)
    names = a.variants.split(",")
    if "kernel" not in names:
        names.insert(0, "kernel")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    libs = build(names)
    timers = Timers()
    full = MAXP * PAGE
    for shape in a.shapes.split(","):
        h, kv, d = SHAPES[shape]
        c = Caller(h, kv, d)
        k = libs["kernel"]
        row = {"shape": shape, "h": h, "kv": kv, "d": d,
               "plan": c.plan._asdict()}
        for n in (0, 128, 512, full):
            row[f"ms_ctx{n}"] = timers.dirty(c.fn(k, c.ctx(n)))
        ctx = c.ctx(full)
        row["ms_warm"] = timers.warm(c.fn(k, ctx))
        row["ms_clean"] = timers.clean(c.fn(k, ctx))
        for name in names:
            for pps in (4, 8, 16, 32, 64):
                row[f"ms_{name}_pps{pps}"] = timers.dirty(
                    c.fn(libs[name], ctx, pps))
        for name in names:
            if "trace" in name:
                row[f"trace_{name}"] = trace(libs[name], c, ctx, timers)
        lib = c.sdpa(full)
        row.update(sdpa_ms=timers.dirty(lib), sdpa_ms_warm=timers.warm(lib),
                   sdpa_ms_clean=timers.clean(lib))
        row = {k2: round(v, 6) if isinstance(v, float) else v
               for k2, v in row.items()}
        print(json.dumps(row), flush=True)
        del c
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
