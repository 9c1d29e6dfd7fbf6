#!/usr/bin/env python3
"""Run the scan backward kernel's C++ on the CPU beside its plain
versions:

    PYTHONPATH=src python3 tools/mamba_scan_bwd_host_check.py [--quick]
    PYTHONPATH=src python3 tools/mamba_scan_bwd_host_check.py --warps

Builds ``src/repro_torch/csrc/mamba_scan_bwd.cu`` with g++ and
``-DREPRO_HOST_EMULATION`` into ``build/host_check/``, against a stub
``common.cuh``: each block's CUDA threads run as CPU threads meeting at
a ``std::barrier`` for every ``__syncthreads()``, blocks one after
another, bf16 as its 16 bits with round-to-nearest-even, and shared
memory filled with NaN before each block, so a read of a word no phase
wrote shows. Without ``--warps`` the tensor-core body is compiled out
and every case runs the first version (no warp primitive), bf16
included. With ``--warps`` (``-DREPRO_HOST_WARPS``) the stub also runs
the warp primitives the tensor-core body uses, each lane a thread
meeting its warp at a barrier: ``ldmatrix`` (plain and transposed) and
``mma.sync.m16n8k16`` with their fragment layouts (the products summed
in f32 in k order), the shuffles, ``__syncwarp`` and ``cp.async`` (a
copy); bf16 cases with P <= 64 then run the three launches of the
tensor-core body, held against the blocked version at its chunk of 64.
Each case holds the launches' outputs against
``mamba_chunk_scan_bwd_blocked`` (the kernel's arithmetic in torch) and
``mamba_chunk_scan_bwd_ref`` (autograd through the naive scan) at
d_state 16 and 128, f32 and bf16, with and without an initial state and
dfinal, S a multiple of the chunk and not, P of one 64-row slice, of
two (the second ragged) and of 16, more than one group of eight heads,
and dt from ``init_ssm``'s range and ten times it. f32: each gradient
within 1e-5 of its max |value| of the blocked version and 1e-4 of the
autograd one; bf16 (dx, dB, dC rounded to bf16): max |got - want| /
max(1, |want|) within 1e-2, the f32 outputs within 1e-4. Needs g++ with
C++20; no card. Prints one line a case; exits nonzero on the first
failure.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "host_check"

from repro_torch.kernels.ref import (mamba_chunk_scan_bwd_blocked,  # noqa: E402
                                     mamba_chunk_scan_bwd_ref)

STUB = r"""#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(n) alignas(n)
enum ReproDtype { kF32 = 0, kBF16 = 1, kF16 = 2 };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
struct __nv_bfloat16 { uint16_t bits; };
inline float to_f32(float v) { return v; }
inline float to_f32(__nv_bfloat16 v) {
  uint32_t u = (uint32_t)v.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
template <typename T> T from_f32(float v);
template <> inline float from_f32<float>(float v) { return v; }
template <> inline __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline std::barrier<>* repro_host_bar;
inline unsigned char* repro_host_smem;
#define __syncthreads() repro_host_bar->arrive_and_wait()
#define BWD_SMEM(name) unsigned char* name = repro_host_smem
template <typename F>
void repro_host_launch(dim3 grid, dim3 block, size_t smem, F fn) {
  gridDim = grid;
  blockDim = block;
  std::vector<float> buf(smem / 4 + 1);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        for (auto& w : buf) w = NAN;
        std::barrier<> bar(block.x);
        repro_host_bar = &bar;
        REPRO_HOST_BLOCK_WARPS
        repro_host_smem = reinterpret_cast<unsigned char*>(buf.data());
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < block.x; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by, bz);
            fn();
          });
        for (auto& th : ts) th.join();
      }
}
extern "C" const char* repro_error_string(int) { return "host emulation"; }
"""
WARP_LAUNCH = ("std::unique_ptr<ReproWarp[]> warps("
               "new ReproWarp[block.x / 32]); "
               "repro_host_warps = warps.get();")

WARP_STUB = r"""
#include <memory>
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {to_f32(v.x), to_f32(v.y)};
}
inline __nv_bfloat16 __float2bfloat16(float v) {
  return from_f32<__nv_bfloat16>(v);
}
struct ReproWarp {
  std::barrier<> bar{32};
  float f[32];
  const void* addr[32];
  uint32_t a[32][4], b[32][2];
};
inline ReproWarp* repro_host_warps;
inline ReproWarp& repro_warp() { return repro_host_warps[threadIdx.x >> 5]; }
inline int repro_lane() { return (int)(threadIdx.x & 31); }
inline void __syncwarp() { repro_warp().bar.arrive_and_wait(); }
template <typename F>
inline float repro_shfl(float v, F src) {
  ReproWarp& w = repro_warp();
  const int l = repro_lane();
  w.f[l] = v;
  w.bar.arrive_and_wait();
  const int s = src(l);
  const float r = s < 0 ? v : w.f[s];
  w.bar.arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int m) {
  return repro_shfl(v, [m](int l) { return l ^ m; });
}
inline float __shfl_up_sync(unsigned, float v, int d) {
  return repro_shfl(v, [d](int l) { return l >= d ? l - d : -1; });
}
inline float __shfl_down_sync(unsigned, float v, int d) {
  return repro_shfl(v, [d](int l) { return l + d < 32 ? l + d : -1; });
}
inline float __shfl_sync(unsigned, float v, int s) {
  return repro_shfl(v, [s](int) { return s; });
}
inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
inline void cp_async16(void* d, const void* s, bool ok) {
  if (ok) std::memcpy(d, s, 16); else std::memset(d, 0, 16);
}
inline void cp_async4(void* d, const void* s, bool ok) {
  if (ok) std::memcpy(d, s, 4); else std::memset(d, 0, 4);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline float repro_bits(uint16_t h) {
  const uint32_t u = (uint32_t)h << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// ldmatrix x4: lanes 8i .. 8i+7 address the rows of matrix i; lane l
// gets row l/4, elements 2(l%4), 2(l%4)+1 of each (transposed: row
// 2(l%4) and 2(l%4)+1, element l/4)
template <bool T>
inline void repro_ldsm(uint32_t* r, const void* p) {
  ReproWarp& w = repro_warp();
  const int l = repro_lane();
  w.addr[l] = p;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    if (T) {
      const uint16_t* r0 = (const uint16_t*)w.addr[8 * i + 2 * (l % 4)];
      const uint16_t* r1 = (const uint16_t*)w.addr[8 * i + 2 * (l % 4) + 1];
      r[i] = r0[l / 4] | (uint32_t)r1[l / 4] << 16;
    } else {
      const uint16_t* row = (const uint16_t*)w.addr[8 * i + l / 4];
      r[i] = row[2 * (l % 4)] | (uint32_t)row[2 * (l % 4) + 1] << 16;
    }
  }
  w.bar.arrive_and_wait();
}
inline void ldsm_x4(uint32_t* r, const void* p) { repro_ldsm<false>(r, p); }
inline void ldsm_x4_trans(uint32_t* r, const void* p) {
  repro_ldsm<true>(r, p);
}
template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  // c (rows l/4 and l/4 + 8, columns 2(l%4) and + 1) += a b: a's
  // element (r, k) in register (r >= 8) + 2 (k >= 8) of lane (r%8) 4 +
  // (k%8)/2, b's (k, n) in register k >= 8 of lane 4 n + (k%8)/2, the
  // low half the even k
  static void run(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    ReproWarp& w = repro_warp();
    const int l = repro_lane();
    std::memcpy(w.a[l], a, 16);
    w.b[l][0] = b0;
    w.b[l][1] = b1;
    w.bar.arrive_and_wait();
    float out[4];
    for (int e = 0; e < 4; ++e) {
      const int r = l / 4 + 8 * (e >> 1), n = 2 * (l % 4) + (e & 1);
      float s = 0.f;
      for (int k = 0; k < 16; ++k) {
        const uint32_t av =
            w.a[(r % 8) * 4 + (k % 8) / 2][(r >= 8) + 2 * (k >= 8)];
        const uint32_t bv = w.b[n * 4 + (k % 8) / 2][k >= 8];
        s += repro_bits(k % 2 ? av >> 16 : av & 0xffff) *
             repro_bits(k % 2 ? bv >> 16 : bv & 0xffff);
      }
      out[e] = c[e] + s;
    }
    w.bar.arrive_and_wait();
    for (int e = 0; e < 4; ++e) c[e] = out[e];
  }
  static uint32_t pack(float lo, float hi) {
    return from_f32<__nv_bfloat16>(lo).bits |
           (uint32_t)from_f32<__nv_bfloat16>(hi).bits << 16;
  }
};
template <typename T>
inline void split_hi_lo(float a, float b, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = Mma<T>::pack(a, b);
  hi = h;
  lo = Mma<T>::pack(a - repro_bits(h & 0xffff), b - repro_bits(h >> 16));
}
"""


def build(warps: bool) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    stub = STUB.replace("REPRO_HOST_BLOCK_WARPS", WARP_LAUNCH if warps else "")
    if warps:   # after the types the warp stub uses, before the launcher
        head, tail = stub.split("inline std::barrier<>* repro_host_bar;")
        stub = (head + WARP_STUB + "inline std::barrier<>* repro_host_bar;"
                + tail)
    (OUT / "common.cuh").write_text(stub)
    src = OUT / "mamba_scan_bwd.cu"
    src.write_text((CSRC / "mamba_scan_bwd.cu").read_text())
    so = OUT / f"libmamba_scan_bwd_host{'_warps' if warps else ''}.so"
    res = subprocess.run(["g++", "-std=c++20", "-O2", "-pthread",
                          "-DREPRO_HOST_EMULATION", "-Wno-unknown-pragmas",
                          *(["-DREPRO_HOST_WARPS"] if warps else []),
                          "-shared", "-fPIC", "-x", "c++", str(src), "-o",
                          str(so)], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"g++ failed:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    lib.mamba_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 17 + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.mamba_scan_bwd_launch.restype = ctypes.c_int
    lib.mamba_scan_bwd_workspace.argtypes = [ctypes.c_int] * 6
    lib.mamba_scan_bwd_workspace.restype = ctypes.c_longlong
    return lib


def inputs(bt, s, h, p, n, dtype, init, dfin, dt_scale, seed):
    """Values in the model's ranges (models/ssm.py init_ssm): dt =
    softplus(0.5 N(0,1) + a per-head bias) around a rate drawn
    log-uniform in [0.001, 0.1] (times ``dt_scale``), A in -[1, 16]."""
    g = torch.Generator().manual_seed(seed)
    dt0 = dt_scale * torch.exp(torch.rand(h, generator=g) * (
        math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = torch.nn.functional.softplus(
        0.5 * torch.randn((bt, s, h), generator=g) + bias)
    A = -(1.0 + 15.0 * torch.rand(h, generator=g))
    D = 1.0 + 0.1 * torch.randn(h, generator=g)
    x = torch.randn((bt, s, h, p), generator=g).to(dtype)
    B = torch.randn((bt, s, n), generator=g).to(dtype)
    C = torch.randn((bt, s, n), generator=g).to(dtype)
    dy = torch.randn((bt, s, h, p), generator=g).to(dtype)
    s0 = torch.randn((bt, h, p, n), generator=g) if init else None
    df = torch.randn((bt, h, p, n), generator=g) if dfin else None
    return (x, dt, A, B, C, D, dy, df), s0


def run_kernel(lib, args, s0):
    x, dt, A, B, C, D, dy, df = args
    bt, s, h, p = x.shape
    n = B.shape[-1]
    dx = torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    ddt = torch.empty_like(dt)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    ds0 = torch.empty_like(s0) if s0 is not None else None
    code = 1 if x.dtype == torch.bfloat16 else 0
    ws = torch.empty(lib.mamba_scan_bwd_workspace(bt, s, h, p, n, code) // 4)

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = lib.mamba_scan_bwd_launch(
        *(ptr(t) for t in (x, dt, A, B, C, D, s0, dy, df, dx, ds0, dB, dC,
                           ddt, dA, dD, ws)),
        bt, s, h, p, n, code, None)
    if err:
        raise SystemExit(f"launch returned {err}")
    return dx, ddt, dA, dB, dC, dD, ds0


NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinitial_state")


def hold(tag, got, want, tol_rel_max, bf16):
    worst = {}
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            if g is not None:
                raise SystemExit(f"{tag}: {name} given without an initial "
                                 "state")
            continue
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise SystemExit(f"{tag}: {name} not finite")
        if bf16 and name in ("dx", "dB", "dC"):
            err = float(((g - w).abs() / w.abs().clamp_min(1.0)).max())
            tol = 1e-2
        else:
            err = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
            tol = tol_rel_max
        worst[name] = err
        if err > tol:
            raise SystemExit(f"FAIL {tag}: {name} error {err:.3e} > {tol}")
    return worst


CASES = [  # (bt, s, h, p, n, init, dfinal, dt_scale)
    (2, 64, 3, 64, 16, False, False, 1.0),
    (2, 70, 3, 64, 16, True, True, 1.0),
    (1, 33, 2, 80, 16, True, False, 1.0),
    (2, 45, 2, 16, 16, False, True, 10.0),
    (1, 96, 2, 64, 128, False, False, 1.0),
    (1, 100, 2, 64, 128, True, True, 1.0),
    (1, 40, 1, 72, 128, True, True, 10.0),
    (1, 1, 2, 64, 128, True, True, 1.0),
    (1, 130, 10, 64, 16, True, True, 1.0),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="the first four cases (d_state 16) only")
    ap.add_argument("--warps", action="store_true",
                    help="emulate the warp primitives: bf16 at P <= 64 "
                         "runs the tensor-core body")
    a = ap.parse_args()
    lib = build(a.warps)
    cases = CASES[:4] if a.quick else CASES
    for k, (bt, s, h, p, n, init, dfin, dts) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            tc = a.warps and dtype == torch.bfloat16 and p <= 64
            if a.warps and not tc:
                continue
            t0 = time.perf_counter()
            args, s0 = inputs(bt, s, h, p, n, dtype, init, dfin, dts, k)
            got = run_kernel(lib, args, s0)
            again = run_kernel(lib, args, s0)
            if not all(x is None or torch.equal(x, y)
                       for x, y in zip(got, again)):
                raise SystemExit(f"case {k}: repeat differs")
            tag = (f"Bt={bt} S={s} H={h} P={p} N={n} init={init} "
                   f"dfinal={dfin} dt x{dts:g} {str(dtype)[6:]}"
                   f"{' tensor cores' if tc else ''}")
            bf16 = dtype == torch.bfloat16
            blocked = mamba_chunk_scan_bwd_blocked(
                *args, initial_state=s0, chunk=64 if tc else 32)
            w1 = hold(tag + " vs blocked", got, blocked,
                      1e-4 if bf16 else 1e-5, bf16)
            autograd = mamba_chunk_scan_bwd_ref(*args, initial_state=s0)
            w2 = hold(tag + " vs autograd", got, autograd, 1e-4, bf16)
            f32_out = max(v for name, v in w2.items()
                          if not bf16 or name not in ("dx", "dB", "dC"))
            print(f"ok {tag}: worst vs blocked {max(w1.values()):.2e}, "
                  f"vs autograd {max(w2.values()):.2e} (f32 outputs "
                  f"{f32_out:.2e}) ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
