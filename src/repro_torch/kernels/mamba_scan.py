"""Mamba2 SSD scan (prefill of every SSM layer, and training): the CUDA
kernels of ``csrc/mamba_scan.cu`` (forward) and ``csrc/mamba_scan_bwd.cu``
(backward) and their plain torch versions.

Port of ``repro/kernels/mamba_scan.py``. One launch per call; the C entry
point routes by dtype to one of two hand-written bodies:

- bf16 (the serving path): the chunked SSD form on the tensor cores
  (``mma.sync``), chunks of 128 tokens at d_state 128 (64 at 16), one
  dependent step per chunk, the state in f32 registers across chunks,
  32 rows of P a block (64 at d_state 16): a plan from shapes alone.
- f32: the sequential recurrence on the CUDA cores (TF32 operands would
  miss the f32 tolerance).

What bounds it: bytes (x in and y out once, ~5.9 us at the serving
shape). The token-by-token chain of the recurrence kept the bf16 path
at 57x that bound; the chunked form runs 1/128 as many dependent steps,
and what holds it now is the latency of each chunk's phases (the source
note says more). Both bodies take any S >= 1 without padding (rows past
S load as zero with dt = 0), and ``chunk`` does not change the result
beyond rounding. A CPU tensor takes the plain version
(``mamba_chunk_scan_ref``, the naive scan); a CUDA tensor launches the
kernel or raises.

The gradient, which the reference takes with ``jax.grad`` through its
blocked lowering: ``mamba_chunk_scan_bwd`` runs the backward kernel and
``MambaChunkScanFn`` carries both kernels under autograd. bf16 with P <=
64 (training) runs the chunk-parallel tensor-core body in three
launches: a walk that writes each 64-token chunk's entry state and its
adjoint, the chunk-local gradients of a group of eight heads a block
(dB and dC summed over the group inside it), and a fixed-order sum of
the partials. f32 (and bf16 at P > 64) runs the first version, a scan
over the chunks of each (batch, head) on the CUDA cores and a
fixed-order sum of its per-head partials: two launches. Both are
bit-identical on repeat. The raw ``mamba_chunk_scan`` still raises under autograd on a CUDA tensor;
``ops.mamba_chunk_scan`` sends such a call through the Function.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (mamba_chunk_scan_bwd_ref,
                                     mamba_chunk_scan_naive)

LAUNCHES = COUNTERS.cell("kernel.mamba_chunk_scan")
BWD_LAUNCHES = COUNTERS.cell("kernel.mamba_chunk_scan_bwd")
mamba_chunk_scan_ref = mamba_chunk_scan_naive
# the d_states and dtypes the kernel is built for: mamba2-1.3b's 128,
# the smoke configuration's 16, and the engine's compute dtypes
D_STATES = (16, 128)
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 6 + [_P]
_BWD_ARGTYPES = [_P] * 17 + [_I] * 6 + [_P]

__all__ = ["mamba_chunk_scan", "mamba_chunk_scan_ref", "mamba_chunk_scan_bwd",
           "mamba_chunk_scan_bwd_ref", "MambaChunkScanFn", "LAUNCHES",
           "BWD_LAUNCHES"]


def _bwd_lib():
    lib = _build.load("mamba_scan_bwd", _BWD_ARGTYPES)
    lib.mamba_scan_bwd_workspace.argtypes = [_I] * 6
    lib.mamba_scan_bwd_workspace.restype = ctypes.c_longlong
    return lib


def _check(x, dt, A, B, C, D, initial_state, name):
    """Raise unless the kernels take these inputs."""
    dev = x.device
    bt, s, h, p = x.shape
    n = B.shape[-1]
    if x.dtype not in DTYPES:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    if n not in D_STATES:
        raise ValueError(f"{name}: d_state {n} not in {D_STATES}")
    f32 = torch.float32
    req = _build.require
    req(x, "x", device=dev, dtype=x.dtype, shape=(bt, s, h, p))
    req(dt, "dt", device=dev, dtype=f32, shape=(bt, s, h))
    req(A, "A", device=dev, dtype=f32, shape=(h,))
    req(D, "D", device=dev, dtype=f32, shape=(h,))
    req(B, "B", device=dev, dtype=x.dtype, shape=(bt, s, n))
    req(C, "C", device=dev, dtype=x.dtype, shape=(bt, s, n))
    if initial_state is not None:
        req(initial_state, "initial_state", device=dev, dtype=f32,
            shape=(bt, h, p, n))


def mamba_chunk_scan(x, dt, A, B, C, D, *, chunk=256, initial_state=None):
    """x [Bt,S,H,P]; dt [Bt,S,H] f32; A, D [H] f32; B, C [Bt,S,N] in x's
    dtype; initial_state [Bt,H,P,N] f32 or None -> (y [Bt,S,H,P] in x's
    dtype, final_state [Bt,H,P,N] f32)."""
    if x.device.type == "cpu":
        return mamba_chunk_scan_ref(x, dt, A, B, C, D, chunk=chunk,
                                    initial_state=initial_state)
    _build.refuse_grad("mamba_chunk_scan", x, dt, A, B, C, D, initial_state,
                       via="ops.mamba_chunk_scan (MambaChunkScanFn)")
    _check(x, dt, A, B, C, D, initial_state, "mamba_chunk_scan")
    dev = x.device
    bt, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    if B.data_ptr() % 16 or C.data_ptr() % 16:
        raise ValueError("mamba_chunk_scan: B and C must start on a "
                         "16-byte boundary (the kernel loads 16-byte "
                         "vectors)")
    y = torch.empty_like(x)
    if bt * h * p == 0 or s == 0:
        fin = (initial_state.clone() if initial_state is not None else
               torch.zeros((bt, h, p, n), dtype=f32, device=dev))
        return y, fin
    fin = torch.empty((bt, h, p, n), dtype=f32, device=dev)
    s0 = initial_state.data_ptr() if initial_state is not None else None
    lib = _build.load("mamba_scan", _ARGTYPES)
    err = lib.mamba_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), s0, y.data_ptr(), fin.data_ptr(),
        bt, s, h, p, n, _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check(lib, "mamba_chunk_scan", err)
    LAUNCHES[0] += 1
    return y, fin


def _ptr(t):
    return None if t is None else t.data_ptr()


def mamba_chunk_scan_bwd(x, dt, A, B, C, D, dy, dfinal=None, *,
                         initial_state=None):
    """The scan's gradient from its inputs and the cotangents dy
    [Bt,S,H,P] (x's dtype) and ``dfinal`` [Bt,H,P,N] f32 (None: zero) ->
    (dx, ddt, dA, dB, dC, dD, dinitial_state): dx, dB, dC in x's dtype,
    the rest f32, dinitial_state None without an initial state. A CUDA
    tensor runs the backward kernel (three launches on the bf16
    tensor-core body, two on the first version; one count), a CPU tensor ``mamba_chunk_scan_bwd_ref``. Deterministic:
    repeated calls are bit-identical."""
    if x.device.type == "cpu":
        return mamba_chunk_scan_bwd_ref(x, dt, A, B, C, D, dy, dfinal,
                                        initial_state=initial_state)
    _check(x, dt, A, B, C, D, initial_state, "mamba_chunk_scan_bwd")
    dev = x.device
    bt, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    _build.require(dy, "dy", device=dev, dtype=x.dtype, shape=x.shape)
    if dfinal is not None:
        _build.require(dfinal, "dfinal", device=dev, dtype=f32,
                       shape=(bt, h, p, n))
    dx = torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    ddt = torch.empty_like(dt)
    dA = torch.empty((h,), dtype=f32, device=dev)
    dD = torch.empty_like(dA)
    ds0 = None if initial_state is None else torch.empty_like(initial_state)
    if bt * h * p * s == 0:
        if ds0 is not None:
            ds0 = (dfinal.clone() if dfinal is not None and s == 0
                   else ds0.zero_())
        return (dx.zero_(), ddt.zero_(), dA.zero_(), dB.zero_(), dC.zero_(),
                dD.zero_(), ds0)
    lib = _bwd_lib()
    code = _build.DTYPE_CODES[x.dtype]
    ws = torch.empty(lib.mamba_scan_bwd_workspace(bt, s, h, p, n, code) // 4,
                     dtype=f32, device=dev)
    err = lib.mamba_scan_bwd_launch(
        *(_ptr(t) for t in (x, dt, A, B, C, D, initial_state, dy, dfinal,
                            dx, ds0, dB, dC, ddt, dA, dD, ws)),
        bt, s, h, p, n, code, _build.stream_ptr(x))
    _build.check(lib, "mamba_chunk_scan_bwd", err)
    BWD_LAUNCHES[0] += 1
    return dx, ddt, dA, dB, dC, dD, ds0


class MambaChunkScanFn(torch.autograd.Function):
    """The scan with a hand-written backward: ``forward(x, dt, A, B, C,
    D, initial_state, chunk, fwd, bwd)`` runs ``fwd(x, dt, A, B, C, D,
    chunk=, initial_state=)`` -> (y, final_state) and saves its inputs
    (the backward recomputes the states); ``backward(dy, dfinal)`` runs
    ``bwd(x, dt, A, B, C, D, dy, dfinal, initial_state=)`` -> the seven
    gradients, each cast to its input's dtype. An unused output's
    cotangent arrives as None (``dfinal`` None: zero). The CUDA path
    passes the two kernels; a CPU test passes the plain versions."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, initial_state, chunk, fwd, bwd):
        y, fin = fwd(x, dt, A, B, C, D, chunk=chunk,
                     initial_state=initial_state)
        ctx.save_for_backward(x, dt, A, B, C, D, initial_state)
        ctx.bwd = bwd
        ctx.set_materialize_grads(False)
        return y, fin

    @staticmethod
    def backward(ctx, dy, dfinal):
        saved = ctx.saved_tensors
        x, s0 = saved[0], saved[6]
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ctx.bwd(*saved[:6], dy,
                        None if dfinal is None else dfinal.contiguous(),
                        initial_state=s0)
        return tuple(None if g is None else g.to(t.dtype)
                     for g, t in zip(grads, saved)) + (None, None, None)
