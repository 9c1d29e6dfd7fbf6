"""Mamba2 SSD scan (prefill of every SSM layer): the CUDA kernel of
``csrc/mamba_scan.cu`` and its plain torch version.

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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_chunk_scan_naive

LAUNCHES = COUNTERS.cell("kernel.mamba_chunk_scan")
mamba_chunk_scan_ref = mamba_chunk_scan_naive
# the d_states and dtypes the kernel is built for: mamba2-1.3b's 128,
# the smoke configuration's 16, and the engine's compute dtypes
D_STATES = (16, 128)
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 6 + [_P]

__all__ = ["mamba_chunk_scan", "mamba_chunk_scan_ref", "LAUNCHES"]


def mamba_chunk_scan(x, dt, A, B, C, D, *, chunk=256, initial_state=None):
    """x [Bt,S,H,P]; dt [Bt,S,H] f32; A, D [H] f32; B, C [Bt,S,N] in x's
    dtype; initial_state [Bt,H,P,N] f32 or None -> (y [Bt,S,H,P] in x's
    dtype, final_state [Bt,H,P,N] f32)."""
    if x.device.type == "cpu":
        return mamba_chunk_scan_ref(x, dt, A, B, C, D, chunk=chunk,
                                    initial_state=initial_state)
    dev = x.device
    bt, s, h, p = x.shape
    n = B.shape[-1]
    if x.dtype not in DTYPES:
        raise ValueError(f"mamba_chunk_scan: unsupported dtype {x.dtype}")
    if n not in D_STATES:
        raise ValueError(f"mamba_chunk_scan: d_state {n} not in {D_STATES}")
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
