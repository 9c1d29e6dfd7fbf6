"""Causal / sliding-window / softcap GQA flash attention (prefill): the
CUDA kernel of ``csrc/flash_attention.cu`` and its plain torch version.

Port of ``repro/kernels/flash_attention.py``. Causal masking is
right-aligned (query row i sits at position i + Skv - Sq); fully masked
KV tiles are skipped; sequence lengths need no padding. A CPU tensor
takes the plain version (``flash_attention_ref``); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_naive

LAUNCHES = COUNTERS.cell("kernel.flash_attention")
flash_attention_ref = attention_naive
HEAD_DIMS = (16, 32, 64, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_F, _F, _I, _I, _I, _P]

__all__ = ["flash_attention", "flash_attention_ref", "LAUNCHES"]


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    segment_ids=None, bidirectional=False):
    """q [B,Sq,H,D]; k,v [B,Skv,KV,D] -> [B,Sq,H,D]."""
    if segment_ids is not None:
        raise NotImplementedError(
            "segment_ids: packed-sequence masks are not supported by the "
            "flash kernel (the reference falls back to its blocked "
            "lowering, which is not ported)")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap,
                                   bidirectional=bidirectional)
    dev = q.device
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: H={h} not a multiple of KV={kv}")
    req = _build.require
    req(q, "q", device=dev, dtype=q.dtype, shape=(b, sq, h, d))
    req(k, "k", device=dev, dtype=q.dtype, shape=(b, skv, kv, d))
    req(v, "v", device=dev, dtype=q.dtype, shape=(b, skv, kv, d))
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    lib = _build.load("flash_attention", _ARGTYPES)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, skv, h, kv, d, 1.0 / math.sqrt(d), float(softcap or 0.0),
        int(window or 0), int(causal and not bidirectional),
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    _build.check(lib, "flash_attention", err)
    LAUNCHES[0] += 1
    return out
