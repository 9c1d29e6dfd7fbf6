"""Paged decode attention over FMMU block tables: the CUDA kernel of
``csrc/paged_attention.cu`` and its plain torch version.

Port of ``repro/kernels/paged_attention.py``. The block table (the
FMMU's translation output: logical page -> physical block) names the
pool block each page of context is read from. A CPU tensor takes the
plain version (``paged_attention_ref``); a CUDA tensor launches the
kernel or raises.

Contract: ``0 <= block_table[b, i] < NB`` for every live page
(i * P < ctx_lens[b]) — the serving engine's ``_mask_tables`` clamps NIL
and host-tier ids to its scratch block before the call. A lane with
ctx_lens 0 returns 0 (m = -1e30, l = 0), as the Pallas kernel does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_naive

LAUNCHES = COUNTERS.cell("kernel.paged_attention")
paged_attention_ref = paged_attention_naive

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 8 + [_I] * 6 + [_F, _F, _I, _I, _P]

__all__ = ["paged_attention", "paged_attention_ref", "LAUNCHES"]


def paged_attention(q, k_pool, v_pool, block_table, ctx_lens, *,
                    softcap=0.0, window=0, return_stats=False):
    """q [B,H,D]; pools [NB,P,KV,D]; block_table [B,MAXP] int32;
    ctx_lens [B] int32 -> [B,H,D] (+ (m,l) [B,H] fp32)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_table,
                                   ctx_lens, softcap=softcap, window=window,
                                   return_stats=return_stats)
    dev = q.device
    b, h, d = q.shape
    nb, p, kv, _ = k_pool.shape
    maxp = block_table.shape[1]
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"paged_attention: unsupported dtype {q.dtype}")
    if kv == 0 or h % kv:
        raise ValueError(f"paged_attention: H={h} not a multiple of KV={kv}")
    req = _build.require
    req(q, "q", device=dev, dtype=q.dtype, shape=(b, h, d))
    req(k_pool, "k_pool", device=dev, dtype=q.dtype, shape=(nb, p, kv, d))
    req(v_pool, "v_pool", device=dev, dtype=q.dtype, shape=(nb, p, kv, d))
    req(block_table, "block_table", device=dev, dtype=torch.int32,
        shape=(b, maxp))
    req(ctx_lens, "ctx_lens", device=dev, dtype=torch.int32, shape=(b,))
    out = torch.empty_like(q)
    m = l = None
    if return_stats:
        m = torch.empty((b, h), dtype=torch.float32, device=dev)
        l = torch.empty((b, h), dtype=torch.float32, device=dev)
    if b > 0:
        lib = _build.load("paged_attention", _ARGTYPES)
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
            m.data_ptr() if m is not None else None,
            l.data_ptr() if l is not None else None,
            b, h, kv, d, p, maxp, 1.0 / math.sqrt(d), float(softcap or 0.0),
            int(window or 0), _build.DTYPE_CODES[q.dtype],
            _build.stream_ptr(q))
        _build.check(lib, "paged_attention", err)
        LAUNCHES[0] += 1
    if return_stats:
        return out, (m, l)
    return out
