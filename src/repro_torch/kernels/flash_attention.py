"""Causal / sliding-window / softcap / segmented GQA flash attention
(prefill, the encoder, decode-time cross-attention and training): the
CUDA kernels of ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_bwd.cu`` (backward) and their plain torch
versions.

Port of ``repro/kernels/flash_attention.py``. Causal masking is
right-aligned (query row i sits at position i + Skv - Sq); fully masked
KV tiles are skipped; sequence lengths need no padding. Segment ids
(``segment_ids=(seg_q [B,Sq], seg_k [B,Skv])``, int32) restrict a query
to keys of its own segment inside the same kernel, where the reference
sends them to its blocked jnp lowering; in bf16 / f16 a key tile whose
ids' [min, max] misses the query tile's is neither loaded nor
multiplied, the spans reduced inside the launch (one launch a call, no
scratch; ``ref.fwd_tile_walk`` / ``ref.flash_attention_fwd_blocked``
walk the same tiles). bf16 / f16 at head_dim 256 run an eight-warp body
that splits the scores by key columns and the output by D. A CPU tensor
takes the plain version (``flash_attention_ref``, differentiated by
autograd); a CUDA tensor launches the kernel or raises.

Where autograd records the call (grad enabled and q, k or v requiring
grad), the CUDA path runs ``FlashAttentionFn``: its forward launches the
kernel with the row log-sum-exp, its backward launches the backward
kernel (``flash_attention_bwd``), the gradient the reference takes with
``jax.grad`` through its blocked lowering. Serving never takes it, so
its launches and their ``lse`` (null) are unchanged.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (attention_lse, attention_naive,
                                     flash_attention_bwd_ref)

LAUNCHES = COUNTERS.cell("kernel.flash_attention")
BWD_LAUNCHES = COUNTERS.cell("kernel.flash_attention_bwd")
flash_attention_ref = attention_naive
HEAD_DIMS = (16, 32, 64, 128, 256)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 6 + [_F, _F, _I, _I, _I, _P]
_BWD_ARGTYPES = [_P] * 13 + [_I] * 6 + [_F, _F, _I, _I, _I, _P]

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_ref",
           "FlashAttentionFn", "LAUNCHES", "BWD_LAUNCHES"]


def _check(q, k, v, segment_ids, name):
    """Raise unless the kernel takes these inputs; returns (seg_q,
    seg_k) or (None, None)."""
    dev = q.device
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    if kv == 0 or h % kv:
        raise ValueError(f"{name}: H={h} not a multiple of KV={kv}")
    req = _build.require
    req(q, "q", device=dev, dtype=q.dtype, shape=(b, sq, h, d))
    req(k, "k", device=dev, dtype=q.dtype, shape=(b, skv, kv, d))
    req(v, "v", device=dev, dtype=q.dtype, shape=(b, skv, kv, d))
    if segment_ids is None:
        return None, None
    seg_q, seg_k = segment_ids
    req(seg_q, "seg_q", device=dev, dtype=torch.int32, shape=(b, sq))
    req(seg_k, "seg_k", device=dev, dtype=torch.int32, shape=(b, skv))
    return seg_q, seg_k


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_attention_fwd(q, k, v, *, causal=True, window=0, softcap=0.0,
                        segment_ids=None, bidirectional=False,
                        with_lse=False):
    """One launch of the forward kernel -> out [B,Sq,H,D] (+ lse
    [B,H,Sq] float32 with ``with_lse``; -inf for a row with no valid key,
    whose output is 0). Allocates only ``out`` and ``lse``."""
    seg_q, seg_k = _check(q, k, v, segment_ids, "flash_attention")
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b and sq:
        lib = _build.load("flash_attention", _ARGTYPES)
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _ptr(seg_q), _ptr(seg_k), _ptr(lse), b, sq, skv, h, kv, d,
            1.0 / math.sqrt(d), float(softcap or 0.0), int(window or 0),
            int(causal and not bidirectional), _build.DTYPE_CODES[q.dtype],
            _build.stream_ptr(q))
        _build.check(lib, "flash_attention", err)
        LAUNCHES[0] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0,
                        softcap=0.0, segment_ids=None, bidirectional=False):
    """(dq, dk, dv) of the attention from its output and row
    log-sum-exp: one call of the backward kernel (with ids its tile
    spans, then its dq grid, then its dk/dv grid) on a CUDA tensor,
    ``flash_attention_bwd_ref`` on a CPU tensor. Deterministic: repeated
    calls are bit-identical."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              segment_ids=segment_ids, bidirectional=bidirectional)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    seg_q, seg_k = _check(q, k, v, segment_ids, "flash_attention_bwd")
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    req = _build.require
    req(out, "out", device=q.device, dtype=q.dtype, shape=q.shape)
    req(dout, "dout", device=q.device, dtype=q.dtype, shape=q.shape)
    req(lse, "lse", device=q.device, dtype=torch.float32, shape=(b, h, sq))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not (b and sq and skv):
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    # the ids' [min, max] per tile (tiles of 32 rows or more)
    spans = None if seg_q is None else torch.empty(
        2 * b * ((sq + 31) // 32 + (skv + 31) // 32), dtype=torch.int32,
        device=q.device)
    lib = _build.load("flash_attention_bwd", _BWD_ARGTYPES)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(spans),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(seg_q),
        _ptr(seg_k), b, sq, skv, h, kv, d, 1.0 / math.sqrt(d),
        float(softcap or 0.0),
        int(window or 0), int(causal and not bidirectional),
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    _build.check(lib, "flash_attention_bwd", err)
    BWD_LAUNCHES[0] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a hand-written backward: ``forward(q, k, v, seg_q,
    seg_k, opts, fwd, bwd)`` runs ``fwd(q, k, v, **kw, with_lse=True)``
    -> (out, lse), saves q, k, v, out, lse and the ids, and its backward
    runs ``bwd(q, k, v, out, lse, dout, **kw)`` -> (dq, dk, dv). The CUDA
    path passes the two kernels; a CPU test passes the plain versions
    (``_plain_fwd``, ``flash_attention_bwd_ref``). The ids get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, opts, fwd, bwd):
        segs = None if seg_q is None else (seg_q, seg_k)
        out, lse = fwd(q, k, v, segment_ids=segs, with_lse=True, **opts)
        ctx.save_for_backward(q, k, v, out, lse, seg_q, seg_k)
        ctx.opts, ctx.bwd = opts, bwd
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seg_q, seg_k = ctx.saved_tensors
        segs = None if seg_q is None else (seg_q, seg_k)
        dq, dk, dv = ctx.bwd(q, k, v, out, lse, dout.contiguous(),
                             segment_ids=segs, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def _plain_fwd(q, k, v, *, with_lse, **kw):
    """``attention_lse`` in ``flash_attention_fwd``'s signature."""
    out, lse = attention_lse(q, k, v, **kw)
    return (out, lse) if with_lse else out


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    segment_ids=None, bidirectional=False):
    """q [B,Sq,H,D]; k,v [B,Skv,KV,D] -> [B,Sq,H,D]; ``segment_ids`` =
    (seg_q [B,Sq], seg_k [B,Skv]) int32 or None. A row with no valid key
    returns 0 (and has zero gradient)."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              bidirectional=bidirectional)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, segment_ids=segment_ids, **kw)
    if _build.needs_grad(q, k, v):
        seg_q, seg_k = segment_ids if segment_ids is not None else (None,
                                                                     None)
        return FlashAttentionFn.apply(q, k, v, seg_q, seg_k, kw,
                                      flash_attention_fwd,
                                      flash_attention_bwd)
    return flash_attention_fwd(q, k, v, segment_ids=segment_ids, **kw)
