"""Paged decode attention over FMMU block tables: the CUDA kernel of
``csrc/paged_attention.cu`` and its plain torch version.

Port of ``repro/kernels/paged_attention.py``. The block table (the
FMMU's translation output: logical page -> physical block) names the
pool block each page of context is read from. A CPU tensor takes the
plain version (``paged_attention_ref``); a CUDA tensor launches the
kernel or raises.

The kernel is split-context flash-decoding in one launch: ``plan``
cuts the context into ``n_split`` ranges of ``pages_per_split`` whole
pages from the shapes alone (never from ``ctx_lens``, so no host sync),
each split's block writes a float32 partial into one scratch tensor,
and the last block of each (sequence, KV head, head chunk) combines the
partials in split order (``ref.combine_partial_attention``). Up to
MAX_SPLITS splits the split length does not depend on the table's width
either: a wider table only appends splits with no live page, which the
combine skips (an empty split has l = 0), and a one-split launch folds
its partial as the combine does, so one lane's output is bit-identical
at every such width, as the Pallas kernel's is at any. The tickets live in a per-device int32
buffer that is zeroed once and that every call leaves at zero, so calls
on one device must not overlap (they run in order on PyTorch's current
stream).

Contract: ``0 <= block_table[b, i] < NB`` for every live page
(i * P < ctx_lens[b]) — the serving engine's ``_mask_tables`` clamps NIL
and host-tier ids to its scratch block before the call. A lane with
ctx_lens 0 returns 0 (m = -1e30, l = 0), as the Pallas kernel does.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple

import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_naive

LAUNCHES = COUNTERS.cell("kernel.paged_attention")
paged_attention_ref = paged_attention_naive
HEAD_DIMS = (16, 32, 64, 128)
BLOCKS_PER_SM = 4          # split target: ~4 resident blocks on every SM
MIN_SPLIT_TOKENS = 64      # one K/V tile: a split shorter is all overhead
PLAN_TOKENS = 1024         # the context length the split length is set for
MAX_SPLITS = 256           # past it, splits double in length (see plan)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 10 + [_I] * 9 + [_F, _F, _I, _I, _P]
_COUNTER_BUFS: Dict[torch.device, torch.Tensor] = {}

__all__ = ["paged_attention", "paged_attention_ref", "plan", "LAUNCHES"]


class Plan(NamedTuple):
    heads_per_block: int   # gc: 1, 4 or 8 query heads of one KV head
    head_chunks: int       # ceil(G / gc)
    n_split: int           # context splits per (sequence, head chunk)
    pages_per_split: int


def plan(b: int, h: int, kv: int, maxp: int, page: int, n_sm: int) -> Plan:
    """The launch's shape from host-known sizes only. The split length
    comes from ``(b, h, kv, page, n_sm)``: at a PLAN_TOKENS context,
    enough splits that ``b * kv * head_chunks * n_split`` blocks give
    ~BLOCKS_PER_SM per SM, none shorter than MIN_SPLIT_TOKENS (or one
    page), whole pages each. Up to MAX_SPLITS such splits the table
    width ``maxp`` only sets ``n_split``: a wider table appends splits
    of the same pages, so one lane's bits are the same at every such
    width (2048 pages, 32768 tokens, at 8 slots of the llama serving
    shape; 1024 pages at one slot). A wider table doubles the split
    length until MAX_SPLITS splits cover it: 2048 short splits took
    6.5-6.7x a 64-split plan (one slot, 8192 pages; PERF.md §7). The lengths grow in steps, so every width inside one step has
    the same splits; across a step a lane's bits may change, and the
    serving engines give the macro and single-step paths the same page
    bucket on every step for that."""
    g = h // kv
    gc = 1 if g == 1 else 4 if g <= 4 else 8
    chunks = -(-g // gc)
    cells = max(b * kv * chunks, 1)
    if maxp <= 0:
        return Plan(gc, chunks, 1, 1)
    want = -(-BLOCKS_PER_SM * n_sm // cells)
    pages = max(1, PLAN_TOKENS // page)
    n = max(1, min(want, PLAN_TOKENS // MIN_SPLIT_TOKENS, pages))
    pps = -(-pages // n)
    while -(-maxp // pps) > MAX_SPLITS:
        pps *= 2
    return Plan(gc, chunks, -(-maxp // pps), pps)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _counter_buffer(dev: torch.device, n: int) -> torch.Tensor:
    """The device's ticket counters (int32, zero between calls), grown
    to at least ``n`` cells; every launch leaves them at zero. Growing
    them while a CUDA graph is captured raises: the zero-fill would
    only run at replay, from the graph's private pool, so a capture
    must be preceded by an eager call of the same split plan."""
    buf = _COUNTER_BUFS.get(dev)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_attention: the ticket buffer must be sized by an "
                "eager call before a CUDA graph capture")
        size = max(n, 2 * buf.numel() if buf is not None else 1024)
        buf = torch.zeros(size, dtype=torch.int32, device=dev)
        _COUNTER_BUFS[dev] = buf
    return buf


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
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {d} not in {HEAD_DIMS}")
    if kv == 0 or h % kv:
        raise ValueError(f"paged_attention: H={h} not a multiple of KV={kv}")
    req = _build.require
    req(q, "q", device=dev, dtype=q.dtype, shape=(b, h, d))
    req(k_pool, "k_pool", device=dev, dtype=q.dtype, shape=(nb, p, kv, d))
    req(v_pool, "v_pool", device=dev, dtype=q.dtype, shape=(nb, p, kv, d))
    req(block_table, "block_table", device=dev, dtype=torch.int32,
        shape=(b, maxp))
    req(ctx_lens, "ctx_lens", device=dev, dtype=torch.int32, shape=(b,))
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             "aligned (the kernel moves 16-byte vectors)")
    out = torch.empty_like(q)
    m = l = None
    if return_stats:
        m = torch.empty((b, h), dtype=torch.float32, device=dev)
        l = torch.empty((b, h), dtype=torch.float32, device=dev)
    if b > 0:
        pl = plan(b, h, kv, maxp, p, _sm_count(dev.index))
        cells = b * kv * pl.head_chunks
        part = counters = None
        if pl.n_split > 1:
            part = torch.empty(
                cells * pl.n_split * pl.heads_per_block * (d + 2),
                dtype=torch.float32, device=dev)
            counters = _counter_buffer(dev, cells)
        lib = _build.load("paged_attention", _ARGTYPES)
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
            m.data_ptr() if m is not None else None,
            l.data_ptr() if l is not None else None,
            part.data_ptr() if part is not None else None,
            counters.data_ptr() if counters is not None else None,
            b, h, kv, d, p, maxp, pl.heads_per_block, pl.n_split,
            pl.pages_per_split, 1.0 / math.sqrt(d), float(softcap or 0.0),
            int(window or 0), _build.DTYPE_CODES[q.dtype],
            _build.stream_ptr(q))
        _build.check(lib, "paged_attention", err)
        LAUNCHES[0] += 1
    if return_stats:
        return out, (m, l)
    return out
