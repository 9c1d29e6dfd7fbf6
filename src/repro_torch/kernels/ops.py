"""Dispatch for the compute hot spots, mirroring ``repro/kernels/ops.py``.

``impl`` selects the lowering, as ``Runtime.kernel_impl`` does in the
reference:
  None  — the kernel wrapper: the hand-written CUDA kernel for a CUDA
          tensor, the plain torch version for a CPU tensor. The choice
          follows the device of the tensors; a CUDA tensor never falls
          back to the plain version.
  "ref" — the plain torch version on any device (the card's greedy
          parity check runs the engine both ways).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fmmu_commit as fc
from repro_torch.kernels import fmmu_lookup as fl
from repro_torch.kernels import fmmu_translate as ft
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

IMPLS = (None, "ref")


def _use_ref(impl: Optional[str]) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"kernel impl {impl!r}: expected one of {IMPLS}")
    return impl == "ref"


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    segment_ids=None, bidirectional=False, impl=None):
    if segment_ids is not None:
        raise NotImplementedError("segment_ids is not ported")
    if _use_ref(impl):
        return ref.attention_naive(q, k, v, causal=causal, window=window,
                                   softcap=softcap,
                                   bidirectional=bidirectional)
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, bidirectional=bidirectional)


def paged_attention(q, k_pool, v_pool, block_table, ctx_lens, *,
                    softcap=0.0, window=0, return_stats=False, impl=None):
    if _use_ref(impl):
        return ref.paged_attention_naive(
            q, k_pool, v_pool, block_table, ctx_lens, softcap=softcap,
            window=window, return_stats=return_stats)
    return pa.paged_attention(q, k_pool, v_pool, block_table, ctx_lens,
                              softcap=softcap, window=window,
                              return_stats=return_stats)


def mamba_chunk_scan(x, dt, A, B, C, D, *, chunk=256, initial_state=None,
                     impl=None):
    """Mamba2 SSD scan -> (y, final_state)."""
    if _use_ref(impl):
        return ref.mamba_chunk_scan_naive(x, dt, A, B, C, D, chunk=chunk,
                                          initial_state=initial_state)
    return ms.mamba_chunk_scan(x, dt, A, B, C, D, chunk=chunk,
                               initial_state=initial_state)


def fmmu_lookup(tags, valid, data, dlpns, *, entries_per_block, impl=None):
    """Probe-only CMT lookup (the unfused map path's probe) ->
    (hit, dppn, set_idx, way)."""
    if _use_ref(impl):
        return ref.fmmu_lookup_ref(tags, valid, data, dlpns,
                                   entries_per_block=entries_per_block)
    return fl.fmmu_lookup(tags, valid, data, dlpns,
                          entries_per_block=entries_per_block)


def fmmu_translate(tags, valid, refbits, data, backing, dlpns, touch, *,
                   entries_per_block, impl=None):
    """Fused translate probe (probe + backing fallback + ref touch) —
    the probe of the map commit's plain version (core/fmmu/batch
    .commit_chain). Returns (hit, out_dppn, set_idx, way, refbits')."""
    if _use_ref(impl):
        return ref.fmmu_translate_ref(tags, valid, refbits, data, backing,
                                      dlpns, touch,
                                      entries_per_block=entries_per_block)
    return ft.fmmu_translate(tags, valid, refbits, data, backing, dlpns,
                             touch, entries_per_block=entries_per_block)


def fmmu_commit(g, ms, dlpns, *, opcodes=None, dppns=None, old_dppns=None,
                grow=None, impl=None):
    """The whole map commit in place (alloc for ``grow``, probe,
    write-through, insert pass, table commit) — the single kernel launch
    behind core/fmmu/batch's map commits. Returns (out, ok, blocks)."""
    if _use_ref(impl):
        return fc.fmmu_commit_ref(g, ms, dlpns, opcodes=opcodes, dppns=dppns,
                                  old_dppns=old_dppns, grow=grow)
    return fc.fmmu_commit(g, ms, dlpns, opcodes=opcodes, dppns=dppns,
                          old_dppns=old_dppns, grow=grow)


mamba_decode_step = ref.mamba_decode_step
