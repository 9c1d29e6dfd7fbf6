"""Fused FMMU translate probe: the CUDA kernel of
``csrc/fmmu_translate.cu`` and its plain torch version.

Port of ``repro/kernels/fmmu_translate.py``. One launch services the
whole probe side of a mixed-op map commit (core/fmmu/batch): CMT tag
probe, backing-table fallback for misses, ref-bit touch for hits, and
hit-way selection. A CPU tensor takes the plain version
(``fmmu_translate_ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.kernels import _build
from repro_torch.kernels.ref import fmmu_translate_ref

LAUNCHES = COUNTERS.cell("kernel.fmmu_translate")

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 11 + [_I] * 5 + [_P]

__all__ = ["fmmu_translate", "fmmu_translate_ref", "LAUNCHES"]


def fmmu_translate(tags, valid, refbits, data, backing, dlpns, touch, *,
                   entries_per_block):
    """tags [S,W] int32; valid/refbits [S,W] bool; data [S,W,E] int32;
    backing [NP] int32; dlpns [Bq] int32; touch [Bq] bool ->
    (hit bool, out_dppn int32, set int32, way int32 [Bq];
     refbits' [S,W] bool)."""
    if tags.device.type == "cpu":
        return fmmu_translate_ref(tags, valid, refbits, data, backing,
                                  dlpns, touch,
                                  entries_per_block=entries_per_block)
    dev = tags.device
    s, w = tags.shape
    e = entries_per_block
    bq = dlpns.shape[0]
    req = _build.require
    req(tags, "tags", device=dev, dtype=torch.int32, shape=(s, w))
    req(valid, "valid", device=dev, dtype=torch.bool, shape=(s, w))
    req(refbits, "refbits", device=dev, dtype=torch.bool, shape=(s, w))
    req(data, "data", device=dev, dtype=torch.int32, shape=(s, w, e))
    if backing.dim() != 1 or backing.shape[0] < 1:
        raise ValueError(f"backing: expected [NP>=1], got "
                         f"{tuple(backing.shape)}")
    req(backing, "backing", device=dev, dtype=torch.int32,
        shape=backing.shape)
    req(dlpns, "dlpns", device=dev, dtype=torch.int32, shape=(bq,))
    req(touch, "touch", device=dev, dtype=torch.bool, shape=(bq,))
    hit = torch.empty(bq, dtype=torch.bool, device=dev)
    out = torch.empty(bq, dtype=torch.int32, device=dev)
    set_idx = torch.empty(bq, dtype=torch.int32, device=dev)
    way = torch.empty(bq, dtype=torch.int32, device=dev)
    new_ref = refbits.clone()
    if bq == 0:
        return hit, out, set_idx, way, new_ref
    lib = _build.load("fmmu_translate", _ARGTYPES)
    err = lib.fmmu_translate_launch(
        tags.data_ptr(), valid.data_ptr(), data.data_ptr(),
        backing.data_ptr(), dlpns.data_ptr(), touch.data_ptr(),
        hit.data_ptr(), out.data_ptr(), set_idx.data_ptr(), way.data_ptr(),
        new_ref.data_ptr(), s, w, e, backing.shape[0], bq,
        _build.stream_ptr(tags))
    _build.check(lib, "fmmu_translate", err)
    LAUNCHES[0] += 1
    return hit, out, set_idx, way, new_ref
