"""Probe-only FMMU CMT lookup: the CUDA kernel of
``csrc/fmmu_lookup.cu`` and its plain torch version.

Port of ``repro/kernels/fmmu_lookup.py``: the probe of the unfused map
path (``core/fmmu/batch.*_unfused``) — hit, dppn (-1 on a miss), set
and first-match way, with no side effects. A CPU tensor takes the plain
version (``fmmu_lookup_ref``); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.counters import COUNTERS
from repro_torch.kernels import _build
from repro_torch.kernels.ref import fmmu_lookup_ref

LAUNCHES = COUNTERS.cell("kernel.fmmu_lookup")

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 4 + [_P]

__all__ = ["fmmu_lookup", "fmmu_lookup_ref", "LAUNCHES"]


def fmmu_lookup(tags, valid, data, dlpns, *, entries_per_block):
    """tags [S,W] int32; valid [S,W] bool; data [S,W,E] int32; dlpns
    [Bq] int32 -> (hit bool, dppn int32, set int32, way int32 [Bq])."""
    if tags.device.type == "cpu":
        return fmmu_lookup_ref(tags, valid, data, dlpns,
                               entries_per_block=entries_per_block)
    dev = tags.device
    s, w = tags.shape
    e = entries_per_block
    bq = dlpns.shape[0]
    req = _build.require
    req(tags, "tags", device=dev, dtype=torch.int32, shape=(s, w))
    req(valid, "valid", device=dev, dtype=torch.bool, shape=(s, w))
    req(data, "data", device=dev, dtype=torch.int32, shape=(s, w, e))
    req(dlpns, "dlpns", device=dev, dtype=torch.int32, shape=(bq,))
    hit = torch.empty(bq, dtype=torch.bool, device=dev)
    dppn = torch.empty(bq, dtype=torch.int32, device=dev)
    set_idx = torch.empty(bq, dtype=torch.int32, device=dev)
    way = torch.empty(bq, dtype=torch.int32, device=dev)
    if bq == 0:
        return hit, dppn, set_idx, way
    lib = _build.load("fmmu_lookup", _ARGTYPES)
    err = lib.fmmu_lookup_launch(
        tags.data_ptr(), valid.data_ptr(), data.data_ptr(),
        dlpns.data_ptr(), hit.data_ptr(), dppn.data_ptr(),
        set_idx.data_ptr(), way.data_ptr(), s, w, e, bq,
        _build.stream_ptr(tags))
    _build.check(lib, "fmmu_lookup", err)
    LAUNCHES[0] += 1
    return hit, dppn, set_idx, way
