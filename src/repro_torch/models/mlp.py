"""Gated FFN (SwiGLU / GeGLU): port of ``repro/models/mlp.py``."""
from __future__ import annotations

from repro_torch.models import common
from repro_torch.models.common import Runtime


def apply_mlp(params, x, cfg, rt: Runtime):
    cd = rt.compute_dtype
    g = common.activation(x @ common.cast(params["wg"], cd), cfg.act)
    u = x @ common.cast(params["wu"], cd)
    return (g * u) @ common.cast(params["wd"], cd)
