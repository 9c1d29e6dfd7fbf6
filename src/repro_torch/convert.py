"""Load the reference's parameters into the port.

``params_from_jax`` takes the pytree of ``repro.models.Model.init``
already converted to numpy (``jax.tree.map(np.asarray, params)``) and
returns the port's parameter dict. The layouts and dtypes are kept as
they are: ``wq`` [d,H,hd], ``wo`` [H,hd,d], a Mamba2 mixer's
projections, conv and its float32 ``A_log``/``D``/``dt_bias``, stack
leaves [n_periods, ...] per intra-period index j. This module needs
numpy only; the caller owns the JAX side.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return _tensor(tree, device)


def params_from_jax(params_np: Any, cfg: ArchConfig,
                    device: Union[str, torch.device] = "cuda"):
    """Reference parameter pytree (numpy leaves) -> port parameters."""
    dev = resolve_device(device)
    params = _convert(params_np, dev)
    n_p = cfg.n_layers // cfg.period
    if tuple(params["embed"].shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {tuple(params['embed'].shape)} does not "
                         f"match {cfg.name}")
    if len(params["stack"]) != cfg.period or any(
            lp["ln1"].shape[0] != n_p for lp in params["stack"]):
        raise ValueError(f"stack layout does not match {cfg.name}: "
                         f"expected {cfg.period} x [{n_p}, ...]")
    return params
