"""Load the reference's parameters and states into the port.

``params_from_jax`` takes the pytree of ``repro.models.Model.init``
already converted to numpy (``jax.tree.map(np.asarray, params)``) and
returns the port's parameter dict. The layouts and dtypes are kept as
they are: ``wq`` [d,H,hd], ``wo`` [H,hd,d], a Mamba2 mixer's
projections, conv and its float32 ``A_log``/``D``/``dt_bias``, an MoE
layer's float32 router [d,E] and experts ``wg``/``wu`` [E,d,ff], ``wd``
[E,ff,d], stack leaves [n_periods, ...] per intra-period index j; an
encoder-decoder's ``enc_stack`` / ``enc_norm`` and each decoder layer's
``cross_ln`` / ``cross`` block. This module needs numpy only; the
caller owns the JAX side.

``train_state_from_jax`` takes a reference ``TrainState``'s parameters
and optimizer state (numpy leaves) and returns the port's, so both
trainers can start from one state.

``fsm_state_from_jax`` and ``fsm_state_to_numpy`` carry the sequential
packet engine's state across the packages field by field, so both
engines can start from one mid-trace state.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.fmmu.state import FMMUState
from repro_torch.device import resolve_device
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import TrainState, trainable


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
    for j, lp in enumerate(params["stack"]):
        if cfg.is_moe_layer(j):
            _check_moe(lp.get("ffn", {}).get("moe"), cfg, n_p, j)
        _check_cross(lp, cfg, n_p, j)
    _check_encoder(params, cfg)
    return params


def train_state_from_jax(params_np: Any, opt_np: Any, cfg: ArchConfig,
                         device: Union[str, torch.device] = "cuda"):
    """A reference train state -> the port's ``TrainState``:
    ``params_np`` the parameter pytree and ``opt_np`` the ``OptState``
    (or its ``_asdict()``), numpy leaves. The parameters require grad;
    the moments keep their float32 and the step its int32."""
    dev = resolve_device(device)
    o = opt_np._asdict() if hasattr(opt_np, "_asdict") else dict(opt_np)
    params = trainable(params_from_jax(params_np, cfg, dev))
    state = opt.OptState(
        step=torch.tensor(int(np.asarray(o["step"])), dtype=torch.int32,
                          device=dev),
        mu=_convert(o["mu"], dev), nu=_convert(o["nu"], dev))
    return TrainState(params, state)


def _attn_shapes(cfg: ArchConfig, n_p: int):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": (n_p, d, h, hd), "wk": (n_p, d, kv, hd),
            "wv": (n_p, d, kv, hd), "wo": (n_p, h, hd, d)}


def _check_cross(lp, cfg: ArchConfig, n_p: int, j: int):
    """A decoder layer holds a bias-free cross block and its norm iff
    the model has an encoder, at the reference's shapes."""
    if not cfg.n_enc_layers:
        if "cross" in lp or "cross_ln" in lp:
            raise ValueError(f"{cfg.name} layer {j}: cross-attention "
                             "leaves on a model without an encoder")
        return
    got = {k: tuple(v.shape) for k, v in lp.get("cross", {}).items()}
    want = _attn_shapes(cfg, n_p)
    ln = tuple(lp["cross_ln"].shape) if "cross_ln" in lp else None
    if got != want or ln != (n_p, cfg.d_model):
        raise ValueError(f"{cfg.name} layer {j}: cross leaves {got}, "
                         f"cross_ln {ln}, expected {want}, "
                         f"{(n_p, cfg.d_model)}")


def _check_encoder(params, cfg: ArchConfig):
    """``enc_stack`` (one period of n_enc_layers, attention and a dense
    MLP a layer) and ``enc_norm`` iff the model has an encoder."""
    if not cfg.n_enc_layers:
        if "enc_stack" in params or "enc_norm" in params:
            raise ValueError(f"{cfg.name}: encoder leaves on a model "
                             "without an encoder")
        return
    n_e, d = cfg.n_enc_layers, cfg.d_model
    enc = params.get("enc_stack")
    if enc is None or len(enc) != 1 or \
            tuple(params.get("enc_norm", torch.empty(0)).shape) != (d,):
        raise ValueError(f"{cfg.name}: expected enc_stack of one period "
                         "and enc_norm [d]")
    got = {k: tuple(v.shape) for k, v in enc[0]["mixer"].items()
           if k.startswith("w")}
    if got != _attn_shapes(cfg, n_e) or tuple(enc[0]["ln1"].shape) != \
            (n_e, d):
        raise ValueError(f"{cfg.name}: encoder attention leaves {got}, "
                         f"expected {_attn_shapes(cfg, n_e)}")


def _check_moe(leaves, cfg: ArchConfig, n_p: int, j: int):
    """An MoE layer's leaves have the reference's shapes, the router
    its float32."""
    m = cfg.moe
    d, e, ff = cfg.d_model, m.n_experts, m.d_ff
    want = {"router": (n_p, d, e), "wg": (n_p, e, d, ff),
            "wu": (n_p, e, d, ff), "wd": (n_p, e, ff, d)}
    got = {k: tuple(v.shape) for k, v in (leaves or {}).items()}
    if got != want:
        raise ValueError(f"{cfg.name} layer {j}: MoE leaves {got}, "
                         f"expected {want}")
    if leaves["router"].dtype != torch.float32:
        raise ValueError(f"{cfg.name} layer {j}: the router is "
                         f"{leaves['router'].dtype}, expected float32")


def fsm_state_from_jax(st, device: Union[str, torch.device] = "cuda"
                       ) -> FMMUState:
    """A reference ``FMMUState`` (its 43 leaves as JAX or numpy arrays,
    in the reference's field order) -> the port's, int32 on ``device``."""
    fields = getattr(st, "_fields", FMMUState._fields)
    if tuple(fields) != FMMUState._fields:
        raise ValueError(f"FMMUState fields differ: {fields}")
    dev = resolve_device(device)
    return FMMUState(*(torch.from_numpy(
        np.array(a, dtype=np.int32, copy=True)).to(dev) for a in st))


def fsm_state_to_numpy(st: FMMUState):
    """The port's state -> a tuple of int32 numpy arrays in the
    reference's field order (``repro...state.FMMUState(*map(jnp.asarray,
    ...))`` rebuilds the reference's state)."""
    return tuple(t.detach().cpu().numpy().astype(np.int32, copy=True)
                 for t in st)
