"""Shared model building blocks: port of ``repro/models/common.py``.
Functions on tensors; parameters are plain dicts of tensors in the
reference's layouts."""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution-policy knobs, orthogonal to the architecture."""
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    kernel_impl: Optional[str] = None   # ops impl selector (None / "ref")
    page_size: int = 256                # tokens per KV page
    capacity_factor: Optional[float] = None   # MoE capacity; None: config's
    # training only (Model.loss_fn); serving never reads them
    remat: str = "dots"                 # 'none' | 'dots' | 'full'
    zloss: float = 0.0


def init_dense(gen: torch.Generator, shape, d_in: int, dtype, device):
    """N(0, 1/d_in) weights from ``gen``, drawn in float32 then cast
    (the reference's ``init_dense`` scale)."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / d_in ** 0.5)).to(dtype)


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)


def rms_norm(x, w, eps: float):
    """RMSNorm with the weight stored in the (1 + w) offset form."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def rope_angles(positions, head_dim: int, theta: float):
    """positions [...,S] -> (cos, sin) [...,S, head_dim//2] fp32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [B,S,H,D]; cos/sin [B,S,half] or [S,half]."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    xf1 = x[..., :half].float()
    xf2 = x[..., half:].float()
    o1 = xf1 * cos - xf2 * sin
    o2 = xf2 * cos + xf1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def softcap(x, cap: float):
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x


def activation(x, kind: str):
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


# ----------------------------------------------------------------------
REMATS = ("none", "dots", "full")


def _save_weight_products(ctx, op, *args, **kwargs):
    """The 'dots' policy: keep the outputs of the weight products
    (``aten.mm`` / ``aten.addmm``: a [B*S, d] activation times a 2-D
    weight, the reference's dots without batch dimensions) and recompute
    everything else, the attention kernel included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, name: str):
    """``fn`` wrapped for rematerialisation under policy ``name``, the
    counterpart of ``jax.checkpoint(fn, policy=remat_policy(name))``:
    'none' returns ``fn``; 'full' saves only its inputs and recomputes
    the body in the backward pass; 'dots' also keeps the weight
    products' outputs."""
    if name not in REMATS:
        raise ValueError(f"remat {name!r}: expected one of {REMATS}")
    if name == "none":
        return fn
    kw = {}
    if name == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts,
            _save_weight_products)

    def wrapped(*args):
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped
