"""Mamba2 (SSD) mixer block: port of ``repro/models/ssm.py`` —
projections + causal depthwise conv + the SSD scan (the
``mamba_chunk_scan`` kernel) + gated RMSNorm, for prefill
(``ssm_forward``) and one-token decode (``ssm_decode``).

Parameters keep the reference's layout: separate projections wx/wz
[d, di], wB/wC [d, N], wdt [d, nh], conv_w [K, di+2N], conv_b, and
A_log, D, dt_bias [nh] in float32 whatever the parameter dtype;
``init_ssm`` draws them with the reference's shapes and scales.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import Runtime


def init_ssm(gen: torch.Generator, cfg, n_p: int, dtype, device):
    """One mixer's parameters, every leaf with a leading [n_p] axis."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    n = s.d_state
    f32 = torch.float32

    def uniform(shape):
        return torch.rand(shape, generator=gen, dtype=f32, device=device)

    # dt bias init so softplus(dt) spans [dt_min, dt_max] (mamba default)
    dt = torch.exp(uniform((n_p, nh)) * (math.log(0.1) - math.log(0.001))
                   + math.log(0.001))
    conv_w = torch.randn((n_p, s.conv_dim, di + 2 * n), generator=gen,
                         dtype=f32, device=device) / math.sqrt(s.conv_dim)
    return {
        "wx": common.init_dense(gen, (n_p, d, di), d, dtype, device),
        "wz": common.init_dense(gen, (n_p, d, di), d, dtype, device),
        "wB": common.init_dense(gen, (n_p, d, n), d, dtype, device),
        "wC": common.init_dense(gen, (n_p, d, n), d, dtype, device),
        "wdt": common.init_dense(gen, (n_p, d, nh), d, dtype, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((n_p, di + 2 * n), dtype=dtype, device=device),
        "A_log": torch.log(1.0 + uniform((n_p, nh)) * 15.0),
        "D": torch.ones((n_p, nh), dtype=f32, device=device),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "norm": torch.zeros((n_p, di), dtype=dtype, device=device),
        "wo": common.init_dense(gen, (n_p, di, d), di, dtype, device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log(1 + exp(x)) as logaddexp(x, 0), with no
    linear cut-over (``F.softplus`` returns x above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, b):
    """Depthwise causal conv via shifted adds. x [B,S,C]; w [K,C]."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    s = x.shape[1]
    y = sum(pad[:, i:i + s] * w[i][None, None, :] for i in range(k))
    return F.silu(y + b[None, None, :])


def _conv_step(state, x_new, w, b):
    """state [B,K-1,C]; x_new [B,C] -> (y [B,C], new_state)."""
    window = torch.cat([state, x_new[:, None]], dim=1)       # [B,K,C]
    y = torch.einsum("bkc,kc->bc", window, w)
    return F.silu(y + b[None, :]), window[:, 1:]


def _project(params, x, rt: Runtime):
    cd = rt.compute_dtype
    xb = x @ common.cast(params["wx"], cd)
    z = x @ common.cast(params["wz"], cd)
    bv = x @ common.cast(params["wB"], cd)
    cv = x @ common.cast(params["wC"], cd)
    dt = x @ common.cast(params["wdt"], cd)
    return xb, z, bv, cv, dt


def _gate_norm_out(params, y, z, cfg, rt: Runtime):
    """Gated RMSNorm (y * silu(z), z in f32, then the norm) and the out
    projection, in the reference's order."""
    y = common.rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm"],
                        cfg.norm_eps)
    return y @ common.cast(params["wo"], rt.compute_dtype)


def ssm_forward(params, x, cfg, rt: Runtime, *, initial_state=None,
                return_state=False):
    """Prefill path. x [B,S,d] -> [B,S,d] (+ (conv_state, ssm_state))."""
    s = cfg.ssm
    b, sl, d = x.shape
    di = s.d_inner(d)
    nh = s.n_heads(d)
    n = s.d_state
    cd = rt.compute_dtype
    xb, z, bv, cv, dt = _project(params, x, rt)
    conv_in = torch.cat([xb, bv, cv], dim=-1)
    conv_out = _causal_conv(conv_in, params["conv_w"].to(cd),
                            params["conv_b"].to(cd))
    xb, bv, cv = (conv_out[..., :di], conv_out[..., di:di + n],
                  conv_out[..., di + n:])
    dtv = softplus(dt.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    y, final = ops.mamba_chunk_scan(
        xb.reshape(b, sl, nh, s.head_dim).contiguous(), dtv.contiguous(),
        A, bv.contiguous(), cv.contiguous(), params["D"], chunk=s.chunk,
        initial_state=initial_state, impl=rt.kernel_impl)
    out = _gate_norm_out(params, y.reshape(b, sl, di), z, cfg, rt)
    if return_state:
        # the last K-1 rows of the zero-padded conv input (S < K-1 too)
        k = s.conv_dim - 1
        conv_state = F.pad(conv_in, (0, 0, k, 0))[:, -k:]
        return out, (conv_state.to(cd), final)
    return out


def ssm_decode(params, x, state, cfg, rt: Runtime):
    """One-token decode. x [B,d]; state = (conv_state, ssm_state) ->
    (y [B,d], (conv_state', ssm_state'))."""
    s = cfg.ssm
    b, d = x.shape
    di = s.d_inner(d)
    nh = s.n_heads(d)
    n = s.d_state
    cd = rt.compute_dtype
    conv_state, ssm_state = state
    xb, z, bv, cv, dt = _project(params, x[:, None, :], rt)
    conv_in = torch.cat([xb[:, 0], bv[:, 0], cv[:, 0]], dim=-1)
    conv_out, conv_state = _conv_step(conv_state, conv_in,
                                      params["conv_w"].to(cd),
                                      params["conv_b"].to(cd))
    xb1, bv1, cv1 = (conv_out[:, :di], conv_out[:, di:di + n],
                     conv_out[:, di + n:])
    dtv = softplus(dt[:, 0].float() + params["dt_bias"][None, :])
    A = -torch.exp(params["A_log"])
    y, ssm_state = ops.mamba_decode_step(
        ssm_state, xb1.reshape(b, nh, s.head_dim), dtv, A, bv1, cv1,
        params["D"])
    out = _gate_norm_out(params, y.reshape(b, di), z[:, 0], cfg, rt)
    return out, (conv_state, ssm_state)
