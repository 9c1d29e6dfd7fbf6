"""GQA attention for the prefill, paged-decode and cross-attention
paths: port of ``repro/models/attention.py`` (``init_attention``,
``_project_qkv``, ``attn_forward``, ``cross_forward``, ``cross_kv``,
``write_kv_page``, ``attn_decode_paged``).

Projections keep the reference's 3D layouts: wq/wk/wv [d, heads, hd],
wo [H, hd, d]. The paged pools are updated in place (the reference
returns new pools; here the returned pools are the same tensors), which
saves a copy of the pool per decode step. Cross-attention runs through
the flash kernel with segment ids: every query in segment 1, source
frame j in segment ``src_valid[j]`` (1 valid, 0 padding).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.common import Runtime, apply_rope, rope_angles


def init_attention(g: torch.Generator, cfg, n_p: int, dtype, device, *,
                   cross: bool = False):
    """One attention block's weights, [n_p, ...] leaves, from ``g``:
    N(0, 1/fan_in) projections, zero QKV biases when the config has them
    (never on a cross block)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dense = common.init_dense
    params = {
        "wq": dense(g, (n_p, d, h * hd), d, dtype, device).reshape(
            n_p, d, h, hd),
        "wk": dense(g, (n_p, d, kv * hd), d, dtype, device).reshape(
            n_p, d, kv, hd),
        "wv": dense(g, (n_p, d, kv * hd), d, dtype, device).reshape(
            n_p, d, kv, hd),
        "wo": dense(g, (n_p, h * hd, d), h * hd, dtype, device).reshape(
            n_p, h, hd, d),
    }
    if cfg.qkv_bias and not cross:
        params.update(
            bq=torch.zeros((n_p, h, hd), dtype=dtype, device=device),
            bk=torch.zeros((n_p, kv, hd), dtype=dtype, device=device),
            bv=torch.zeros((n_p, kv, hd), dtype=dtype, device=device))
    return params


def _proj(x, w, cd):
    """x [B,S,d] @ w [d,N,hd] -> [B,S,N,hd]."""
    b, s, d = x.shape
    w = common.cast(w, cd)
    return (x @ w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def _project_qkv(params, x, cfg, rt: Runtime, positions, *,
                 rope: bool = True):
    """x [B,S,d] -> q [B,S,H,hd], k,v [B,S,KV,hd] (compute dtype)."""
    cd = rt.compute_dtype
    xq = _proj(x, params["wq"], cd)
    xk = _proj(x, params["wk"], cd)
    xv = _proj(x, params["wv"], cd)
    if "bq" in params:
        xq = xq + common.cast(params["bq"], cd)
        xk = xk + common.cast(params["bk"], cd)
        xv = xv + common.cast(params["bv"], cd)
    if rope and cfg.use_rope:
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        xq = apply_rope(xq, cos, sin)
        xk = apply_rope(xk, cos, sin)
    return xq, xk, xv


def _out_proj(out, wo, cd):
    """out [..., H, hd] @ wo [H, hd, d] -> [..., d]."""
    h, hd, d = wo.shape
    return out.reshape(*out.shape[:-2], h * hd) @ \
        common.cast(wo, cd).reshape(h * hd, d)


def attn_forward(params, x, cfg, rt: Runtime, *, positions, kind="global",
                 segment_ids=None, bidirectional=False, return_kv=False):
    """Prefill (and encoder) self-attention. x [B,S,d] -> [B,S,d] (+
    (k, v)); ``segment_ids`` [B,S] masks attention across packed
    segments."""
    q, k, v = _project_qkv(params, x, cfg, rt, positions)
    window = cfg.sliding_window if kind == "local" else 0
    segs = (segment_ids, segment_ids) if segment_ids is not None else None
    out = ops.flash_attention(
        q, k, v, causal=not bidirectional, window=window,
        softcap=cfg.attn_softcap, segment_ids=segs,
        bidirectional=bidirectional, impl=rt.kernel_impl)
    y = _out_proj(out, params["wo"], rt.compute_dtype)
    if return_kv:
        return y, (k, v)
    return y


def cross_forward(params, x, kv_cache, cfg, rt: Runtime, *, src_valid=None):
    """Decoder cross-attention. x [B,S,d]; kv_cache = (k, v)
    [B,Ssrc,KV,hd]; ``src_valid`` [B,Ssrc] int32 (1 valid, 0 padding)
    masks the source frames as segment ids (queries all in segment 1).
    A lane with no valid frame gets 0 from the attention (the reference:
    the mean of v); only a dead serving lane has one."""
    q = _proj(x, params["wq"], rt.compute_dtype)
    k, v = kv_cache
    segs = None
    if src_valid is not None:
        seg_q = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
        segs = (seg_q, src_valid.to(torch.int32))
    out = ops.flash_attention(q, k, v, causal=False, bidirectional=True,
                              segment_ids=segs, impl=rt.kernel_impl)
    return _out_proj(out, params["wo"], rt.compute_dtype)


def cross_kv(params, enc_out, cfg, rt: Runtime):
    """Cross-attention K/V [B,Ssrc,KV,hd] from the encoder output,
    computed once per request at prefill."""
    cd = rt.compute_dtype
    return _proj(enc_out, params["wk"], cd), _proj(enc_out, params["wv"], cd)


def write_kv_page(pool_k, pool_v, k_new, v_new, block_table, ctx_lens,
                  page_size: int):
    """Write one new token's K/V into the paged pools, in place.
    k_new/v_new [B,KV,hd]; the logical page index is clamped into the
    table like a jnp gather. Returns the (same) pools."""
    b = k_new.shape[0]
    logical = torch.div(ctx_lens, page_size, rounding_mode="floor").clamp(
        0, block_table.shape[1] - 1)
    offs = torch.remainder(ctx_lens, page_size)
    pages = block_table[torch.arange(b, device=block_table.device),
                        logical.long()]
    pool_k[pages.long(), offs.long()] = k_new.to(pool_k.dtype)
    pool_v[pages.long(), offs.long()] = v_new.to(pool_v.dtype)
    return pool_k, pool_v


def attn_decode_paged(params, x, cfg, rt: Runtime, *, pool_k, pool_v,
                      block_table, ctx_lens, kind="global"):
    """One-token decode. x [B,d]; pools [NB,P,KV,hd]; returns
    (y [B,d], pool_k, pool_v) with the pools updated in place."""
    positions = ctx_lens[:, None]                      # [B,1]
    q, k, v = _project_qkv(params, x[:, None, :], cfg, rt, positions)
    write_kv_page(pool_k, pool_v, k[:, 0], v[:, 0], block_table, ctx_lens,
                  rt.page_size)
    window = cfg.sliding_window if kind == "local" else 0
    out = ops.paged_attention(
        q[:, 0], pool_k, pool_v, block_table, ctx_lens + 1,
        softcap=cfg.attn_softcap, window=window, impl=rt.kernel_impl)
    return _out_proj(out, params["wo"], rt.compute_dtype), pool_k, pool_v
