"""Decoder stack for the paged-serving path (dense attention and Mamba2
layers): port of ``repro/models/transformer.py`` (``stack_forward``
with cache collection, ``init_decode_caches``, ``stack_decode``).

Parameters keep the reference's stacked layout: ``params`` is a list
over the intra-period index j of dicts whose leaves carry a leading
[n_periods] axis. Layers run as a Python loop over (period, j).

Decode caches are indexed as the reference indexes them: the paged KV
pools [n_periods, len(attn_js), NB, P, KV, hd] (absent without an
attention layer), and per-slot SSM state, conv [n_periods,
len(ssm_js), n_slots, K-1, di+2N] in the compute dtype and ssm
[n_periods, len(ssm_js), n_slots, nh, hd, N] in float32. ``a_of`` and
``s_of`` map j to its index among the attention / mamba layers.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models import attention, common, mlp, ssm
from repro_torch.models.common import Runtime


def layer_params(params: List[Dict[str, Any]], j: int, p: int):
    """The parameters of layer (period p, intra-period index j): views
    into the stacked leaves."""
    def pick(t):
        if isinstance(t, dict):
            return {k: pick(v) for k, v in t.items()}
        return t[p]
    return pick(params[j])


def kind_index(cfg):
    """({j: index among attention layers}, {j: index among mamba
    layers}) over one period."""
    attn_js = [j for j in range(cfg.period) if cfg.layer_kind(j) == "attn"]
    ssm_js = [j for j in range(cfg.period) if cfg.layer_kind(j) == "mamba"]
    return ({j: i for i, j in enumerate(attn_js)},
            {j: i for i, j in enumerate(ssm_js)})


def _ffn(lp, x, cfg, rt: Runtime):
    """The layer's FFN residual branch, when it has one."""
    if "ffn" not in lp:
        return x
    h = common.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y = mlp.apply_mlp(lp["ffn"]["dense"], h, cfg, rt)
    if cfg.post_norms:
        y = common.rms_norm(y, lp["post2"], cfg.norm_eps)
    return x + y


def _apply_layer_full(lp, x, cfg, rt: Runtime, j: int, *, positions,
                      collect):
    """One layer over the full sequence. Returns (x, collected)."""
    col: Dict[str, Any] = {}
    h = common.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.layer_kind(j) == "attn":
        y, (k, v) = attention.attn_forward(
            lp["mixer"], h, cfg, rt, positions=positions,
            kind=cfg.attn_kind(j), return_kv=True)
        if collect:
            col["kv"] = (k, v)
    else:
        y, state = ssm.ssm_forward(lp["mixer"], h, cfg, rt,
                                   return_state=True)
        if collect:
            col["ssm"] = state
    if cfg.post_norms:
        y = common.rms_norm(y, lp["post1"], cfg.norm_eps)
    return _ffn(lp, x + y, cfg, rt), col


def stack_forward(params, x, cfg, rt: Runtime, *, positions,
                  collect_caches=False):
    """Full stack. Returns (x, caches or None); caches is a list over j
    of {"kv": (k, v)} with leaves [n_periods, B, S, KV, hd] or
    {"ssm": (conv_state, ssm_state)} with leaves [n_periods, B, K-1, C]
    and [n_periods, B, nh, hd, N], the reference's collected layout."""
    period = cfg.period
    n_periods = cfg.n_layers // period
    cols: List[List[Dict[str, Any]]] = [[] for _ in range(period)]
    for p in range(n_periods):
        for j in range(period):
            x, col = _apply_layer_full(layer_params(params, j, p), x, cfg,
                                       rt, j, positions=positions,
                                       collect=collect_caches)
            cols[j].append(col)
    if not collect_caches:
        return x, None
    stacked = [{key: tuple(torch.stack([c[key][i] for c in cj])
                           for i in range(2))
                for key in cj[0]}
               for cj in cols]
    return x, stacked


def init_decode_caches(cfg, rt: Runtime, batch: int, n_blocks: int, dtype,
                       *, device: torch.device):
    """Paged KV pools and per-slot SSM states, stacked [n_periods,
    L_kind, ...]."""
    a_of, s_of = kind_index(cfg)
    n_periods = cfg.n_layers // cfg.period
    caches: Dict[str, torch.Tensor] = {}
    if a_of:
        shape = (n_periods, len(a_of), n_blocks, rt.page_size,
                 cfg.n_kv_heads, cfg.head_dim)
        caches["pool_k"] = torch.zeros(shape, dtype=dtype, device=device)
        caches["pool_v"] = torch.zeros(shape, dtype=dtype, device=device)
    if s_of:
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        nh = s.n_heads(cfg.d_model)
        caches["conv"] = torch.zeros(
            (n_periods, len(s_of), batch, s.conv_dim - 1,
             di + 2 * s.d_state), dtype=dtype, device=device)
        caches["ssm"] = torch.zeros(
            (n_periods, len(s_of), batch, nh, s.head_dim, s.d_state),
            dtype=torch.float32, device=device)
    return caches


def stack_decode(params, x, caches, cfg, rt: Runtime, *, ctx_lens,
                 block_table):
    """One decode step through the stack. x [B,d]; block_table [B,MAXP]
    shared across layers; the pools and SSM states in ``caches`` update
    in place."""
    a_of, s_of = kind_index(cfg)
    for p in range(cfg.n_layers // cfg.period):
        for j in range(cfg.period):
            lp = layer_params(params, j, p)
            h = common.rms_norm(x, lp["ln1"], cfg.norm_eps)
            if cfg.layer_kind(j) == "attn":
                ai = a_of[j]
                y, _, _ = attention.attn_decode_paged(
                    lp["mixer"], h, cfg, rt,
                    pool_k=caches["pool_k"][p, ai],
                    pool_v=caches["pool_v"][p, ai],
                    block_table=block_table, ctx_lens=ctx_lens,
                    kind=cfg.attn_kind(j))
            else:
                si = s_of[j]
                y, (cs, ss) = ssm.ssm_decode(
                    lp["mixer"], h,
                    (caches["conv"][p, si], caches["ssm"][p, si]), cfg, rt)
                caches["conv"][p, si] = cs
                caches["ssm"][p, si] = ss
            if cfg.post_norms:
                y = common.rms_norm(y, lp["post1"], cfg.norm_eps)
            x = _ffn(lp, x + y, cfg, rt)
    return x, caches
