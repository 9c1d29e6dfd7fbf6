"""Decoder stack for the dense paged-serving path: port of
``repro/models/transformer.py`` (``stack_forward`` with cache
collection, ``init_decode_caches``, ``stack_decode``).

Parameters keep the reference's stacked layout: ``params`` is a list
over the intra-period index j of dicts whose leaves carry a leading
[n_periods] axis. Layers run as a Python loop over (period, j).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models import attention, common, mlp
from repro_torch.models.common import Runtime


def layer_params(params: List[Dict[str, Any]], j: int, p: int):
    """The parameters of layer (period p, intra-period index j): views
    into the stacked leaves."""
    def pick(t):
        if isinstance(t, dict):
            return {k: pick(v) for k, v in t.items()}
        return t[p]
    return pick(params[j])


def _apply_layer_full(lp, x, cfg, rt: Runtime, j: int, *, positions,
                      collect):
    """One layer over the full sequence. Returns (x, collected)."""
    col: Dict[str, Any] = {}
    h = common.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, (k, v) = attention.attn_forward(
        lp["mixer"], h, cfg, rt, positions=positions,
        kind=cfg.attn_kind(j), return_kv=True)
    if collect:
        col["kv"] = (k, v)
    if cfg.post_norms:
        y = common.rms_norm(y, lp["post1"], cfg.norm_eps)
    x = x + y
    if "ffn" in lp:
        h = common.rms_norm(x, lp["ln2"], cfg.norm_eps)
        y = mlp.apply_mlp(lp["ffn"]["dense"], h, cfg, rt)
        if cfg.post_norms:
            y = common.rms_norm(y, lp["post2"], cfg.norm_eps)
        x = x + y
    return x, col


def stack_forward(params, x, cfg, rt: Runtime, *, positions,
                  collect_caches=False):
    """Full stack. Returns (x, caches or None); caches is a list over j
    of {"kv": (k, v)} with leaves [n_periods, B, S, KV, hd], the
    reference's collected layout."""
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
    stacked = [{"kv": (torch.stack([c["kv"][0] for c in cj]),
                       torch.stack([c["kv"][1] for c in cj]))}
               for cj in cols]
    return x, stacked


def init_decode_caches(cfg, rt: Runtime, n_blocks: int, dtype, *,
                       device: torch.device):
    """Paged KV pools, stacked [n_periods, period, NB, P, KV, hd]."""
    shape = (cfg.n_layers // cfg.period, cfg.period, n_blocks,
             rt.page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"pool_k": torch.zeros(shape, dtype=dtype, device=device),
            "pool_v": torch.zeros(shape, dtype=dtype, device=device)}


def stack_decode(params, x, caches, cfg, rt: Runtime, *, ctx_lens,
                 block_table):
    """One decode step through the stack. x [B,d]; block_table [B,MAXP]
    shared across layers; the pools in ``caches`` update in place."""
    period = cfg.period
    for p in range(cfg.n_layers // period):
        for j in range(period):
            lp = layer_params(params, j, p)
            h = common.rms_norm(x, lp["ln1"], cfg.norm_eps)
            y, _, _ = attention.attn_decode_paged(
                lp["mixer"], h, cfg, rt,
                pool_k=caches["pool_k"][p, j], pool_v=caches["pool_v"][p, j],
                block_table=block_table, ctx_lens=ctx_lens,
                kind=cfg.attn_kind(j))
            if cfg.post_norms:
                y = common.rms_norm(y, lp["post1"], cfg.norm_eps)
            x = x + y
            if "ffn" in lp:
                h = common.rms_norm(x, lp["ln2"], cfg.norm_eps)
                y2 = mlp.apply_mlp(lp["ffn"]["dense"], h[:, None, :], cfg,
                                   rt)[:, 0]
                if cfg.post_norms:
                    y2 = common.rms_norm(y2, lp["post2"], cfg.norm_eps)
                x = x + y2
    return x, caches
