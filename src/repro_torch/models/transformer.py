"""Decoder and encoder stacks for the paged-serving and training paths
(dense attention and Mamba2 mixers, dense or MoE FFNs, decoder
cross-attention over an encoder's output): port of
``repro/models/transformer.py`` (``stack_forward`` with cache
collection, packed segment ids, the MoE aux loss and rematerialisation
per period, ``init_decode_caches``, ``stack_decode``).

Parameters keep the reference's stacked layout: ``params`` is a list
over the intra-period index j of dicts whose leaves carry a leading
[n_periods] axis. Layers run as a Python loop over (period, j).

Decode caches are indexed as the reference indexes them: the paged KV
pools [n_periods, len(attn_js), NB, P, KV, hd] (absent without an
attention layer), and per-slot SSM state, conv [n_periods,
len(ssm_js), n_slots, K-1, di+2N] in the compute dtype and ssm
[n_periods, len(ssm_js), n_slots, nh, hd, N] in float32, and an
encoder-decoder's per-slot cross-attention K/V, cross_k / cross_v
[n_periods, period, n_slots, src_len, KV, hd], written once at prefill.
``a_of`` and ``s_of`` map j to its index among the attention / mamba
layers.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models import attention, common, mlp, moe, ssm
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
    """The layer's FFN residual branch, when it has one: the experts
    (with arctic's dense residual beside them) on an MoE layer, else the
    dense MLP. Returns (x, aux): the MoE aux loss, or None (decode drops
    it, as the reference's does)."""
    if "ffn" not in lp:
        return x, None
    h = common.rms_norm(x, lp["ln2"], cfg.norm_eps)
    ffn = lp["ffn"]
    aux = None
    if "moe" in ffn:
        y, aux = moe.apply_moe(ffn["moe"], h, cfg, rt,
                               dense_params=ffn.get("dense"))
    else:
        y = mlp.apply_mlp(ffn["dense"], h, cfg, rt)
    if cfg.post_norms:
        y = common.rms_norm(y, lp["post2"], cfg.norm_eps)
    return x + y, aux


def _cross(lp, x, kv, cfg, rt: Runtime, src_valid):
    """The decoder layer's cross-attention residual branch."""
    h = common.rms_norm(x, lp["cross_ln"], cfg.norm_eps)
    return x + attention.cross_forward(lp["cross"], h, kv, cfg, rt,
                                       src_valid=src_valid)


def _apply_layer_full(lp, x, cfg, rt: Runtime, j: int, *, positions,
                      segment_ids, bidirectional, enc_out, src_valid,
                      collect):
    """One layer over the full sequence. Returns (x, aux or None,
    collected)."""
    col: Dict[str, Any] = {}
    h = common.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.layer_kind(j) == "attn":
        y, (k, v) = attention.attn_forward(
            lp["mixer"], h, cfg, rt, positions=positions,
            kind=cfg.attn_kind(j), segment_ids=segment_ids,
            bidirectional=bidirectional, return_kv=True)
        if collect:
            col["kv"] = (k, v)
    else:
        y, state = ssm.ssm_forward(lp["mixer"], h, cfg, rt,
                                   return_state=True)
        if collect:
            col["ssm"] = state
    if cfg.post_norms:
        y = common.rms_norm(y, lp["post1"], cfg.norm_eps)
    x = x + y
    if enc_out is not None and "cross" in lp:
        kv = attention.cross_kv(lp["cross"], enc_out, cfg, rt)
        x = _cross(lp, x, kv, cfg, rt, src_valid)
        if collect:
            col["cross_kv"] = kv
    x, aux = _ffn(lp, x, cfg, rt)
    return x, aux, col


def _any_requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_any_requires_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_any_requires_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def stack_forward(params, x, cfg, rt: Runtime, *, positions,
                  segment_ids=None, bidirectional=False, enc_out=None,
                  src_valid=None, collect_caches=False):
    """Full stack. Returns (x, aux, caches or None): ``aux`` the float32
    sum of the MoE layers' aux losses (0 without one); caches is a list
    over j of {"kv": (k, v)} with leaves [n_periods, B, S, KV, hd] or
    {"ssm": (conv_state, ssm_state)} with leaves [n_periods, B, K-1, C]
    and [n_periods, B, nh, hd, N], plus {"cross_kv": (k, v)} with
    leaves [n_periods, B, Ssrc, KV, hd] on a decoder layer given
    ``enc_out``: the reference's collected layout. ``bidirectional``
    runs the encoder's unmasked self-attention; ``src_valid`` [B,Ssrc]
    masks the cross-attention's source frames; ``segment_ids`` [B,S]
    masks attention across packed documents.

    Under autograd each period's body runs rematerialised by
    ``rt.remat`` (``common.remat``), as the reference checkpoints its
    scanned body: where ``x`` or a weight requires grad (an encoder's
    input, the source frames, does not, but its weights do); serving
    (nothing requiring grad) runs it as it is."""
    period = cfg.period
    n_periods = cfg.n_layers // period
    cols: List[List[Dict[str, Any]]] = [[] for _ in range(period)]

    def body(x, aux, p):
        for j in range(period):
            x, aux_j, col = _apply_layer_full(
                layer_params(params, j, p), x, cfg, rt, j,
                positions=positions, segment_ids=segment_ids,
                bidirectional=bidirectional, enc_out=enc_out,
                src_valid=src_valid, collect=collect_caches)
            if aux_j is not None:
                aux = aux + aux_j
            if collect_caches:
                cols[j].append(col)
        return x, aux

    if not collect_caches and torch.is_grad_enabled() and (
            x.requires_grad or _any_requires_grad(params)):
        body = common.remat(body, rt.remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in range(n_periods):
        x, aux = body(x, aux, p)
    if not collect_caches:
        return x, aux, None
    stacked = [{key: tuple(torch.stack([c[key][i] for c in cj])
                           for i in range(2))
                for key in cj[0]}
               for cj in cols]
    return x, aux, stacked


def init_decode_caches(cfg, rt: Runtime, batch: int, n_blocks: int, dtype,
                       *, device: torch.device, src_len: int = 0):
    """Paged KV pools and per-slot SSM states, stacked [n_periods,
    L_kind, ...], and an encoder-decoder's per-slot cross K/V of
    ``src_len`` frames [n_periods, period, batch, src_len, KV, hd]."""
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
    if cfg.n_enc_layers and src_len:
        shape = (n_periods, cfg.period, batch, src_len, cfg.n_kv_heads,
                 cfg.head_dim)
        caches["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        caches["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return caches


def stack_decode(params, x, caches, cfg, rt: Runtime, *, ctx_lens,
                 block_table, src_valid=None):
    """One decode step through the stack. x [B,d]; block_table [B,MAXP]
    shared across layers; the pools and SSM states in ``caches`` update
    in place; a decoder layer with a cross block attends to its slot's
    cross K/V under ``src_valid`` [B,Ssrc]."""
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
            x = x + y
            if "cross" in lp:
                kv = (caches["cross_k"][p, j], caches["cross_v"][p, j])
                x = _cross(lp, x[:, None, :], kv, cfg, rt, src_valid)[:, 0]
            x, _ = _ffn(lp, x, cfg, rt)
    return x, caches
