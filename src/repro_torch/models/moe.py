"""Mixture-of-Experts FFN on one device: port of ``repro/models/moe.py``
(``init_moe``, ``_capacity``, ``_moe_local``, ``apply_moe``,
``apply_moe_dense_ref``).

The reference routes under a ``shard_map`` over the tensor axis; on one
device its ``psum`` and ``pmean`` are the identity and every expert is
local, so ``apply_moe`` is the body of ``_moe_local`` over all tokens.
Dispatch is sort-based with a static capacity C per expert: each
token's top-k slots are ordered by expert, ties by slot index (the
order of the reference's packed-key sort, which decides the slots
dropped past C), gathered into an [E, C, d] buffer, run through the
expert products, and gathered back.

No step reads a value on the host and no shape depends on the routing,
so a decode step captures into a CUDA graph: the per-expert counts are
an ``index_add_`` (``bincount`` syncs), overflowing slots go to a spare
buffer row (not a dropping scatter), the gather-back is clamped and
masked, and a token's k weighted contributions are summed in slot order
rather than with float atomics, so repeats are bit-identical.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models import common, mlp
from repro_torch.models.common import Runtime


def init_moe(gen: torch.Generator, cfg, n_p: int, dtype, device):
    """The MoE leaves of one intra-period index, each [n_p, ...]: the
    router [n_p,d,E] in float32 whatever ``dtype`` (the reference's fp32
    router), wg/wu [n_p,E,d,ff] and wd [n_p,E,ff,d], N(0, 1/fan_in).
    Expert weights are drawn one matrix at a time, so the float32 draw
    never holds more than one (an arctic layer has 13.4 G expert
    parameters)."""
    m = cfg.moe
    d, ff, e = cfg.d_model, m.d_ff, m.n_experts

    def experts(shape, fan_in):
        out = torch.empty((n_p, e) + shape, dtype=dtype, device=device)
        for p in range(n_p):
            for i in range(e):
                out[p, i] = common.init_dense(gen, shape, fan_in, dtype,
                                              device)
        return out
    return {
        "router": common.init_dense(gen, (n_p, d, e), d, torch.float32,
                                    device),
        "wg": experts((d, ff), d),
        "wu": experts((d, ff), d),
        "wd": experts((ff, d), ff),
    }


def _capacity(tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(math.ceil(tokens * top_k / n_experts * factor))
    return max(4, min(c, tokens * top_k))


class Dispatch(NamedTuple):
    """The routing of T tokens and its static-capacity plan, over the
    T*k slots (slot s = token s // k, its (s % k)-th choice) in sorted
    order (by expert, ties by slot)."""
    gates: torch.Tensor   # [T,E] float32 router probabilities
    topi: torch.Tensor    # [T,k] chosen experts, descending gate order
    order: torch.Tensor   # [T*k] the slot at each sorted position
    keep: torch.Tensor    # [T*k] the position fits its expert's capacity
    dst: torch.Tensor     # [T*k] its buffer row; E*C (the spare) if not
    w: torch.Tensor       # [T*k] float32 combine weight, 0 if dropped


def route(x, router, top_k: int, capacity: int) -> Dispatch:
    """x [T,d] -> the ``Dispatch`` of its slots over ``router``'s
    experts: softmax gates in float32, the top k renormalised, a stable
    order by expert and each slot's row in the [E*C] buffer."""
    t = x.shape[0]
    e = router.shape[-1]
    nk = t * top_k
    gates = torch.softmax(x.float() @ common.cast(router, torch.float32),
                          dim=-1)
    topv, topi = torch.topk(gates, top_k, dim=-1)
    topv = topv / topv.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    slot = torch.arange(nk, device=x.device)
    # one sort of unique keys (expert, slot): the stable order by expert
    skey, _ = torch.sort(topi.reshape(-1).long() * nk + slot)
    order = torch.remainder(skey, nk)
    sle = torch.div(skey, nk, rounding_mode="floor")
    counts = torch.zeros(e, dtype=torch.long, device=x.device).index_add_(
        0, sle, torch.ones_like(sle))
    offsets = torch.cumsum(counts, 0) - counts
    pos = slot - offsets[sle]
    keep = pos < capacity
    dst = torch.where(keep, sle * capacity + pos, e * capacity)
    w = torch.where(keep, topv.reshape(-1)[order], 0.0)
    return Dispatch(gates, topi, order, keep, dst, w)


def gather_rows(x, dsp: Dispatch, capacity: int, n_experts: int, cd):
    """The [E, C, d] expert buffer in the compute dtype: each kept slot's
    token row at its (expert, position); empty rows are 0. Dropped
    slots land on a spare row past the buffer, cut off after."""
    k = dsp.order.numel() // x.shape[0]
    rows = x.index_select(0, torch.div(dsp.order, k, rounding_mode="floor"))
    buf = torch.zeros((n_experts * capacity + 1, x.shape[1]), dtype=cd,
                      device=x.device)
    buf.index_copy_(0, dsp.dst, rows.to(cd))
    return buf[:-1].view(n_experts, capacity, x.shape[1])


def experts(buf, wg, wu, wd, act: str, cd):
    """Every expert's gated FFN on its C rows: [E,C,d] -> [E*C, d] (the
    reference's einsums, outside any kernel there too)."""
    h = common.activation(torch.bmm(buf, common.cast(wg, cd)), act)
    h = h * torch.bmm(buf, common.cast(wu, cd))
    y = torch.bmm(h, common.cast(wd, cd))
    return y.view(-1, y.shape[-1])


def combine(y, dsp: Dispatch, t: int, k: int):
    """[E*C, d] expert outputs -> [T, d] float32: each kept slot's row
    (clamped gather, masked), weighted, put back in slot order, and a
    token's k contributions summed in slot order."""
    back = y.index_select(0, dsp.dst.clamp(max=y.shape[0] - 1))
    back = torch.where(dsp.keep[:, None], back.float(), 0.0) * dsp.w[:, None]
    per_slot = torch.empty_like(back).index_copy_(0, dsp.order, back)
    per_slot = per_slot.view(t, k, -1)
    out = per_slot[:, 0]
    for j in range(1, k):
        out = out + per_slot[:, j]
    return out


def _moe_local(x, router, wg, wu, wd, *, cfg, rt: Runtime, capacity: int):
    """The reference's per-shard body on one device. x [T,d]; wg/wu/wd
    every expert's weights. Returns (out [T,d] in x's dtype, aux)."""
    m = cfg.moe
    t = x.shape[0]
    k = m.top_k
    cd = rt.compute_dtype
    dsp = route(x, router, k, capacity)
    buf = gather_rows(x, dsp, capacity, wg.shape[0], cd)
    out = combine(experts(buf, wg, wu, wd, cfg.act, cd), dsp, t, k)
    # the Switch-style load-balance loss
    ids = torch.arange(m.n_experts, device=x.device)
    f = (dsp.topi[..., None] == ids).sum(dim=(0, 1)).float() / (t * k)
    pbar = dsp.gates.sum(dim=0) / t
    aux = m.n_experts * (f * pbar).sum()
    return out.to(x.dtype), aux


def apply_moe(params, x, cfg, rt: Runtime, *, dense_params=None):
    """x [..., d] -> ([..., d], aux loss scalar). The capacity comes from
    the token count T = x.numel() // d (the reference's ``tl`` on one
    device) and ``rt.capacity_factor`` or the config's.
    ``dense_params``: arctic's dense residual MLP beside the experts."""
    m = cfg.moe
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    cf = rt.capacity_factor if rt.capacity_factor is not None \
        else m.capacity_factor
    capacity = _capacity(x2.shape[0], m.n_experts, m.top_k, cf)
    out, aux = _moe_local(x2, params["router"], params["wg"], params["wu"],
                          params["wd"], cfg=cfg, rt=rt, capacity=capacity)
    out = out.view(x.shape)
    if dense_params is not None:
        out = out + mlp.apply_mlp(dense_params, x, cfg, rt)
    return out, aux * m.router_aux_weight


def apply_moe_dense_ref(params, x, cfg, rt: Runtime):
    """O(T*E) dense oracle (tests): every expert runs every token."""
    m = cfg.moe
    cd = rt.compute_dtype
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    gates = torch.softmax(
        x2.float() @ common.cast(params["router"], torch.float32), dim=-1)
    topv, topi = torch.topk(gates, m.top_k, dim=-1)
    topv = topv / topv.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    full = torch.zeros_like(gates).scatter(1, topi, topv)
    xc = x2.to(cd)
    h = common.activation(torch.einsum(
        "td,edf->tef", xc, common.cast(params["wg"], cd)), cfg.act)
    h = h * torch.einsum("td,edf->tef", xc, common.cast(params["wu"], cd))
    y = torch.einsum("tef,efd->ted", h, common.cast(params["wd"], cd))
    out = torch.einsum("ted,te->td", y.float(), full)
    return out.view(x.shape).to(x.dtype)
