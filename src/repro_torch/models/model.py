"""Top-level Model for the paged-serving path (dense, MoE and pure-SSM
decoders): port of ``repro/models/model.py`` (``init``, ``_embed``,
``_logits``, ``prefill``, ``decode_step``, ``build_model``).

Parameters are a plain dict of tensors in the reference's pytree
layout (``embed`` [V,d], ``stack`` = list over j of dicts with
[n_periods, ...] leaves, ``final_norm`` [d], ``head`` [d,V] when
untied), so ``convert.params_from_jax`` can load the reference's own
initialisation for the equivalence tests.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import common, moe, ssm, transformer
from repro_torch.models.common import Runtime


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    rt: Runtime
    device: torch.device

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random parameters from a seeded generator on the model's
        device, with the reference's shapes and scales."""
        cfg, dt, dev = self.cfg, self.rt.param_dtype, self.device
        g = generator
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        n_p = cfg.n_layers // cfg.period
        stack = []
        for j in range(cfg.period):
            layer: Dict[str, Any] = {
                "ln1": torch.zeros((n_p, d), dtype=dt, device=dev)}
            if cfg.layer_kind(j) == "mamba":
                layer["mixer"] = ssm.init_ssm(g, cfg, n_p, dt, dev)
            else:
                dense = common.init_dense
                layer["mixer"] = {
                    "wq": dense(g, (n_p, d, h * hd), d, dt, dev).reshape(
                        n_p, d, h, hd),
                    "wk": dense(g, (n_p, d, kv * hd), d, dt, dev).reshape(
                        n_p, d, kv, hd),
                    "wv": dense(g, (n_p, d, kv * hd), d, dt, dev).reshape(
                        n_p, d, kv, hd),
                    "wo": dense(g, (n_p, h * hd, d), h * hd, dt,
                                dev).reshape(n_p, h, hd, d),
                }
                if cfg.qkv_bias:
                    layer["mixer"].update(
                        bq=torch.zeros((n_p, h, hd), dtype=dt, device=dev),
                        bk=torch.zeros((n_p, kv, hd), dtype=dt, device=dev),
                        bv=torch.zeros((n_p, kv, hd), dtype=dt, device=dev))
            if cfg.post_norms:
                layer["post1"] = torch.zeros((n_p, d), dtype=dt, device=dev)
            ffn: Dict[str, Any] = {}
            if cfg.is_moe_layer(j):
                ffn["moe"] = moe.init_moe(g, cfg, n_p, dt, dev)
            if cfg.d_ff and (not ffn or cfg.moe.dense_residual):
                ff = cfg.d_ff
                ffn["dense"] = {
                    "wg": common.init_dense(g, (n_p, d, ff), d, dt, dev),
                    "wu": common.init_dense(g, (n_p, d, ff), d, dt, dev),
                    "wd": common.init_dense(g, (n_p, ff, d), ff, dt, dev)}
            if ffn:
                layer["ln2"] = torch.zeros((n_p, d), dtype=dt, device=dev)
                layer["ffn"] = ffn
                if cfg.post_norms:
                    layer["post2"] = torch.zeros((n_p, d), dtype=dt,
                                                 device=dev)
            stack.append(layer)
        embed = torch.randn((cfg.vocab_size, d), generator=g,
                            dtype=torch.float32, device=dev)
        params: Dict[str, Any] = {
            "embed": (embed * 0.02).to(dt),
            "stack": stack,
            "final_norm": torch.zeros((d,), dtype=dt, device=dev),
        }
        if not cfg.tie_embeddings:
            params["head"] = common.init_dense(g, (d, cfg.vocab_size), d,
                                               dt, dev)
        return params

    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        x = params["embed"][tokens.long()].to(self.rt.compute_dtype)
        if self.cfg.name.startswith("gemma"):
            x = x * _embed_scale(self.cfg.d_model, x.dtype)
        return x

    def _logits(self, params, x):
        cd = self.rt.compute_dtype
        if self.cfg.tie_embeddings:
            logits = x @ common.cast(params["embed"], cd).T
        else:
            logits = x @ common.cast(params["head"], cd)
        return common.softcap(logits.float(), self.cfg.final_softcap)

    # ------------------------------------------------------------------
    def prefill(self, params, tokens):
        """tokens [B,S] -> (last_logits [B,V] fp32, collected caches
        for the paging layer)."""
        x = self._embed(params, tokens)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        x, caches = transformer.stack_forward(
            params["stack"], x, self.cfg, self.rt, positions=positions,
            collect_caches=True)
        x = common.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self._logits(params, x[:, -1]), caches

    def decode_step(self, params, tokens, caches, *, ctx_lens, block_table):
        """tokens [B] -> (logits [B,V] fp32, caches updated in place)."""
        x = self._embed(params, tokens)
        x, caches = transformer.stack_decode(
            params["stack"], x, caches, self.cfg, self.rt,
            ctx_lens=ctx_lens, block_table=block_table)
        x = common.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self._logits(params, x), caches


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """gemma's embedding scale, sqrt(d_model) rounded to the compute
    dtype first, as the reference multiplies by it."""
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))


def build_model(cfg: ArchConfig, rt: Optional[Runtime] = None, *,
                device: Union[str, torch.device] = "cuda") -> Model:
    return Model(cfg=cfg, rt=rt or Runtime(), device=resolve_device(device))
