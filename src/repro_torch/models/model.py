"""Top-level Model for the paged-serving and training paths (dense, MoE
and pure-SSM decoders, the encoder-decoder and the VLM): port of
``repro/models/model.py`` (``_src_len``, ``_prefix_len``, ``init``,
``_embed``, ``_fuse_inputs``, ``_encode``, ``_logits``, ``loss_fn``,
``prefill``, ``decode_step``, ``build_model``).

Parameters are a plain dict of tensors in the reference's pytree
layout (``embed`` [V,d], ``stack`` = list over j of dicts with
[n_periods, ...] leaves, ``final_norm`` [d], ``head`` [d,V] when
untied; an encoder-decoder's ``enc_stack`` and ``enc_norm`` beside
them and a ``cross_ln`` / ``cross`` block in each decoder layer), so
``convert.params_from_jax`` can load the reference's own
initialisation for the equivalence tests.

The modality frontends are stubs, as in the reference: a VLM request
carries its patch embeddings (``prefix_emb`` [B,P,d], placed before the
token embeddings, positions over the whole), an encoder-decoder request
its frame embeddings (``src_emb`` [B,Ssrc,d], with ``src_valid``
[B,Ssrc] marking the frames cross-attention may see).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, common, moe, ssm, transformer
from repro_torch.models.common import Runtime


def _src_len(cfg: ArchConfig, seq_len: int) -> int:
    """Source frames an encoder-decoder's serving slot holds at
    ``seq_len`` context (the engine's ``src_cap``)."""
    return max(128, seq_len // 4) if cfg.n_enc_layers else 0


def _prefix_len(cfg: ArchConfig, seq_len: int) -> int:
    return min(cfg.prefix_len, seq_len // 2) if cfg.prefix_len else 0


def _enc_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder stack's config: the model's widths at the encoder's
    depth, dense, one layer kind."""
    return dataclasses.replace(cfg, n_layers=cfg.n_enc_layers, moe=None,
                               layer_pattern=())


def _init_stack(g: torch.Generator, cfg: ArchConfig, dt, dev, *,
                cross: bool = False):
    """Stacked layer parameters: a list over the intra-period index j of
    dicts with [n_periods, ...] leaves (a decoder layer of an
    encoder-decoder also holds ``cross_ln`` and a bias-free ``cross``
    attention block)."""
    d = cfg.d_model
    n_p = cfg.n_layers // cfg.period
    stack = []
    for j in range(cfg.period):
        layer: Dict[str, Any] = {
            "ln1": torch.zeros((n_p, d), dtype=dt, device=dev)}
        if cfg.layer_kind(j) == "mamba":
            layer["mixer"] = ssm.init_ssm(g, cfg, n_p, dt, dev)
        else:
            layer["mixer"] = attention.init_attention(g, cfg, n_p, dt, dev)
        if cfg.post_norms:
            layer["post1"] = torch.zeros((n_p, d), dtype=dt, device=dev)
        if cross:
            layer["cross_ln"] = torch.zeros((n_p, d), dtype=dt, device=dev)
            layer["cross"] = attention.init_attention(g, cfg, n_p, dt, dev,
                                                      cross=True)
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
                layer["post2"] = torch.zeros((n_p, d), dtype=dt, device=dev)
        stack.append(layer)
    return stack


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
        d = cfg.d_model
        stack = _init_stack(g, cfg, dt, dev, cross=bool(cfg.n_enc_layers))
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
        if cfg.n_enc_layers:
            params["enc_stack"] = _init_stack(g, _enc_cfg(cfg), dt, dev)
            params["enc_norm"] = torch.zeros((d,), dtype=dt, device=dev)
        return params

    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        x = params["embed"][tokens.long()].to(self.rt.compute_dtype)
        if self.cfg.name.startswith("gemma"):
            x = x * _embed_scale(self.cfg.d_model, x.dtype)
        return x

    def _fuse_inputs(self, params, batch):
        """tokens (+ prefix embeddings before them) -> x [B,S,d],
        positions [B,S] over the whole."""
        x = self._embed(params, batch["tokens"])
        if batch.get("prefix_emb") is not None:
            pre = batch["prefix_emb"].to(self.rt.compute_dtype)
            x = torch.cat([pre, x], dim=1)
        b, s = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        return x, positions

    def _encode(self, params, batch):
        """The encoder stack over ``src_emb`` (bidirectional and
        unmasked, as in the reference), then ``enc_norm`` -> (enc_out,
        src_valid); (None, None) without an encoder."""
        if not self.cfg.n_enc_layers:
            return None, None
        enc_cfg = _enc_cfg(self.cfg)
        src = batch["src_emb"].to(self.rt.compute_dtype)
        b, s = src.shape[:2]
        pos = torch.arange(s, device=src.device)[None, :].expand(b, s)
        enc_out, _, _ = transformer.stack_forward(
            params["enc_stack"], src, enc_cfg, self.rt, positions=pos,
            bidirectional=True)
        enc_out = common.rms_norm(enc_out, params["enc_norm"],
                                  enc_cfg.norm_eps)
        return enc_out, batch.get("src_valid")

    def _logits(self, params, x):
        cd = self.rt.compute_dtype
        if self.cfg.tie_embeddings:
            logits = x @ common.cast(params["embed"], cd).T
        else:
            logits = x @ common.cast(params["head"], cd)
        return common.softcap(logits.float(), self.cfg.final_softcap)

    # ------------------------------------------------------------------
    def loss_fn(self, params, batch):
        """Train loss, the reference's line for line. batch: tokens
        [B,S], labels [B,S] (-1 = masked), optional positions,
        segment_ids (packed documents), prefix_emb, src_emb, src_valid.
        Returns (loss, metrics: nll, aux_loss, tokens, [zloss], loss),
        float32 scalars on the model's device."""
        x, positions = self._fuse_inputs(params, batch)
        enc_out, src_valid = self._encode(params, batch)
        x, aux, _ = transformer.stack_forward(
            params["stack"], x, self.cfg, self.rt, positions=positions,
            segment_ids=batch.get("segment_ids"), enc_out=enc_out,
            src_valid=src_valid)
        x = common.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        labels = batch["labels"]
        if batch.get("prefix_emb") is not None:   # loss on the text tail
            x = x[:, -labels.shape[1]:]
        logits = self._logits(params, x)
        mask = (labels >= 0).float()
        safe = labels.clamp_min(0).long()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        nll = (lse - gold) * mask
        ntok = mask.sum().clamp_min(1.0)
        loss = nll.sum() / ntok
        metrics = {"nll": loss, "aux_loss": aux, "tokens": ntok}
        if self.rt.zloss:
            zl = self.rt.zloss * ((lse * mask) ** 2).sum() / ntok
            loss = loss + zl
            metrics["zloss"] = zl
        loss = loss + aux
        metrics["loss"] = loss
        return loss, metrics

    # ------------------------------------------------------------------
    def prefill(self, params, batch):
        """``batch``: the reference's keys (``tokens`` [B,S]; optional
        ``prefix_emb``, ``src_emb``, ``src_valid``, ``positions``), or a
        token tensor alone -> (last_logits [B,V] fp32, collected caches
        for the paging layer)."""
        if isinstance(batch, torch.Tensor):
            batch = {"tokens": batch}
        x, positions = self._fuse_inputs(params, batch)
        enc_out, src_valid = self._encode(params, batch)
        x, _, caches = transformer.stack_forward(
            params["stack"], x, self.cfg, self.rt, positions=positions,
            enc_out=enc_out, src_valid=src_valid, collect_caches=True)
        x = common.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self._logits(params, x[:, -1]), caches

    def decode_step(self, params, tokens, caches, *, ctx_lens, block_table,
                    src_valid=None):
        """tokens [B] -> (logits [B,V] fp32, caches updated in place);
        ``src_valid`` [B,Ssrc] masks an encoder-decoder's source frames."""
        x = self._embed(params, tokens)
        x, caches = transformer.stack_decode(
            params["stack"], x, caches, self.cfg, self.rt,
            ctx_lens=ctx_lens, block_table=block_table, src_valid=src_valid)
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
