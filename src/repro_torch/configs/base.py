"""Architecture configuration: the port's own copy of the dense-decoder,
MoE, pure-SSM, encoder-decoder and VLM parts of
``repro/configs/base.py`` (``MoEConfig``, ``SSMConfig``,
``ArchConfig``, ``smoke_config``).

Only what the ported serving paths read is kept; the hybrid fields
(``attn_every`` / ``attn_offset``) come with the slice that ports them,
and a hybrid or audio family raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

PORTED_FAMILIES = ("dense", "moe", "ssm", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden size
    every: int = 1               # layer i is MoE iff i % every == moe_offset
    moe_offset: int = 0
    dense_residual: bool = False  # arctic: dense FFN beside the experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_dim: int = 4            # depthwise causal conv width

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0      # window for 'local' layers; 0 = full
    layer_pattern: Tuple[str, ...] = ()   # () = all 'global'
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    post_norms: bool = False
    act: str = "silu"            # 'silu' (SwiGLU) | 'gelu' (GeGLU)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    n_enc_layers: int = 0        # encoder-decoder: encoder depth
    frontend: str = ""           # '' | 'audio' | 'vision' (a stub)
    prefix_len: int = 0          # frames/patches prepended by the stub
    source: str = ""

    def __post_init__(self):
        if self.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{self.name}: family {self.family!r} is not ported yet")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.layer_pattern:
            assert self.n_layers % len(self.layer_pattern) == 0, self.name

    @property
    def period(self) -> int:
        """Length of the repeating layer super-block."""
        p = len(self.layer_pattern) if self.layer_pattern else 1
        if self.moe is not None and self.moe.every > 1:
            p = math.lcm(p, self.moe.every)
        return p

    def layer_kind(self, i: int) -> str:
        """'attn' | 'mamba' for the mixer at layer i."""
        return "mamba" if self.family == "ssm" else "attn"

    def attn_kind(self, i: int) -> str:
        """'global' | 'local' attention flavour at layer i."""
        if self.layer_pattern:
            return self.layer_pattern[i % len(self.layer_pattern)]
        return "global"

    def is_moe_layer(self, i: int) -> bool:
        m = self.moe
        return m is not None and (i % m.every) == m.moe_offset


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU tests: the reference's
    ``smoke_config`` restricted to the ported fields."""
    period = cfg.period
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff=64)
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    n_layers = period * (2 if period <= 4 else 1)
    n_heads = 4
    n_kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else n_heads
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        moe=moe,
        ssm=ssm,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        prefix_len=8 if cfg.prefix_len else 0,
    )
