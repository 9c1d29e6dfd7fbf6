"""Architecture configuration: the port's own copy of the dense-decoder
and pure-SSM parts of ``repro/configs/base.py`` (``SSMConfig``,
``ArchConfig``, ``smoke_config``).

Only what the ported serving paths read is kept; MoE, hybrid, encoder
and frontend fields come with the slices that port them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

PORTED_FAMILIES = ("dense", "ssm")


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
    family: str                  # dense | ssm in the port so far
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
    ssm: Optional[SSMConfig] = None
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
        return len(self.layer_pattern) if self.layer_pattern else 1

    def layer_kind(self, i: int) -> str:
        """'attn' | 'mamba' for the mixer at layer i."""
        return "mamba" if self.family == "ssm" else "attn"

    def attn_kind(self, i: int) -> str:
        """'global' | 'local' attention flavour at layer i."""
        if self.layer_pattern:
            return self.layer_pattern[i % len(self.layer_pattern)]
        return "global"


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU tests: the reference's
    ``smoke_config`` restricted to the dense and SSM fields."""
    period = cfg.period
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
        ssm=ssm,
    )
