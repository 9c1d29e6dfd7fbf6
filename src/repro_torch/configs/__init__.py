"""Config registry: arch ids map to ArchConfig instances. The port has
the dense llama entry and the pure-SSM mamba2 entry so far; the other
architectures come with the slices that port their layers."""
from __future__ import annotations

from repro_torch.configs import llama3_2_1b, mamba2_1_3b
from repro_torch.configs.base import ArchConfig, SSMConfig, smoke_config

ARCHS = {m.CONFIG.name: m.CONFIG for m in (llama3_2_1b, mamba2_1_3b)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "ARCHS", "SSMConfig", "get_arch", "smoke_config"]
