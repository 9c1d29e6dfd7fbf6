"""Config registry: arch ids map to ArchConfig instances. The port has
the dense decoders (llama3.2-1b, gemma2-9b, glm4-9b, qwen2-72b), the
MoE decoders (dbrx-132b, arctic-480b) and the pure-SSM mamba2 entry so
far; the other architectures come with the slices that port their
layers. The paper's SSD configuration (``fmmu_paper``) is exported
beside them."""
from __future__ import annotations

from repro_torch.configs import (arctic_480b, dbrx_132b, gemma2_9b, glm4_9b,
                                 llama3_2_1b, mamba2_1_3b, qwen2_72b)
from repro_torch.configs.base import (ArchConfig, MoEConfig, SSMConfig,
                                      smoke_config)
from repro_torch.configs.fmmu_paper import (NAND_V1, NAND_V2, PAPER_SSD,
                                            SSDConfig)

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    llama3_2_1b, mamba2_1_3b, gemma2_9b, glm4_9b, qwen2_72b, dbrx_132b,
    arctic_480b)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "ARCHS", "MoEConfig", "SSMConfig", "get_arch",
           "smoke_config", "PAPER_SSD", "SSDConfig", "NAND_V1", "NAND_V2"]
