"""DBRX-132B — fine-grained MoE decoder (16 experts, top-4).

[hf:databricks/dbrx-base; unverified tier]
40 layers, d_model 6144, 48 heads (GQA kv=8, head_dim 128), per-expert
d_ff 10752, 16 experts top-4 on every layer, vocab 100352.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff=10752, every=1),
    norm_eps=1e-5,
    source="hf:databricks/dbrx-base",
)
