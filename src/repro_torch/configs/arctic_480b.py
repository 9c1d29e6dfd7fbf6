"""Snowflake Arctic (480B) — dense+MoE hybrid: 128 experts top-2 with a
dense residual MLP in parallel on every layer.

[hf:Snowflake/snowflake-arctic-base; hf-verified tier]
35 layers, d_model 7168, 56 heads (GQA kv=8, head_dim 128), d_ff 4864
(both the dense residual MLP and each expert), 128 experts top-2,
vocab 32000. 56 query heads over 8 KV heads: a GQA group of 7.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff=4864, every=1,
                  dense_residual=True),
    norm_eps=1e-5,
    source="hf:Snowflake/snowflake-arctic-base",
)
