"""Qwen2-72B — dense decoder with GQA and QKV bias.

[arXiv:2407.10671; hf-verified tier]
80 layers, d_model 8192, 64 heads (GQA kv=8), d_ff 29568, vocab 152064.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    source="arXiv:2407.10671; hf:Qwen/Qwen2-72B",
)
