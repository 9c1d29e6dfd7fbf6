"""Llama-3.2-1B — small dense llama3 decoder.

[hf:meta-llama/Llama-3.2-1B; unverified tier]
16 layers, d_model 2048, 32 heads (GQA kv=8, head_dim 64), d_ff 8192,
vocab 128256, tied embeddings, rope theta 500000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=500_000.0,
    norm_eps=1e-5,
    source="hf:meta-llama/Llama-3.2-1B",
)
