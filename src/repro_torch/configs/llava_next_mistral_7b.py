"""LLaVA-NeXT (v1.6) Mistral-7B — VLM; transformer backbone only.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified tier]
32 layers, d_model 4096, 32 heads (GQA kv=8, head_dim 128), d_ff 14336,
vocab 32000. The anyres-tiling vision tower (CLIP-ViT-L + projector) is
a stub: requests carry precomputed patch embeddings [prefix_len, d]
(``ServeEngine.submit(..., prefix_emb=)``; anyres: up to 5 tiles x 576
patches = 2880).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    frontend="vision",
    prefix_len=2880,
    norm_eps=1e-5,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (backbone: mistralai/Mistral-7B-Instruct-v0.2)",
)
