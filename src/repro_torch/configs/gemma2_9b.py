"""Gemma2-9B — dense decoder, alternating local/global attention, softcaps.

[arXiv:2408.00118; hf-verified tier]
42 layers, d_model 3584, 16 heads (GQA kv=8, head_dim 256), d_ff 14336,
vocab 256000, sliding window 4096 on local layers, attn softcap 50,
final-logit softcap 30, GeGLU, pre+post norms, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    layer_pattern=("local", "global"),
    tie_embeddings=True,
    post_norms=True,
    act="gelu",
    norm_eps=1e-6,
    source="arXiv:2408.00118; hf:google/gemma-2-9b",
)
