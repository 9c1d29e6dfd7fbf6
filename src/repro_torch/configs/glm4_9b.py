"""GLM4-9B — dense decoder, RoPE, aggressive GQA (kv=2).

[hf:THUDM/glm-4-9b; hf-verified tier]
40 layers, d_model 4096, 32 heads (GQA kv=2, head_dim 128), d_ff 13696,
vocab 151552. (GLM4 uses partial rotary (0.5); we apply full RoPE — noted
as an adaptation in DESIGN.md since it does not change any roofline term.)
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    qkv_bias=True,
    norm_eps=1.5625e-07,
    source="hf:THUDM/glm-4-9b",
)
