"""SeamlessM4T-Large-v2 — encoder-decoder multimodal (audio) backbone.

[arXiv:2308.11596; hf-verified tier]
24 encoder + 24 decoder layers, d_model 1024, 16 heads (MHA: kv=16,
head_dim 64), d_ff 8192, vocab 256206. The speech frontend
(w2v-BERT conformer feature extractor) is a stub: requests carry
precomputed frame embeddings [S_src, d] (``ServeEngine.submit(...,
src_emb=)``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    act="gelu",
    frontend="audio",
    norm_eps=1e-5,
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large",
)
