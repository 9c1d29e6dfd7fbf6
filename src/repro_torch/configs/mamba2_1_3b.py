"""Mamba2-1.3b — pure SSM (state-space duality / SSD), attention-free.

[arXiv:2405.21060; unverified tier]
48 layers, d_model 2048, attention-free (d_ff=0: the Mamba2 block replaces
both mixer and MLP), vocab 50280, ssm_state=128, headdim 64, expand 2.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    norm_eps=1e-5,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-1.3b",
)
