"""Mamba-2 370M — attention-free SSM using state-space duality (SSD).

[arXiv:2405.21060] 48L d_model=1024, ssm_state=128, vocab=50280.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256, n_groups=1),
    tie_embeddings=True,
    citation="arXiv:2405.21060",
)
