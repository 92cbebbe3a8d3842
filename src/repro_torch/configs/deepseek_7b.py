"""DeepSeek-7B — dense llama-arch, MHA.

[arXiv:2401.02954] 30L d_model=4096 32H (kv=32) d_ff=11008 vocab=102400.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102_400,
    mlp_activation="silu",
    rope_theta=10_000.0,
    citation="arXiv:2401.02954",
)
