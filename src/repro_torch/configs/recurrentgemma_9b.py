"""RecurrentGemma-9B — hybrid RG-LRU + local attention, 1:2 pattern.

[arXiv:2402.19427] Griffin/RecurrentGemma. 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000; every third block is local (window 2048) attention.
"""

from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,  # 38 residual blocks; pattern (rec, rec, local_attn) repeating
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,           # MQA
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    mlp_activation="gelu",  # GeGLU
    rglru=RGLRUConfig(
        lru_width=4096,
        conv_width=4,
        block_pattern=("recurrent", "recurrent", "local_attn"),
        attn_window=2048,
    ),
    rope_theta=10_000.0,
    attn_window=2048,
    citation="arXiv:2402.19427",
)
