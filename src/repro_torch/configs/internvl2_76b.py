"""InternVL2-76B — VLM; we implement the language backbone (InternLM2-like,

llama-arch) and stub the InternViT vision tower per the harness carve-out.
[arXiv:2404.16821] 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
"""

from repro_torch.configs.base import FrontendStub, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    mlp_activation="silu",
    rope_theta=1_000_000.0,
    frontend=FrontendStub(kind="vision", embed_dim=3200, tokens_per_sample=256),
    citation="arXiv:2404.16821",
)
