"""HuBERT X-Large — audio encoder-only transformer backbone.

[arXiv:2106.07447] 48L d_model=1280 16H (MHA, kv=16) d_ff=5120 vocab=504
(masked-prediction codebook targets).  The conv waveform frontend is a stub:
``input_specs`` supplies precomputed frame embeddings (harness carve-out).
"""

from repro_torch.configs.base import FrontendStub, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    mlp_activation="gelu",
    encoder_only=True,
    frontend=FrontendStub(kind="audio", embed_dim=512, tokens_per_sample=4096),
    citation="arXiv:2106.07447",
)
