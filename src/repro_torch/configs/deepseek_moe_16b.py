"""DeepSeekMoE-16B — fine-grained MoE, 2 shared + 64 routed top-6.

[arXiv:2401.06066] 28L d_model=2048 16H (MHA kv=16) moe_d_ff=1408 vocab=102400;
first layer dense (d_ff=10944).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102_400,
    mlp_activation="silu",
    rope_theta=10_000.0,
    moe=MoEConfig(
        n_routed_experts=64,
        top_k=6,
        n_shared_experts=2,
        moe_d_ff=1408,
        first_k_dense=1,
        dense_d_ff=10944,
        router_aux_coef=0.001,
        score_func="softmax",
    ),
    citation="arXiv:2401.06066",
)
