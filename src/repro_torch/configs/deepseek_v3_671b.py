"""DeepSeek-V3 671B — MLA + fine-grained MoE (1 shared + 256 routed, top-8) + MTP.

[arXiv:2412.19437] 61L d_model=7168 128H kv=128(MLA latent) moe_d_ff=2048
vocab=129280; first 3 layers dense (d_ff=18432); sigmoid routing with
routed_scaling=2.5; one MTP module (depth 1).
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,           # v_head_dim; qk dims come from MLAConfig
    d_ff=2048,              # routed-expert hidden dim (as assigned)
    vocab_size=129_280,
    mlp_activation="silu",
    rope_theta=10_000.0,
    moe=MoEConfig(
        n_routed_experts=256,
        top_k=8,
        n_shared_experts=1,
        moe_d_ff=2048,
        first_k_dense=3,
        dense_d_ff=18432,
        router_aux_coef=0.001,
        routed_scaling=2.5,
        score_func="sigmoid",
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    mtp_depth=1,
    citation="arXiv:2412.19437",
)
