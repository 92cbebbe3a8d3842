"""Config schema for every architecture family the framework supports.

A single ``ModelConfig`` dataclass covers dense / MoE / SSM / hybrid / audio /
VLM families; family-specific sub-configs are optional fields.  Configs are
plain frozen dataclasses so they hash, compare, and serialize trivially and
never touch jax at import time.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from collections.abc import Sequence

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (DeepSeek-style fine-grained)."""

    n_routed_experts: int
    top_k: int
    n_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    first_k_dense: int = 0            # leading layers that stay dense
    dense_d_ff: int = 0               # d_ff of those dense layers (0 -> moe_d_ff)
    router_aux_coef: float = 0.001    # load-balance auxiliary loss coefficient
    routed_scaling: float = 1.0       # DeepSeek-V3 routed-expert output scale
    score_func: str = "softmax"       # softmax | sigmoid (DSv3 uses sigmoid)
    capacity_factor: float = 1.25     # GShard token-capacity multiplier

    @property
    def effective_dense_d_ff(self) -> int:
        return self.dense_d_ff or self.moe_d_ff


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) configuration."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256
    n_groups: int = 1
    conv_width: int = 4
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU recurrent block (RecurrentGemma / Griffin)."""

    lru_width: int = 0                # 0 -> d_model
    conv_width: int = 4
    block_pattern: Sequence[str] = ("recurrent", "recurrent", "local_attn")
    attn_window: int = 2048


@dataclass(frozen=True)
class FrontendStub:
    """Shape-only stand-in for a modality frontend (harness carve-out).

    ``input_specs`` hands the backbone precomputed frame/patch embeddings with
    this dimensionality instead of raw audio/pixels.
    """

    kind: str                         # "audio" | "vision"
    embed_dim: int                    # dim of the precomputed embeddings
    tokens_per_sample: int            # frames / patches per example (train shape)


# ---------------------------------------------------------------------------
# Main model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    citation: str = ""

    # --- attention details -------------------------------------------------
    rope_theta: float = 10_000.0
    attn_window: int = 0              # 0 -> full attention
    attn_logit_softcap: float = 0.0   # gemma-2 style softcap (0 = off)
    qkv_bias: bool = False

    # --- MLP ----------------------------------------------------------------
    mlp_activation: str = "silu"      # silu (SwiGLU) | gelu (GeGLU)

    # --- family-specific ----------------------------------------------------
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    frontend: FrontendStub | None = None

    # --- structure ----------------------------------------------------------
    encoder_only: bool = False        # HuBERT: bidirectional, no causal mask/decode
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    mtp_depth: int = 0                # DeepSeek-V3 multi-token prediction depth
    # sliding-window override applied only to the long_500k decode shape so
    # pure-full-attention archs become sub-quadratic there (see DESIGN.md §4).
    long_context_window: int = 4096

    # --- numerics / training -----------------------------------------------
    dtype: str = "bfloat16"
    remat: str = "none"               # none | full | dots_saveable

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ----- derived ----------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    @property
    def supports_long_context(self) -> bool:
        """True if a sub-quadratic path exists (SSM/hybrid window, or the
        sliding-window decode variant for dense/MoE archs)."""
        if self.encoder_only:
            return False
        return True  # all decoder archs get a window override; see DESIGN.md

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head), used for
        MODEL_FLOPS = 6*N*D roofline terms."""
        from repro_torch.models.params import count_params_analytic

        return count_params_analytic(self)

    def n_active_params(self) -> int:
        from repro_torch.models.params import count_params_analytic

        return count_params_analytic(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                         # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduced_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family variant: 2 layers, d_model<=512, <=4 experts."""
    kw: dict = dict(
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else cfg.n_kv_heads,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        remat="none",
        dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_routed_experts=4,
            top_k=2,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            moe_d_ff=128,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            dense_d_ff=256 if cfg.moe.first_k_dense else 0,
            capacity_factor=8.0,      # effectively dropless at smoke scale
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            q_lora_rank=64, kv_lora_rank=32,
            qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=32, head_dim=32, chunk_size=32)
        kw["n_heads"] = 0
        kw["n_kv_heads"] = 0
        kw["head_dim"] = 0
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=256, attn_window=64)
        kw["n_kv_heads"] = 1
    if cfg.frontend is not None:
        kw["frontend"] = dataclasses.replace(
            cfg.frontend, embed_dim=cfg.frontend.embed_dim and 256, tokens_per_sample=16
        )
    if cfg.mtp_depth:
        kw["mtp_depth"] = 1
    return cfg.replace(**kw)
