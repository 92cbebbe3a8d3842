"""Config registry: ``get_config("<arch-id>")`` plus the assigned input shapes."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    INPUT_SHAPES,
    FrontendStub,
    InputShape,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
    reduced_for_smoke,
)

# arch-id -> module name
ARCH_REGISTRY: dict[str, str] = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-370m": "mamba2_370m",
    "internvl2-76b": "internvl2_76b",
    "granite-8b": "granite_8b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "gemma-2b": "gemma_2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "glm4-9b": "glm4_9b",
    "deepseek-7b": "deepseek_7b",
}

ALL_ARCHS = tuple(ARCH_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_REGISTRY[arch]}")
    return mod.CONFIG


def get_solar_config():
    from repro_torch.configs.solar_lstm import CONFIG

    return CONFIG


def shape_is_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) is runnable; returns (ok, reason-if-skipped)."""
    if shape.mode == "decode" and not cfg.supports_decode:
        return False, "encoder-only architecture has no autoregressive decode"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "no sub-quadratic attention path"
    return True, ""


__all__ = [
    "ALL_ARCHS",
    "ARCH_REGISTRY",
    "INPUT_SHAPES",
    "FrontendStub",
    "InputShape",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "RGLRUConfig",
    "SSMConfig",
    "get_config",
    "get_solar_config",
    "reduced_for_smoke",
    "shape_is_applicable",
]
