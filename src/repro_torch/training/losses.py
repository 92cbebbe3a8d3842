"""Losses: the solar case study's MSE and the text decoders' cross entropy."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

NOT_PORTED = ("not ported to repro_torch yet (ROADMAP.md §1, \"The rest "
              "of the LLM side\": the frontends, MoE and MTP)")


def softmax_cross_entropy(logits, labels, mask=None):
    """Mean CE in f32.  logits: (..., V); labels: (...) int; mask: (...) bool."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    labels = torch.as_tensor(labels, device=logits.device).long()
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = logz - gold
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device).to(torch.float32)
        return torch.sum(ce * mask) / torch.clamp(mask.sum(), min=1.0)
    return ce.mean()


def loss_for_batch(model, cfg: ModelConfig, params, batch: dict, rules=None):
    """Family-dispatched loss of a text decoder (dense / ssm).  Returns
    (loss, metrics dict)."""
    if cfg.family in ("audio", "vlm") or cfg.mtp_depth:
        raise NotImplementedError(f"the {cfg.family} loss is {NOT_PORTED}")
    logits, aux = model.forward(params, tokens=batch["tokens"], rules=rules)
    ce = softmax_cross_entropy(logits, batch["labels"])
    loss = ce + aux["moe_loss"]
    return loss, {"ce": ce, "moe_loss": aux["moe_loss"]}


def solar_loss(forecaster, params, batch: dict):
    """MSE on normalized production (the paper trains MSE, evaluates MAPE)."""
    preds = forecaster.forward(params, batch["history"], batch["forecast"])
    err = preds - batch["target"]
    return torch.mean(torch.square(err)), preds
