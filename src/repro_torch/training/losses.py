"""Loss functions for every architecture family + the solar case study."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

MTP_WEIGHT = 0.3  # DeepSeek-V3 MTP loss coefficient


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
    """Family-dispatched training loss.  Returns (loss, metrics dict)."""
    if cfg.family == "audio":
        logits, aux = model.forward(params, embeds=batch["embeds"],
                                    mask=batch["mask"], rules=rules)
        ce = softmax_cross_entropy(logits, batch["labels"], batch["mask"])
        return ce, {"ce": ce}

    if cfg.family == "vlm":
        logits, aux = model.forward(params, tokens=batch["tokens"],
                                    embeds=batch["patches"], rules=rules)
        n_patch = batch["patches"].shape[1]
        text_logits = logits[:, n_patch:]
        ce = softmax_cross_entropy(text_logits, batch["labels"])
        return ce, {"ce": ce}

    # text decoders (dense / moe / ssm / hybrid)
    logits, aux = model.forward(params, tokens=batch["tokens"], rules=rules)
    ce = softmax_cross_entropy(logits, batch["labels"])
    loss = ce + aux["moe_loss"]
    metrics = {"ce": ce, "moe_loss": aux["moe_loss"]}

    if cfg.mtp_depth:
        # predict t_{i+2} from h_i and emb(t_{i+1}); valid for the first s-1
        # positions (the last lacks a t_{i+2} target)
        labels = torch.as_tensor(batch["labels"], device=logits.device).long()
        mtp_logits = model.mtp_logits(params, aux["hidden"], labels,
                                      rules=rules)
        mtp_labels = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
        valid = torch.ones_like(mtp_labels, dtype=torch.bool)
        valid[:, -1] = False
        mtp_ce = softmax_cross_entropy(mtp_logits, mtp_labels, valid)
        loss = loss + MTP_WEIGHT * mtp_ce
        metrics["mtp_ce"] = mtp_ce

    return loss, metrics


def solar_loss(forecaster, params, batch: dict):
    """MSE on normalized production (the paper trains MSE, evaluates MAPE)."""
    preds = forecaster.forward(params, batch["history"], batch["forecast"])
    err = preds - batch["target"]
    return torch.mean(torch.square(err)), preds
