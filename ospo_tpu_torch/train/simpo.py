"""SimPO (reference-free DPO) loss and batch log-probs — counterpart of
``ospo_tpu/train/simpo.py`` (:35-114), the math of ``JanusProTrainWrapper``:

  logits  = (logp_chosen − logp_rejected) − γ/β
  sigmoid: −logσ(β·logits)·(1−ls) − logσ(−β·logits)·ls
  hinge:   relu(1 − β·logits)

with length-averaged log-probs over label-masked tokens (labels shifted by
one against logits).  Metric names are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ospo_tpu_torch.constants import IGNORE_ID


@dataclasses.dataclass(frozen=True)
class SimPOConfig:
    beta: float = 10.0
    gamma_beta_ratio: float = 0.5
    label_smoothing: float = 0.0
    sft_weight: float = 0.0
    loss_type: str = "sigmoid"  # sigmoid | hinge


def _token_logps(logits: torch.Tensor, labels: torch.Tensor):
    """Next-token-aligned log-probs of the labels and their mask."""
    labels = labels[:, 1:]
    logits = logits[:, :-1, :]
    mask = labels != IGNORE_ID
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    logps = torch.log_softmax(logits, dim=-1)
    tok = torch.gather(logps, -1, safe[..., None].long())[..., 0]
    return tok, mask


def batch_logps(logits: torch.Tensor, labels: torch.Tensor,
                average_log_prob: bool = True) -> torch.Tensor:
    """Per-sequence (mean) log-prob of the labelled tokens
    (``get_batch_logps``, train.py:375-396)."""
    tok, mask = _token_logps(logits, labels)
    total = (tok * mask).sum(dim=-1)
    if average_log_prob:
        return total / mask.sum(dim=-1).clamp_min(1)
    return total


def simpo_loss(cfg: SimPOConfig, chosen_logps: torch.Tensor,
               rejected_logps: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (per-pair losses, chosen_rewards, rejected_rewards)."""
    logits = (chosen_logps - rejected_logps) - cfg.gamma_beta_ratio
    if cfg.loss_type == "sigmoid":
        losses = (-F.logsigmoid(cfg.beta * logits) * (1 - cfg.label_smoothing)
                  - F.logsigmoid(-cfg.beta * logits) * cfg.label_smoothing)
    elif cfg.loss_type == "hinge":
        losses = torch.relu(1 - cfg.beta * logits)
    else:
        raise ValueError(f"Unknown loss type: {cfg.loss_type}")
    chosen_rewards = cfg.beta * chosen_logps.detach()
    rejected_rewards = cfg.beta * rejected_logps.detach()
    return losses, chosen_rewards, rejected_rewards


def sft_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over labelled positions of the chosen half (train.py:421-428)."""
    tok, mask = _token_logps(logits, labels)
    return -(tok * mask).sum() / mask.sum().clamp_min(1)


def loss_and_metrics(cfg: SimPOConfig, all_logits: torch.Tensor,
                     all_labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``all_logits`` [2B, T, V] fp32, chosen rows stacked over rejected."""
    b = all_logits.shape[0] // 2
    logps = batch_logps(all_logits, all_labels, average_log_prob=True)
    chosen_logps, rejected_logps = logps[:b], logps[b:]
    losses, chosen_rw, rejected_rw = simpo_loss(cfg, chosen_logps,
                                                rejected_logps)
    loss = losses.mean()
    logits = all_logits.detach()
    metrics = {
        "rewards/chosen": chosen_rw.mean(),
        "rewards/rejected": rejected_rw.mean(),
        "rewards/accuracies": (chosen_rw > rejected_rw).float().mean(),
        "rewards/margins": (chosen_rw - rejected_rw).mean(),
        "logps/chosen": chosen_logps.detach().mean(),
        "logps/rejected": rejected_logps.detach().mean(),
        "logits/chosen": logits[:b].mean(),
        "logits/rejected": logits[b:].mean(),
    }
    if cfg.sft_weight > 0.0:
        sft = sft_cross_entropy(all_logits[:b], all_labels[:b])
        loss = loss + cfg.sft_weight * sft
        metrics["sft_loss"] = sft.detach()
    metrics["loss"] = loss.detach()
    return loss, metrics
