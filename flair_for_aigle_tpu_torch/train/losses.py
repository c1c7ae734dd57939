"""Multi-task weighted cross-entropy (port of
``flair_for_aigle_tpu/train/losses.py``).

Class-weight vectors: per task ``value_weights.default`` broadcast +
``default_exceptions`` overrides (zero weight = ignore); aux losses clone
the task weights and apply ``per_modality_exceptions``. The loss is torch
``nn.CrossEntropyLoss(weight=w)``: sum(w[t] * nll) / sum(w[t]), except that
targets are clamped into [0, C) for the pick and for ``w[t]`` alike, as the
reference clamps its gathers (``losses.py:57-68``); ``F.cross_entropy``
would raise on such targets.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def compute_default_weights(task_config: Dict[str, Any]) -> np.ndarray:
    n = len(task_config["value_name"])
    w = np.full(n, float(task_config["value_weights"]["default"]), np.float32)
    for k, v in (task_config["value_weights"].get("default_exceptions") or {}).items():
        w[int(k)] = float(v)
    return w


def build_loss_weights(config: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """{task: weights} plus {'aux_<mod>_<task>': weights} for active aux."""
    weights: Dict[str, np.ndarray] = {}
    for task in config["labels"]:
        task_cfg = config["labels_configs"][task]
        weights[task] = compute_default_weights(task_cfg)
        for modality, aux_active in config["modalities"].get("aux_loss", {}).items():
            if aux_active and config["modalities"]["inputs"].get(modality, False):
                w = weights[task].copy()
                mod_exc = (task_cfg["value_weights"]
                           .get("per_modality_exceptions", {}) or {}).get(modality)
                for k, v in (mod_exc or {}).items():
                    w[int(k)] = float(v)
                weights[f"aux_{modality}_{task}"] = w
    return weights


def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """logits (B, C, H, W); targets (B, H, W) integer; weights (C,).
    Returns the float32 scalar loss."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=1)
    tc = targets.long().clamp(0, lf.shape[1] - 1)
    picked = torch.gather(lf, 1, tc[:, None])[:, 0]
    w = weights.to(lf.device, torch.float32)[tc]
    return (w * (lse - picked)).sum() / torch.clamp(w.sum(), min=1e-12)
