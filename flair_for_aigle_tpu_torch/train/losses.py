"""Multi-task weighted cross-entropy (port of
``flair_for_aigle_tpu/train/losses.py``).

Class-weight vectors: per task ``value_weights.default`` broadcast +
``default_exceptions`` overrides (zero weight = ignore); aux losses clone
the task weights and apply ``per_modality_exceptions``. The loss is torch
``nn.CrossEntropyLoss(weight=w)``: sum(w[t] * nll) / sum(w[t]), except for
targets outside [0, C), on which ``F.cross_entropy`` would raise. There the
reference's gathers decide: the logit pick clamps t into [0, C), while the
weight pick ``weights[t]`` follows numpy indexing, so t in [-C, -1] reads
w[C + t] and any other t is clamped (``losses.py:57-68``). Under data
parallelism sum(w[t]) runs over the global batch (``sum_over_group``), as
GSPMD takes it.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from flair_for_aigle_tpu_torch.parallel.dist import sum_over_group


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
    Returns the float32 scalar loss. Under data parallelism (a process
    group of more than one rank) the denominator is the global batch's
    weight sum, so the ranks' losses sum to the global batch's loss."""
    lf = logits.float()
    c = lf.shape[1]
    t = targets.long()
    lse = torch.logsumexp(lf, dim=1)
    picked = torch.gather(lf, 1, t.clamp(0, c - 1)[:, None])[:, 0]
    # the weight pick as JAX's weights[t]: t in [-C, -1] wraps to C + t
    tw = torch.where((t < 0) & (t >= -c), t + c, t).clamp(0, c - 1)
    w = weights.to(lf.device, torch.float32)[tw]
    return (w * (lse - picked)).sum() / torch.clamp(sum_over_group(w.sum()), min=1e-12)
