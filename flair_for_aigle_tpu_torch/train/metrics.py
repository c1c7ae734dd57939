"""Segmentation metrics (port of ``flair_for_aigle_tpu/train/metrics.py``).

The confusion matrix is computed on the device inside each step and summed
there over an epoch; IoU summaries follow torchmetrics
``MulticlassJaccardIndex`` (weighted + per-class) on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from flair_for_aigle_tpu_torch.parallel.dist import sum_over_group


def confusion_matrix(preds: torch.Tensor, targets: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(...) integer preds / targets -> (C, C) int64 confusion matrix (rows =
    target, cols = pred). Pairs outside the matrix are dropped, as the
    reference's ``bincount(length=C*C)`` drops them; no host sync."""
    n2 = num_classes * num_classes
    idx = targets.reshape(-1).long() * num_classes + preds.reshape(-1).long()
    idx = torch.where((idx >= 0) & (idx < n2), idx, n2)
    counts = torch.zeros(n2 + 1, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts[:n2].reshape(num_classes, num_classes)


def iou_from_confmat(confmat: np.ndarray):
    """(per_class_iou, weighted_miou): classes absent from both target and
    prediction contribute 0; weighting by target support."""
    cm = np.asarray(confmat, np.float64)
    inter = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    support = cm.sum(1)
    total = support.sum()
    weighted = float((iou * support).sum() / total) if total > 0 else 0.0
    return iou, weighted


def per_class_mean_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean unweighted CE per class over the pixels of that class (0 for
    absent classes), from the same forward as the loss; under data
    parallelism over the global batch's pixels."""
    n_cls = logits.shape[1]
    logp = torch.log_softmax(logits.float(), dim=1)
    valid = (targets >= 0) & (targets < n_cls)
    tc = targets.long().clamp(0, n_cls - 1)
    nll = -torch.gather(logp, 1, tc[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(tc, n_cls).float() * valid[..., None]
    per_class_sum = sum_over_group(torch.einsum("bhw,bhwc->c", nll, onehot))
    counts = sum_over_group(onehot.sum(dim=(0, 1, 2)))
    return torch.where(counts > 0, per_class_sum / torch.clamp(counts, min=1), 0.0)
