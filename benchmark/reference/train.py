"""The training reference: the weighted cross-entropy, AdamW with optax's
semantics and the one-cycle learning rate, in plain PyTorch.

Frozen copies of what the repository's training recipe states
(``configs/train/config_task.yaml``): torch's ``nn.CrossEntropyLoss(weight=w)``
(sum of ``w[t] * nll`` over the sum of ``w[t]``); ``optax.adamw`` (bias-
corrected moments, update ``mu_hat / (sqrt(nu_hat) + eps)`` plus
``weight_decay * param``, scaled by the learning rate); torch's
``OneCycleLR`` with cosine annealing (div_factor 1000, final_div_factor
1e4), stepped per optimizer step.
"""

from __future__ import annotations

import math

import torch


def one_cycle_lr(max_lr: float, total_steps: int, pct_start: float,
                 div_factor: float = 1000.0, final_div_factor: float = 1e4):
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_steps = max(1, int(float(pct_start) * total_steps) - 1)
    down_steps = max(1, total_steps - up_steps - 1)

    def schedule(step: int) -> float:
        step = min(step, total_steps - 1)
        if step <= up_steps:
            pct = min(max(step / up_steps, 0.0), 1.0)
            return initial_lr + (max_lr - initial_lr) * (1 - math.cos(math.pi * pct)) / 2
        pct = min(max((step - up_steps) / down_steps, 0.0), 1.0)
        return max_lr + (min_lr - max_lr) * (1 - math.cos(math.pi * pct)) / 2

    return schedule


def class_weights(cfg: dict) -> list[float]:
    w = [float(cfg["default"])] * cfg["classes"]
    for k, v in (cfg.get("exceptions") or {}).items():
        w[int(k)] = float(v)
    return w


def weighted_cross_entropy(logits: torch.Tensor, onehot: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """Mean over pixels of ``w[t] * nll``, normalised by the sum of ``w[t]``;
    ``t`` the argmax of the one-hot labels."""
    t = onehot.argmax(dim=1)
    nll = torch.logsumexp(logits, dim=1) - logits.gather(1, t[:, None])[:, 0]
    w = weights[t]
    return (w * nll).sum() / w.sum()


class AdamW:
    """optax.adamw over named parameters."""

    def __init__(self, params: dict, b1: float, b2: float, weight_decay: float,
                 eps: float = 1e-8):
        self.params = params
        self.b1, self.b2, self.wd, self.eps = b1, b2, weight_decay, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> None:
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for k, p in self.params.items():
            g = grads[k] if grads.get(k) is not None else torch.zeros_like(p)
            self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g * g
            update = (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + self.eps)
            p -= lr * (update + self.wd * p)
