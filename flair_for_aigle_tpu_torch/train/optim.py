"""Optimizers and learning-rate schedules with the reference's semantics
(port of ``flair_for_aigle_tpu/train/optim.py``, whose optimizers are
optax's; the logic is copied here, not imported, since that module imports
optax).

* sgd / adam / adamw as ``optax.sgd`` / ``optax.adam`` / ``optax.adamw``:
  bias-corrected moments, updates ``mu_hat / (sqrt(nu_hat) + eps)``, adamw
  adds ``weight_decay * param`` for every parameter before the learning
  rate scales the update. The learning rate is set from the host at every
  step (``trainer.py:273-276``).
* one_cycle_lr: torch OneCycleLR (cos, div_factor 1000, final_div_factor
  1e4), stepped per optimizer step.
* reduce_on_plateau: factor 0.5, cooldown 4, min_lr 1e-7, stepped per epoch
  on val_loss (host state).
* cycle_then_plateau: a one-cycle warm-up (pct_start 1.0, final_div_factor
  1) over warmup_fraction * total steps, then plateau.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch


def one_cycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.3,
                 div_factor: float = 1000.0,
                 final_div_factor: float = 1e4) -> Callable[[int], float]:
    """torch OneCycleLR with cosine annealing (anneal_strategy='cos')."""
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


@dataclass
class ReduceLROnPlateau:
    """Host-side plateau tracker (torch semantics, mode='min')."""

    factor: float = 0.5
    patience: int = 10
    cooldown: int = 4
    min_lr: float = 1e-7
    best: float = math.inf
    bad_epochs: int = 0
    cooldown_count: int = 0
    scale: float = 1.0

    def step(self, metric: float) -> float:
        if self.cooldown_count > 0:
            self.cooldown_count -= 1
            self.bad_epochs = 0
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
                self.cooldown_count = self.cooldown
        return self.scale

    def lr(self, base_lr: float) -> float:
        return max(base_lr * self.scale, self.min_lr)

    def state_dict(self) -> dict:
        return {"best": self.best, "bad_epochs": self.bad_epochs,
                "cooldown_count": self.cooldown_count, "scale": self.scale}

    def load_state_dict(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)


@dataclass
class SchedulerState:
    """The configured schedule; the trainer consults it per step (one_cycle)
    and per epoch (plateau variants)."""

    kind: Optional[str]
    base_lr: float
    total_steps: int
    warmup_fraction: float = 0.0
    plateau: Optional[ReduceLROnPlateau] = None
    using_plateau: bool = False
    _one_cycle: Optional[Callable] = None

    def lr_for_step(self, step: int) -> float:
        if self.kind == "one_cycle_lr":
            return float(self._one_cycle(step))
        if self.kind == "cycle_then_plateau":
            warmup_steps = max(1, int(self.warmup_fraction * self.total_steps))
            if step < warmup_steps and not self.using_plateau:
                return float(self._one_cycle(min(step, warmup_steps - 1)))
            self.using_plateau = True
            return self.plateau.lr(self.base_lr)
        if self.kind == "reduce_on_plateau":
            return self.plateau.lr(self.base_lr)
        return self.base_lr

    def epoch_end(self, val_loss: float) -> None:
        if self.kind == "reduce_on_plateau" or (
                self.kind == "cycle_then_plateau" and self.using_plateau):
            self.plateau.step(val_loss)

    def state_dict(self) -> dict:
        """The host state a resumed run needs: the plateau tracker and the
        warm-up switch. The horizon is not part of it: the trainer sets it
        after the restore."""
        return {"using_plateau": self.using_plateau,
                "plateau": None if self.plateau is None else self.plateau.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.using_plateau = state["using_plateau"]
        if self.plateau is not None and state["plateau"] is not None:
            self.plateau.load_state_dict(state["plateau"])


def make_scheduler(cfg: dict, total_steps: int) -> SchedulerState:
    kind = cfg.get("scheduler")
    lr = cfg["learning_rate"]
    state = SchedulerState(kind=kind, base_lr=lr, total_steps=total_steps,
                           warmup_fraction=cfg.get("warmup_fraction", 0.0))
    if kind == "one_cycle_lr":
        state._one_cycle = one_cycle_lr(lr, total_steps,
                                        pct_start=cfg.get("warmup_fraction", 0.3))
    elif kind == "cycle_then_plateau":
        warmup_steps = max(1, int(cfg.get("warmup_fraction", 0.0) * total_steps))
        state._one_cycle = one_cycle_lr(lr, warmup_steps, pct_start=1.0,
                                        final_div_factor=1.0)
        state.plateau = ReduceLROnPlateau(patience=10)
    elif kind == "reduce_on_plateau":
        state.plateau = ReduceLROnPlateau(patience=cfg.get("plateau_patience", 10))
    return state


class Optimizer:
    """optax-semantics sgd / adam / adamw over a list of parameters. The
    moments are float32 tensors beside the parameters; ``step`` applies one
    update in place for the given gradients (None counts as zero, as an
    unused parameter's gradient is zero in the reference) and learning
    rate."""

    EPS = 1e-8  # optax's default

    def __init__(self, params: Sequence[torch.Tensor], kind: str,
                 b1: float = 0.9, b2: float = 0.999, weight_decay: float = 0.0):
        if kind not in ("sgd", "adam", "adamw"):
            raise ValueError(f"Unsupported optimizer type: {kind}")
        self.params = list(params)
        self.kind = kind
        self.b1, self.b2 = b1, b2
        self.weight_decay = weight_decay if kind == "adamw" else 0.0
        self.count = 0
        if kind != "sgd":
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]], lr: float) -> None:
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        self.count += 1
        if self.kind == "sgd":
            torch._foreach_add_(self.params, grads, alpha=-lr)
            return
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        denom = torch._foreach_div(self.nu, 1 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        upd = torch._foreach_div(self.mu, 1 - b1 ** self.count)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)

    def state_dict(self) -> dict:
        """The step count and the moments, in parameter order."""
        out = {"kind": self.kind, "count": self.count}
        if self.kind != "sgd":
            out.update(mu=[m.detach().cpu() for m in self.mu],
                       nu=[n.detach().cpu() for n in self.nu])
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if state["kind"] != self.kind:
            raise ValueError(f"optimizer state of {state['kind']!r}, not {self.kind!r}")
        self.count = int(state["count"])
        if self.kind != "sgd":
            for dst, src in ((self.mu, state["mu"]), (self.nu, state["nu"])):
                if [tuple(t.shape) for t in dst] != [tuple(t.shape) for t in src]:
                    raise ValueError("optimizer moments do not match the parameters")
                for d, t in zip(dst, src):
                    d.copy_(t)


def make_optimizer(cfg: dict, params: Sequence[torch.Tensor]) -> Optimizer:
    kind = cfg["optimizer"]
    b1, b2 = cfg.get("optim_betas", [0.9, 0.999])
    return Optimizer(params, kind, b1=b1, b2=b2,
                     weight_decay=cfg.get("optim_weight_decay", 0.01))
