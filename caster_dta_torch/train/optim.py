"""Optimizers and learning-rate schedules (counterpart of
caster_dta_tpu/train/optim.py).

The optimizers have the reference's settings (train_model.py:429-451):
Adam and AdamW are ``torch.optim``'s, SGD is ``CapturableSGD``; the learning
rate is set per batch through ``param_groups``. The schedulers are copies of
the JAX package's classes, not ``torch.optim.lr_scheduler``: they are driven
from Python with fractional epochs or the validation metric, and torch's
ReduceLROnPlateau (relative threshold 1e-4) would step at other epochs than
``metric < best``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def make_optimizer(name: str, params, lr: float, weight_decay: float = 0.0,
                   capturable: bool = False) -> torch.optim.Optimizer:
    """adam (weight decay as L2 into the gradient, as torch's Adam and the
    JAX package's ``adam_l2``), adamw, sgd (momentum 0.9, Nesterov) or
    sgd_nomomentum.

    SGD is ``CapturableSGD`` on every device, its learning rate an f32 []
    tensor on the parameters' device. ``capturable=True`` (parameters on the
    card, for a CUDA graph of the step) builds torch's Adam and AdamW with
    ``capturable=True`` and a device learning rate: bias correction on the
    device, so their bits differ from the non-capturable step's."""
    name = name.lower()
    params = list(params)
    if name not in ("adam", "adamw", "sgd", "sgd_nomomentum"):
        raise ValueError(f"unknown optimizer {name!r}")
    if name.startswith("sgd") or capturable:
        lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
    if name == "sgd":
        return CapturableSGD(params, lr, momentum=0.9, nesterov=True)
    if name == "sgd_nomomentum":
        return CapturableSGD(params, lr)
    adam = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    if capturable:
        adam.update(capturable=True, foreach=True)
    return (torch.optim.AdamW if name == "adamw" else torch.optim.Adam)(params, **adam)


class CapturableSGD(torch.optim.Optimizer):
    """torch.optim.SGD's update (momentum without dampening, Nesterov or not,
    no weight decay) in device tensor ops only, the learning rate a tensor,
    so that a CUDA graph can capture it (torch's SGD turns a tensor learning
    rate into a host number); eagerly the same on any device. The update is
    ``p - lr * g`` rounded after the product, where torch's
    ``p.add_(g, alpha=-lr)`` may fuse the two."""

    def __init__(self, params, lr: torch.Tensor, momentum: float = 0.0, nesterov: bool = False):
        super().__init__(params, {"lr": lr, "momentum": momentum, "nesterov": nesterov})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            grads = [p.grad for p in params]
            momentum = group["momentum"]
            if momentum:
                bufs = []
                for p, g in zip(params, grads):
                    state = self.state[p]
                    if "momentum_buffer" in state:
                        state["momentum_buffer"].mul_(momentum).add_(g)
                    else:
                        state["momentum_buffer"] = g.detach().clone()
                    bufs.append(state["momentum_buffer"])
                grads = torch._foreach_add(grads, bufs, alpha=momentum) if group["nesterov"] \
                    else bufs
            torch._foreach_sub_(params, torch._foreach_mul(grads, group["lr"]))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr) -> None:
    """Set every group's learning rate to ``lr`` (a number, or an f32 []
    tensor on the device). A capturable optimizer's tensor is written in
    place, so a captured graph reads the new value."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            if torch.is_tensor(lr):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(lr)
        else:
            group["lr"] = float(lr)


class Scheduler:
    """Base: step(epoch_progress=None, metric=None) -> lr."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr

    def step(self, epoch: Optional[float] = None, metric: Optional[float] = None) -> float:
        return self.lr


class ReduceLROnPlateau(Scheduler):
    """torch semantics: factor/patience on min metric
    (reference train_model.py:456-458: factor 0.8, patience 50)."""

    def __init__(self, base_lr, factor=0.8, patience=50, min_lr=0.0):
        super().__init__(base_lr)
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = math.inf
        self.num_bad = 0

    def step(self, epoch=None, metric=None):
        if metric is None:
            return self.lr
        if metric < self.best:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr


class CosineAnnealing(Scheduler):
    """CosineAnnealingLR(T_max, eta_min) (train_model.py:460-461)."""

    def __init__(self, base_lr, T_max=10, eta_min=0.0):
        super().__init__(base_lr)
        self.T_max = T_max
        self.eta_min = eta_min

    def step(self, epoch=None, metric=None):
        if epoch is None:
            return self.lr
        self.lr = self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * epoch / self.T_max)) / 2
        return self.lr


class CosineAnnealingWarmRestarts(Scheduler):
    """torch CosineAnnealingWarmRestarts(T_0, T_mult) with fractional-epoch
    stepping (train_model.py:463-464)."""

    def __init__(self, base_lr, T_0=10, T_mult=1, eta_min=0.0):
        super().__init__(base_lr)
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min

    def _cycle_pos(self, epoch: float):
        if self.T_mult == 1:
            t_cur = epoch % self.T_0
            t_i = self.T_0
            n = int(epoch // self.T_0)
        else:
            n = int(math.log(epoch / self.T_0 * (self.T_mult - 1) + 1, self.T_mult)) \
                if epoch >= self.T_0 else 0
            t_start = self.T_0 * (self.T_mult ** n - 1) / (self.T_mult - 1)
            t_i = self.T_0 * self.T_mult ** n
            t_cur = epoch - t_start
        return t_cur, t_i, n

    def step(self, epoch=None, metric=None):
        if epoch is None:
            return self.lr
        t_cur, t_i, _ = self._cycle_pos(max(epoch, 0.0))
        self.lr = self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * t_cur / t_i)) / 2
        return self.lr


class CosineAnnealingWarmRestartsDecay(CosineAnnealingWarmRestarts):
    """Warm restarts with per-cycle base-LR decay
    (reference models/custom_optims.py:7-39)."""

    def __init__(self, base_lr, T_0=10, T_mult=1, eta_min=0.0, decay_rate=0.95):
        super().__init__(base_lr, T_0, T_mult, eta_min)
        self.decay_rate = decay_rate
        self.initial_lr = base_lr

    def step(self, epoch=None, metric=None):
        if epoch is None:
            return self.lr
        _, _, n_cycles = self._cycle_pos(max(epoch, 0.0))
        self.base_lr = self.initial_lr * (self.decay_rate ** n_cycles)
        return super().step(epoch, metric)


class ExponentialLR(Scheduler):
    """gamma decay per epoch (train_model.py:470-471: gamma 0.95)."""

    def __init__(self, base_lr, gamma=0.95):
        super().__init__(base_lr)
        self.gamma = gamma

    def step(self, epoch=None, metric=None):
        if epoch is not None:
            self.lr = self.base_lr * (self.gamma ** epoch)
        return self.lr


BATCH_SCHEDULERS = ("cosine", "anneal_restart", "anneal_restart_decay")


def make_scheduler(name: Optional[str], base_lr: float) -> Optional[Scheduler]:
    """Reference scheduler selection (train_model.py:455-473)."""
    if name is None:
        return None
    name = name.lower()
    if name == "plateau":
        return ReduceLROnPlateau(base_lr, factor=0.8, patience=50)
    if name == "cosine":
        return CosineAnnealing(base_lr, T_max=10)
    if name == "anneal_restart":
        return CosineAnnealingWarmRestarts(base_lr, T_0=10)
    if name == "anneal_restart_decay":
        return CosineAnnealingWarmRestartsDecay(base_lr, T_0=10, decay_rate=0.95)
    if name == "exponential":
        return ExponentialLR(base_lr, gamma=0.95)
    raise ValueError(f"unknown scheduler {name!r}")
