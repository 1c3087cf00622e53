"""Masked batch normalization over padded node batches (counterpart of
caster_dta_tpu/nn/norm.py).

torch BatchNorm1d's semantics (running stats, eps 1e-5, momentum 0.1),
computed over the real rows only when a mask is given. In training the batch
statistics normalize and update the running ones; in eval mode the running
ones normalize.

The running statistics are buffers that stay out of the state dict
(``persistent=False``): the JAX package's checkpoints hold ``params`` only,
and its loader serves the init's ``batch_stats`` (mean 0, variance 1), so a
loaded model here serves the same, and a strict load asks for the scale and
bias alone.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """x [..., features] -> the same shape. ``weight`` and ``bias`` are
    torch's names for flax's ``scale`` and ``bias``."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.features, self.momentum, self.eps = features, momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features), persistent=False)
        self.register_buffer("running_var", torch.ones(features), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask`` broadcastable to ``x.shape[:-1]`` (True: a real row)."""
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            flat = x.reshape(-1, self.features)
            if mask is not None:
                m = torch.broadcast_to(mask[..., None], x.shape).reshape(-1, self.features)
                m = m.to(flat.dtype)
                n = torch.clamp(m[:, 0].sum(), min=1.0)
                mean = (flat * m).sum(0) / n
                var = ((flat - mean) ** 2 * m).sum(0) / n
                denom = torch.clamp(n - 1.0, min=1.0)
            else:
                n = flat.shape[0]
                mean = flat.mean(0)
                var = flat.var(0, unbiased=False)
                denom = max(n - 1.0, 1.0)
            # torch updates the running variance with the unbiased estimate
            unbiased = var * n / denom
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
