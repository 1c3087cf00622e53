"""Shared model components (counterpart of caster_dta_tpu/models/common.py)."""
from __future__ import annotations

import inspect
from typing import Optional

import torch
from torch import nn


class TypeEmbedding(nn.Module):
    """Embedding table when emb_dim is set, one-hot otherwise (the trained
    config). The one-hot compares against ``arange(num_types)`` as
    ``jax.nn.one_hot`` does, so a type outside [0, num_types) gives a zero
    row instead of an error."""

    def __init__(self, num_types: int, emb_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_types, self.emb_dim = num_types, emb_dim
        if emb_dim is not None:
            self.weight = nn.Parameter(torch.empty(num_types, emb_dim))
            with torch.no_grad():
                self.weight.normal_(0.0, 1.0, generator=generator)

    @property
    def out_dim(self) -> int:
        return self.num_types if self.emb_dim is None else self.emb_dim

    def forward(self, types: torch.Tensor) -> torch.Tensor:
        if self.emb_dim is None:
            classes = torch.arange(self.num_types, device=types.device)
            return (types[..., None].long() == classes).to(torch.float32)
        return self.weight[types.long()]


def masked_pool(x: torch.Tensor, mask: torch.Tensor, mode: str) -> torch.Tensor:
    """Masked mean/max/sum pooling over the node axis of [B, N, D]
    (including the 1e10 max offset of the reference)."""
    m = mask[..., None]
    if mode == "mean":
        return (x * m).sum(dim=1) / mask.sum(dim=1, keepdim=True)
    if mode == "max":
        offset = (~mask)[..., None] * 1.0e10
        return (x - offset).amax(dim=1)
    if mode == "sum":
        return (x * m).sum(dim=1)
    raise ValueError(f"unknown element_pooling: {mode!r}")


def build_tower(cls, generator: Optional[torch.Generator], kwargs: dict) -> nn.Module:
    """``cls`` from a model_kwargs.json entry: keys that are not its
    arguments are dropped and lists become tuples, as in the JAX package."""
    known = inspect.signature(cls).parameters
    return cls(generator=generator, **{k: (tuple(v) if isinstance(v, list) else v)
                                       for k, v in kwargs.items() if k in known})
