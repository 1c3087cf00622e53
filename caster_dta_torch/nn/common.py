"""Shared NN helpers (counterpart of caster_dta_tpu/nn/common.py): the
activation names, the mixed-precision policy, a torch-style ``Dense``,
PyG-style ``MLP``, a flax-style ``LayerNorm`` and dropout with an explicit
generator.

Mixed precision follows the JAX package's policy, not ``torch.autocast``:
inside ``compute_dtype(torch.bfloat16)`` every ``Dense`` computes
``x.to(dt) @ W.to(dt)`` and adds ``bias.to(dt)``, its output stays in ``dt``,
and parameters stay f32. Everything downstream keeps the dtype PyTorch's type
promotion gives it until an explicit cast, as in JAX; ``LayerNorm`` computes
in f32 and returns f32, as flax's does for a bf16 input with f32 params. The
setting is scoped to the ``with`` block (``Trainer`` enters it around its
steps), so it never outlives the code that set it.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

_ACTS: dict = {
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "elu": F.elu,
    "selu": F.selu,
    "swish": F.silu,
    "silu": F.silu,
    "none": None,
    None: None,
}


def select_activation(name) -> Optional[Callable]:
    """String -> activation function (None means identity)."""
    if callable(name):
        return name
    key = name.lower() if isinstance(name, str) else name
    if key not in _ACTS:
        raise ValueError(f"Activation function {name!r} not recognized")
    return _ACTS[key]


def apply_act(act: Optional[Callable], x: torch.Tensor) -> torch.Tensor:
    return x if act is None else act(x)


_COMPUTE_DTYPE: contextvars.ContextVar[Optional[torch.dtype]] = contextvars.ContextVar(
    "caster_dta_torch_compute_dtype", default=None)


def get_compute_dtype() -> Optional[torch.dtype]:
    """The matmul compute dtype in force (None: follow the input dtype)."""
    return _COMPUTE_DTYPE.get()


@contextlib.contextmanager
def compute_dtype(dtype: Optional[torch.dtype]) -> Iterator[None]:
    """Set the matmul compute dtype for the ``with`` block only."""
    token = _COMPUTE_DTYPE.set(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE.reset(token)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` under the policy: in the compute dtype when one
    is set, else in x's dtype (counterpart of caster_dta_tpu Dense.__call__)."""
    dt = get_compute_dtype() or x.dtype
    return F.linear(x.to(dt), weight.to(dt), None if bias is None else bias.to(dt))


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout drawn from ``generator``; identity unless training."""
    if rate == 0.0 or not training:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class Dense(nn.Module):
    """Linear layer with torch.nn.Linear's default init drawn from an explicit
    generator: weight [out, in] and bias both U(-1/sqrt(in), 1/sqrt(in))."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        bound = 1.0 / math.sqrt(max(in_features, 1))
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        uniform_(self.weight, bound, generator)
        if bias:
            self.bias = nn.Parameter(torch.empty(out_features))
            uniform_(self.bias, bound, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm computed and returned in the promoted type of the input
    and the parameters, as flax's LayerNorm: f32 for a bf16 input and f32
    parameters; an f32 input is unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.promote_types(x.dtype, self.weight.dtype)))


class MLP(nn.Module):
    """PyG-style MLP([d0, ..., dk]): activation between layers, plain last
    (norm=None). Layers are ``lins.{i}``, as in the reference state dict."""

    def __init__(self, channels, act="relu", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = select_activation(act)
        self.lins = nn.ModuleList(Dense(channels[i], channels[i + 1], generator=generator)
                                  for i in range(len(channels) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.lins):
            x = lin(x)
            if i < len(self.lins) - 1:
                x = apply_act(self.act, x)
        return x
