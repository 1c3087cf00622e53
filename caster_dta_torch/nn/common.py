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

Under data or graph parallelism each rank holds only some rows of a batch
(parallel/mesh.py). Dropout is then *global-canonical*: inside
``dropout_shards({dim: (index, count)})`` every mask is drawn from the shared
generator at the global size (``count`` times the local rows along ``dim``)
and this rank keeps its ``index``-th part (``keep_mask``), so a parallel run
applies exactly the masks of the single-device run.

``f32_precision`` is the matching scope for f32 math on the card: IEEE f32
matmuls and convolutions (no TF32) inside the block, the process's own
settings again after it. ``predict`` and every ``Trainer`` step and eval
enter it.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

class _LeakyReLU(torch.autograd.Function):
    """torch's leaky ReLU forward with jax.nn.leaky_relu's gradient, which is
    1 at x = 0 (``where(x >= 0, x, slope x)``) where torch's is the slope: a
    node with no incoming message and a zero bias sits exactly at 0."""

    @staticmethod
    def forward(ctx, x, negative_slope):
        ctx.save_for_backward(x)
        ctx.negative_slope = negative_slope
        return F.leaky_relu(x, negative_slope)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, g * ctx.negative_slope), None


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return _LeakyReLU.apply(x, negative_slope)


_ACTS: dict = {
    "relu": F.relu,
    "leaky_relu": leaky_relu,
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


@contextlib.contextmanager
def f32_precision() -> Iterator[None]:
    """IEEE f32 in cuBLAS matmuls and cuDNN convolutions for the ``with``
    block only: TF32 off on entry, the previous settings restored on exit.
    It uses PyTorch's ``fp32_precision`` settings, which read the legacy
    ``allow_tf32`` flags too and whose save and restore leave either API
    readable. ``TORCH_ALLOW_TF32_CUBLAS_OVERRIDE=1`` in the environment makes
    cuBLAS take TF32 whatever a process sets, so this cannot turn it off:
    leave that variable unset (chip_smoke.py removes it before torch is
    imported)."""
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    saved = (matmul.fp32_precision, conv.fp32_precision)
    matmul.fp32_precision = conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision, conv.fp32_precision = saved


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` under the policy: in the compute dtype when one
    is set, else in x's dtype (counterpart of caster_dta_tpu Dense.__call__)."""
    dt = get_compute_dtype() or x.dtype
    return F.linear(x.to(dt), weight.to(dt), None if bias is None else bias.to(dt))


_DROPOUT_SHARDS: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "caster_dta_torch_dropout_shards", default={})


@contextlib.contextmanager
def dropout_shards(shards: dict) -> Iterator[None]:
    """Inside the block every dropout mask is global-canonical: ``shards``
    maps a dim to ``(index, count)``, this rank's part and the number of
    parts of that dim (the JAX package's ``GVPDropout.shard_rows``, and for
    dim 0 the rows of a data-parallel batch). Adds to the shards in force."""
    token = _DROPOUT_SHARDS.set({**_DROPOUT_SHARDS.get(), **shards})
    try:
        yield
    finally:
        _DROPOUT_SHARDS.reset(token)


def keep_mask(shape, rate: float, generator: Optional[torch.Generator],
              device: torch.device, shards: Optional[dict] = None) -> torch.Tensor:
    """The bool keep-mask of ``shape`` (``rand >= rate``). With shards in
    force (``dropout_shards``, and ``shards`` on top), drawn at the global
    shape and sliced to this rank's part, so partitioning never changes it."""
    shards = {**_DROPOUT_SHARDS.get(), **(shards or {})}
    full, idx = list(shape), [slice(None)] * len(shape)
    for dim, (i, n) in shards.items():
        full[dim] = shape[dim] * n
        idx[dim] = slice(i * shape[dim], (i + 1) * shape[dim])
    keep = torch.rand(full, generator=generator, device=device) >= rate
    return keep[tuple(idx)] if shards else keep


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None,
            shards: Optional[dict] = None) -> torch.Tensor:
    """Inverted dropout drawn from ``generator`` (``keep_mask``, with
    ``shards`` on top of those in force); identity unless training."""
    if rate == 0.0 or not training:
        return x
    keep = keep_mask(x.shape, rate, generator, x.device, shards)
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
