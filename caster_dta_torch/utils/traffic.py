"""Op-boundary memory traffic of a run (the counterpart of
caster_dta_tpu/utils/hlo_traffic.py).

The JAX package sums operand and result bytes over the top-level
instructions of XLA's optimized HLO, where each fusion reads its operands
from HBM and writes its result back. The port has no HLO: each aten op is
its own kernel. So the count here is taken at the port's own boundaries: a
``TorchDispatchMode`` sees every aten op that runs, forward and backward,
and counts its tensor operands read once and its results written once.

- Metadata-only ops move no data and count 0, as the JAX module skips
  parameter, constant, bitcast, tuple and get-tuple-element: views
  (``expand``, ``t``/``transpose``, ``slice``/``select``, ``as_strided``,
  ``detach``, ``alias``, ``view``/``_unsafe_view``, ...) and allocations
  (``empty``, ``empty_like``, ...), which write nothing.
- A hand-written kernel launched through ``ctypes`` is invisible to the
  dispatcher. Each wrapper in ops/cuda_*.py adds the bytes of its launch
  (inputs read once, outputs written once) beside its launch count
  (ops/launches.py ``bytes_snapshot``); the counter adds those under the
  kernel's name. On the CPU a wrapper runs its plain version, whose aten ops
  the dispatch mode counts instead.

It is an estimate and an upper bound on HBM bytes: an operand that the
caches keep between two ops, an in-place result and a view's repeated
reads are counted as full traffic, so a bandwidth share computed against it
is a lower bound. It counts an eager run: under a CUDA graph replay no
Python runs and nothing is dispatched, so count the eager step that the
graph was captured from, which runs the same kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from caster_dta_torch.ops import launches

# ops that allocate or re-describe a buffer without moving its bytes, beside
# every op whose schema marks it a view (OpOverload.is_view)
FREE_OPS = frozenset({
    "aten._unsafe_view", "aten._reshape_alias", "aten.alias", "aten.lift_fresh",
    "aten.empty", "aten.empty_like", "aten.empty_strided", "aten.new_empty",
    "aten.new_empty_strided", "aten.detach", "aten.as_strided",
})


def shape_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of an array of ``shape`` and ``dtype`` (a scalar: one element)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


class TrafficCounter(TorchDispatchMode):
    """``with TrafficCounter() as c: run()`` -> ``c.per_op`` (op or kernel
    name -> bytes) and ``c.total``. Free ops are listed with 0 bytes."""

    def __init__(self):
        super().__init__()
        self.per_op: Dict[str, int] = {}
        self._kernels_before: dict = {}

    def __enter__(self):
        self._kernels_before = launches.bytes_snapshot()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        for name, n in launches.bytes_snapshot().items():
            moved = n - self._kernels_before.get(name, 0)
            if moved:
                self.per_op[name] = self.per_op.get(name, 0) + moved
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket)
        if func.is_view or name in FREE_OPS:
            moved = 0
        else:
            moved = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        self.per_op[name] = self.per_op.get(name, 0) + moved
        return out

    @property
    def total(self) -> int:
        return sum(self.per_op.values())


def op_traffic(fn: Callable, *args, **kwargs) -> Tuple[int, Dict[str, int]]:
    """Run ``fn(*args, **kwargs)`` once, eagerly -> (total bytes, bytes by op
    or kernel name): the estimate of HBM bytes for one execution."""
    with TrafficCounter() as counter:
        fn(*args, **kwargs)
    return counter.total, dict(counter.per_op)
