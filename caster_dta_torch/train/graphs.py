"""CUDA graphs of the train step and the eval forward, one per bucket: the
card's counterpart of the JAX Trainer's ``lax.scan`` over a megabatch
(caster_dta_tpu/train/loop.py ``_build_train_scan``, ``_build_eval_scan``).

A step's inputs are one packed int32 row (``pack_rows``: the learning rate,
the accumulation divisor, then the batch's rows, targets and weights as
data/device_cache.pack_batch_rows lays them out). A
captured graph reads a static row of its own; ``CapturedStep.run`` copies the
step's row into it on the device and replays. The graph gathers the batch
from the bucket's stores, runs the step and writes its output into a static
tensor that stays valid until the next replay.

Every graph of a trainer shares one memory pool and one side stream, where the
eager warm-up steps run before a capture. The trainer's dropout generator is
registered with each train graph, so each replay draws the masks the next
eager step would. The kernel wrappers count their launches in Python; a
capture's counts are taken back and added again on every replay
(ops/launches.py). Nothing falls back: a failed capture or replay raises.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from caster_dta_torch.data.device_cache import (FIELD_ALIGN, field_words, pack_batch_rows,
                                                unpack_batch_rows)
from caster_dta_torch.ops import launches

# Eager steps a bucket runs before its train step is captured (PyTorch's
# rule: a backward is captured after a few iterations on a side stream). They
# are real steps: the bucket's first batches, in order.
WARMUP_STEPS = 2
EVAL_WARMUP_STEPS = 1


def row_width(b: int) -> int:
    """int32 words of one packed step row of batch size ``b``: a header of
    FIELD_ALIGN words, then the batch's four fields."""
    return FIELD_ALIGN + 4 * field_words(b)


def pack_rows(p_rows, m_rows, target, weight, lr=None, div=None) -> np.ndarray:
    """One int32 array [..., row_width(B)] of a step's (or k steps') inputs:
    the learning rate and the accumulation divisor (f32 bits, words 0 and 1),
    then from word FIELD_ALIGN the batch's ``pack_batch_rows``."""
    fields = pack_batch_rows(p_rows, m_rows, target, weight)
    out = np.zeros(fields.shape[:-1] + (FIELD_ALIGN + fields.shape[-1],), np.int32)
    for word, value in ((0, lr), (1, div)):
        if value is not None:
            out[..., word] = np.asarray(value, np.float32).view(np.int32)
    out[..., FIELD_ALIGN:] = fields
    return out


class StepInputs(NamedTuple):
    """Views of one packed row (``pack_rows``)."""

    lr: torch.Tensor        # f32 []
    div: torch.Tensor       # f32 []
    p_rows: torch.Tensor    # i32 [B]
    m_rows: torch.Tensor    # i32 [B]
    target: torch.Tensor    # f32 [B]
    weight: torch.Tensor    # f32 [B]


def unpack_row(row: torch.Tensor, b: int) -> StepInputs:
    """Views of a packed row [row_width(b)] of batch size ``b``."""
    f32 = torch.float32
    return StepInputs(row[0].view(f32), row[1].view(f32),
                      *unpack_batch_rows(row[FIELD_ALIGN:], b))


class CapturedStep:
    """One bucket's captured step in its variants (for the train step with
    gradient accumulation: accumulate only, False; accumulate and apply,
    True), each a graph and its static output, over one static input row."""

    def __init__(self, row: torch.Tensor, graphs: dict, outs: dict, counts: dict, keep):
        self.row = row
        self.graphs = graphs
        self.outs = outs
        self.launches = counts    # variant -> the kernel launches of one replay
        self._keep = keep         # the stores the graphs read, kept alive

    def run(self, row: torch.Tensor, variant: bool = True) -> torch.Tensor:
        """Copy a packed step row into the static row and replay ``variant``
        -> its static output."""
        self.row.copy_(row)
        return self.replay(variant)

    def replay(self, variant: bool = True):
        """Replay ``variant`` on what the static row holds -> its static
        output, valid until the next replay."""
        self.graphs[variant].replay()
        launches.add(self.launches[variant])
        return self.outs[variant]


class GraphCache:
    """A trainer's captured steps on ``device``, by key, with the pool and
    side stream they share."""

    def __init__(self, device: torch.device):
        self.device = device
        self._steps: dict = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    def get(self, key) -> Optional[CapturedStep]:
        return self._steps.get(key)

    def keys(self) -> list:
        """The keys of the captured steps, in capture order."""
        return list(self._steps)

    def _side(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    @contextlib.contextmanager
    def side_stream(self):
        """Run eager warm-up work on the capture stream, ordered after and
        before the current stream's work."""
        side, current = self._side(), torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            yield
        current.wait_stream(side)

    def capture(self, key, keep, width: int, bodies: dict,
                generator: Optional[torch.Generator] = None) -> CapturedStep:
        """Capture ``bodies`` (variant -> ``body(row) -> output tensor``) over
        one static int32 row of ``width`` words, register ``generator`` with
        each graph, and keep the result under ``key``."""
        side = self._side()
        row = torch.zeros(width, dtype=torch.int32, device=self.device)
        graphs, outs, counts = {}, {}, {}
        for variant, body in bodies.items():
            graph = torch.cuda.CUDAGraph()
            if generator is not None:
                register = getattr(graph, "register_generator_state", None)
                if register is None:
                    raise RuntimeError(f"torch {torch.__version__} cannot register the dropout "
                                       "generator with a CUDA graph (CUDAGraph."
                                       "register_generator_state)")
                register(generator)
            before = launches.snapshot()
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                outs[variant] = body(row)
            counts[variant] = launches.since(before)
            launches.add(counts[variant], -1)
            graphs[variant] = graph
        step = self._steps[key] = CapturedStep(row, graphs, outs, counts, keep)
        return step

