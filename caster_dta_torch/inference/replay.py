"""The served forward on the card as CUDA-graph replays, one graph per bucket
and model path, fed from pinned host buffers: the port's counterpart of the
JAX package's ``jax.jit`` of the forward (caster_dta_tpu/inference/
evaluation.py:28-30).

A request's two padded graph batches go into one int32 row (``BatchLayout``:
each GraphBatch field's bytes from a multiple of FIELD_ALIGN words), packed
on the host into a pinned buffer of the bucket and copied to the card in one
non-blocking transfer. The first request of a bucket and path runs the
forward eagerly on the capture stream (its answer is returned; it also makes
K4's counter buffer, which a capture cannot make) and then captures it
(train/graphs.py ``GraphCache``); every later request replays. Each answer
is a copy of the graph's static outputs, so a later replay cannot overwrite
an answer already given. Launch counts stay countable: a replay adds its
capture's counts (ops/launches.py). A request is two spans: ``inference.pack``
(the layout, the wait for the buffer's last copy, the packing) and
``inference.forward`` (the copy to the card, the replay, the answer's
copies), whose value is the replayed graph's device operations (-1 where
the forward ran eagerly). Nothing falls back: a failed capture or replay
raises.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch

from caster_dta_torch.data.device_cache import FIELD_ALIGN
from caster_dta_torch.data.graphs import GraphBatch
from caster_dta_torch.nn.common import f32_precision
from caster_dta_torch.train.graphs import GraphCache, model_path
from caster_dta_torch.utils.profiling import annotate

_FIELDS = tuple(f.name for f in dataclasses.fields(GraphBatch))


class BatchLayout:
    """Where each field of a (protein, molecule) pair of GraphBatches lies in
    one int32 row: its bytes from a multiple of FIELD_ALIGN words. Built from
    an example pair; ``key`` is every field's dtype and shape."""

    def __init__(self, protein: GraphBatch, molecule: GraphBatch):
        self.fields = []        # (side, name, dtype, shape, first word, bytes)
        pos = 0
        for side, graph in (("protein", protein), ("molecule", molecule)):
            for name in _FIELDS:
                t = getattr(graph, name)
                nbytes = t.numel() * t.element_size()
                self.fields.append((side, name, t.dtype, tuple(t.shape), pos, nbytes))
                pos += -(-nbytes // (4 * FIELD_ALIGN)) * FIELD_ALIGN
        self.width = pos
        self.key = tuple((side, name, str(dt), shape) for side, name, dt, shape, _, _ in self.fields)

    def views(self, row: torch.Tensor) -> tuple:
        """(protein, molecule) GraphBatches whose fields are views of ``row``."""
        out = {"protein": {}, "molecule": {}}
        for side, name, dtype, shape, start, nbytes in self.fields:
            words = row[start:start + -(-nbytes // 4)]
            out[side][name] = words.view(torch.uint8)[:nbytes].view(dtype).view(shape)
        return GraphBatch(**out["protein"]), GraphBatch(**out["molecule"])

    def pack(self, row: torch.Tensor, protein: GraphBatch, molecule: GraphBatch) -> None:
        """Copy the pair's fields into ``row`` (host into host, or device into
        device: queued on the current stream)."""
        for dst_graph, src_graph in zip(self.views(row), (protein, molecule)):
            for name in _FIELDS:
                getattr(dst_graph, name).copy_(getattr(src_graph, name))


def forward(model: torch.nn.Module, protein: GraphBatch, molecule: GraphBatch) -> tuple:
    """The served forward, f32 end to end -> (score [B], residues->atoms
    [B, R, A] or None, atoms->residues [B, A, R] or None): the first
    cross-attention layer's maps, None on the blockwise path."""
    with torch.no_grad(), f32_precision():
        score, attn = model(protein, molecule)
    return (score[:, 0],) + tuple(attn[0])


class ReplayedForward:
    """The served forward of ``model`` (on the card) as CUDA-graph replays,
    one per bucket and model path, each with a pinned host buffer."""

    def __init__(self, model: torch.nn.Module):
        self._model = weakref.ref(model)
        self.device = next(model.parameters()).device
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need the model on the card, not {self.device}")
        self.graphs = GraphCache(self.device)
        self._staging: dict = {}    # key -> (layout, pinned row, copy-done event)
        self.replays = 0

    def __call__(self, protein: GraphBatch, molecule: GraphBatch) -> tuple:
        """Answer one request (its graphs on the host) -> (outputs as
        ``forward`` gives them, copied; the request's graphs on the card,
        views valid until the next call)."""
        model = self._model()
        with annotate("inference.pack"):
            layout, key = self._key(protein, molecule)
            if key not in self._staging:
                pinned = torch.empty(layout.width, dtype=torch.int32, pin_memory=True)
                self._staging[key] = (layout, pinned, torch.cuda.Event())
            layout, pinned, copied = self._staging[key]
            copied.synchronize()            # the last request's copy has left the buffer
            layout.pack(pinned, protein, molecule)
        step = self.graphs.get(key)
        with annotate("inference.forward") as span:
            if step is None:
                row = pinned.to(self.device, non_blocking=True)
                copied.record()
                with annotate("graph.warmup"), self.graphs.side_stream():
                    out = forward(model, *layout.views(row))
                self.graphs.capture(key, None, layout.width,
                                    {True: lambda r: forward(model, *layout.views(r))})
                return out, layout.views(row)
            span.value = step.nodes[True]
            step.row.copy_(pinned, non_blocking=True)
            copied.record()
            out = step.replay()
            self.replays += 1
            return tuple(None if t is None else t.clone() for t in out), layout.views(step.row)

    def _key(self, protein: GraphBatch, molecule: GraphBatch) -> tuple:
        layout = BatchLayout(protein, molecule)
        return layout, (layout.key, model_path(self._model()))

    def staged(self, protein: GraphBatch, molecule: GraphBatch) -> tuple:
        """(layout, pinned host row, captured step or None) of the request's
        bucket on the model's current path; None before its first request."""
        layout, key = self._key(protein, molecule)
        if key not in self._staging:
            return None
        return layout, self._staging[key][1], self.graphs.get(key)


_REPLAYED: "weakref.WeakKeyDictionary[torch.nn.Module, ReplayedForward]" = \
    weakref.WeakKeyDictionary()


def replayed_forward(model: torch.nn.Module) -> ReplayedForward:
    """The model's ReplayedForward, made at first use and kept while the
    model lives."""
    if model not in _REPLAYED:
        _REPLAYED[model] = ReplayedForward(model)
    return _REPLAYED[model]
