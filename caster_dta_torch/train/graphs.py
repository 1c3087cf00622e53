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
(ops/launches.py). At the end of each capture the graph's nodes that do
device work (kernel, memcpy and memset nodes) are counted, through the CUDA
driver, and kept beside the launches: the device operations of one replay.
Nothing falls back: a failed capture or replay raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from caster_dta_torch.data.device_cache import (FIELD_ALIGN, field_words, pack_batch_rows,
                                                unpack_batch_rows)
from caster_dta_torch.nn import gvp
from caster_dta_torch.ops import launches
from caster_dta_torch.utils.profiling import annotate

# Eager steps a bucket runs before its train step is captured (PyTorch's
# rule: a backward is captured after a few iterations on a side stream). They
# are real steps: the bucket's first batches, in order.
WARMUP_STEPS = 2
EVAL_WARMUP_STEPS = 1


def model_path(model: torch.nn.Module) -> tuple:
    """What a captured graph of ``model`` fixes besides the shapes: the GVP
    switches in force (fused message, remat) and each attention module's
    ``use_pallas``."""
    return (gvp.switches(),
            tuple(m.use_pallas for m in model.modules() if hasattr(m, "use_pallas")))


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


# CUgraphNodeType (cuda.h), by value; DEVICE_NODE_TYPES are those that do work
# on the device (the captures here hold only these, PERF.md)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
              6: "wait_event", 7: "event_record", 8: "ext_semas_signal",
              9: "ext_semas_wait", 10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
              13: "conditional"}
DEVICE_NODE_TYPES = ("kernel", "memcpy", "memset")


@functools.cache
def _driver() -> ctypes.CDLL:
    """The CUDA driver library this process runs on (one a process: its
    stream and graph handles are the runtime's)."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuStreamGetCaptureInfo_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.cuStreamGetCaptureInfo_v2, lib.cuGraphGetNodes, lib.cuGraphNodeGetType):
        fn.restype = ctypes.c_int
    return lib


def _check(result: int, call: str) -> None:
    if result != 0:
        raise RuntimeError(f"{call} failed with CUresult {result}")


def capture_node_types(stream: torch.cuda.Stream) -> dict:
    """{node type: count} of the graph that ``stream`` is capturing into, as
    it stands (NODE_TYPES' names). Called inside the capture, after the
    body: it reads the graph and adds nothing to it."""
    lib = _driver()
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    _check(lib.cuStreamGetCaptureInfo_v2(ctypes.c_void_p(stream.cuda_stream),
                                         ctypes.byref(status), None, ctypes.byref(graph), None,
                                         None), "cuStreamGetCaptureInfo_v2")
    if status.value != 1:       # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError(f"the stream is not capturing (status {status.value})")
    n = ctypes.c_size_t()
    _check(lib.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out: dict = {}
    kind = ctypes.c_int()
    for node in nodes[:n.value]:
        _check(lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
        name = NODE_TYPES.get(kind.value, str(kind.value))
        out[name] = out.get(name, 0) + 1
    return out


class CapturedStep:
    """One bucket's captured step in its variants (for the train step with
    gradient accumulation: accumulate only, False; accumulate and apply,
    True), each a graph and its static output, over one static input row."""

    def __init__(self, row: torch.Tensor, graphs: dict, outs: dict, counts: dict, keep,
                 nodes: Optional[dict] = None):
        self.row = row
        self.graphs = graphs
        self.outs = outs
        self.launches = counts    # variant -> the kernel launches of one replay
        self.nodes = nodes or {}  # variant -> its graph's device operations (DEVICE_NODE_TYPES)
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
        graphs, outs, counts, nodes = {}, {}, {}, {}
        with annotate("graph.capture") as span:
            for variant, body in bodies.items():
                graph = torch.cuda.CUDAGraph()
                if generator is not None:
                    register = getattr(graph, "register_generator_state", None)
                    if register is None:
                        raise RuntimeError(f"torch {torch.__version__} cannot register the "
                                           "dropout generator with a CUDA graph (CUDAGraph."
                                           "register_generator_state)")
                    register(generator)
                before = launches.snapshot()
                with torch.cuda.graph(graph, pool=self._pool, stream=side):
                    outs[variant] = body(row)
                    types = capture_node_types(side)
                counts[variant] = launches.since(before)
                launches.add(counts[variant], -1)
                nodes[variant] = sum(types.get(t, 0) for t in DEVICE_NODE_TYPES)
                graphs[variant] = graph
            span.value = sum(nodes.values())
        step = self._steps[key] = CapturedStep(row, graphs, outs, counts, keep, nodes)
        return step

