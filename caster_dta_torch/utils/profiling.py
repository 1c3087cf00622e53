"""Tracing and throughput instrumentation (counterpart of
caster_dta_tpu/utils/profiling.py).

``trace`` captures CPU and CUDA activity with ``torch.profiler`` into a
Chrome trace that TensorBoard's profiler plugin and Perfetto read;
``annotate`` is the port's span: it records the region into a process-wide
ring (``RING``, read by ``span_summary``), names it in the trace while a
profiler runs, and pushes an NVTX range on the card;
``ThroughputMeter`` keeps the training loop's edges/s and pairs/s;
``StepTimer`` sums host wall time by section.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from array import array
from typing import Optional

import numpy as np
import torch

# spans the ring keeps: about 1.8 MB of arrays; some 10 minutes of an
# explained screen's spans (~100 a second), half an hour of training's
RING_SIZE = 65536
NO_VALUE = -1


def _on_card() -> bool:
    """Whether this process has put work on the card."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/tb'): run_steps()`` writes
    ``<worker>.<time>.pt.trace.json`` into ``log_dir``: CPU activity, and
    CUDA activity where there is a card. Yields the profiler, whose
    ``key_averages()`` sums the trace by op and kernel."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class SpanRing:
    """The latest ``size`` spans of a process: each its name, start and end
    on ``time.perf_counter_ns``'s clock (``time.perf_counter``'s, in ns) and
    an int value (NO_VALUE: none), in preallocated arrays. A new span takes
    the oldest one's place once the ring is full; ``lost(t0)`` says whether
    a span that ended at or after ``t0`` was overwritten so."""

    def __init__(self, size: int = RING_SIZE):
        self.size = size
        self.names: list = []               # name id -> name
        self._ids: dict = {}
        self._name = array("i", bytes(4 * size))
        self._start = array("q", bytes(8 * size))
        self._end = array("q", bytes(8 * size))
        self._value = array("q", bytes(8 * size))
        self._seq = itertools.count()       # next() is atomic: no slot is taken twice
        self._lock = threading.Lock()
        self.recorded = 0
        self._lost_end: Optional[int] = None   # end of the newest overwritten span

    def record(self, name: str, start_ns: int, end_ns: int, value: int = NO_VALUE) -> None:
        nid = self._ids.get(name)
        if nid is None:
            nid = self._intern(name)
        i = next(self._seq)
        k = i % self.size
        if i >= self.size:
            old = self._end[k]
            if self._lost_end is None or old > self._lost_end:
                self._lost_end = old
        self._name[k] = nid
        self._start[k] = start_ns
        self._end[k] = end_ns
        self._value[k] = value
        self.recorded = i + 1

    def _intern(self, name: str) -> int:
        with self._lock:
            nid = self._ids.get(name)
            if nid is None:
                nid = self._ids[name] = len(self.names)
                self.names.append(name)
            return nid

    @property
    def overwritten(self) -> int:
        """Spans written over since the ring was made."""
        return max(0, self.recorded - self.size)

    def lost(self, t0: Optional[float] = None) -> bool:
        """Whether a span that ended at or after ``t0`` (seconds on
        ``time.perf_counter``'s clock; None: any span) was overwritten."""
        return self._lost_end is not None and (t0 is None or self._lost_end >= _ns(t0))

    def records(self, t0: Optional[float] = None, t1: Optional[float] = None) -> list:
        """(name, start s, end s, value) of the kept spans that start at or
        after ``t0`` and end at or before ``t1`` (``time.perf_counter``
        seconds; None: no limit), by start."""
        n = min(self.recorded, self.size)
        start = np.frombuffer(self._start, np.int64)[:n]
        end = np.frombuffer(self._end, np.int64)[:n]
        keep = np.ones(n, bool)
        if t0 is not None:
            keep &= start >= _ns(t0)
        if t1 is not None:
            keep &= end <= _ns(t1)
        idx = np.flatnonzero(keep)
        idx = idx[np.argsort(start[idx], kind="stable")]
        name = np.frombuffer(self._name, np.int32)[idx].tolist()
        value = np.frombuffer(self._value, np.int64)[idx].tolist()
        return [(self.names[nid], s, e, v) for nid, s, e, v in
                zip(name, (start[idx] / 1e9).tolist(), (end[idx] / 1e9).tolist(), value)]

    def summary(self, t0: Optional[float] = None, t1: Optional[float] = None) -> dict:
        """{name: {"count", "total_s", "mean_ms", "p95_ms"}} of ``records(t0,
        t1)``, names sorted."""
        by_name: dict = {}
        for name, s, e, _ in self.records(t0, t1):
            by_name.setdefault(name, []).append(e - s)
        return {name: {"count": len(d), "total_s": float(np.sum(d)),
                       "mean_ms": float(np.mean(d) * 1e3),
                       "p95_ms": float(np.percentile(d, 95) * 1e3)}
                for name, d in sorted(by_name.items())}


def _ns(t: float) -> int:
    return int(round(t * 1e9))


# The process's spans: every ``annotate`` writes here.
RING = SpanRing()


def span_summary(t0: Optional[float] = None, t1: Optional[float] = None) -> dict:
    """Per span name of the process's ring: count, total seconds, mean and
    95th-percentile milliseconds, over the spans kept or those inside
    [t0, t1] (``time.perf_counter`` seconds)."""
    return RING.summary(t0, t1)


_CARD = [False]     # this process has put work on the card: it stays so
_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns
_nvtx_push, _nvtx_pop = torch.cuda.nvtx.range_push, torch.cuda.nvtx.range_pop


class annotate:
    """A span: ``with annotate("inference.fetch"): ...``, or with a value,
    ``with annotate("train.replay", nodes):`` or ``as span: ...; span.value
    = n``. It records (name, start, end, value) into ``RING``, enters
    ``record_function(name)`` while a torch profiler runs (so the trace's
    timeline holds it beside the device's operations), and pushes an NVTX
    range where the process uses the card. It launches nothing: it may wrap
    a graph replay, but never sits inside a captured body."""

    __slots__ = ("name", "value", "_t0", "_rf", "_nvtx")

    def __init__(self, name: str, value: int = NO_VALUE):
        self.name = name
        self.value = value

    def __enter__(self) -> "annotate":
        nvtx = self._nvtx = _CARD[0] or _card_now()
        if nvtx:
            _nvtx_push(self.name)
        self._rf = None
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        RING.record(self.name, self._t0, _clock(), self.value)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._nvtx:
            _nvtx_pop()
        return False


def _card_now() -> bool:
    _CARD[0] = torch.cuda.is_initialized()
    return _CARD[0]


class ThroughputMeter:
    """Windowed edges/s and pairs/s of the training steps (wall clock).

    Call ``step(n_edges, n_pairs)`` once per step. Steps are queued on the
    card without waiting, so per-step boundaries are approximate; the totals
    are exact."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t: list = []
        self._edges: list = []
        self._pairs: list = []
        self._t0: Optional[float] = None
        self.total_edges = self.total_pairs = self.total_steps = 0

    def step(self, n_edges: int, n_pairs: int) -> None:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        self.total_edges += int(n_edges)
        self.total_pairs += int(n_pairs)
        self.total_steps += 1
        self._t.append(now)
        self._edges.append(int(n_edges))
        self._pairs.append(int(n_pairs))
        if len(self._t) > self.window + 1:
            self._t.pop(0), self._edges.pop(0), self._pairs.pop(0)

    def _rate(self, counts: list) -> float:
        dt = self._t[-1] - self._t[0] if len(self._t) >= 2 else 0.0
        return float(sum(counts[1:]) / dt) if dt > 0 else 0.0

    @property
    def edges_per_s(self) -> float:
        """Windowed edges/s (0 until two steps are recorded)."""
        return self._rate(self._edges)

    @property
    def pairs_per_s(self) -> float:
        return self._rate(self._pairs)

    def summary(self) -> dict:
        """The JAX package's keys (``steps``, ``wall_s`` from the first step
        to the last, the windowed rates, the totals) and ``total_steps``."""
        wall = self._t[-1] - self._t0 if self._t else 0.0
        return {"steps": self.total_steps, "wall_s": wall, "edges_per_s": self.edges_per_s,
                "pairs_per_s": self.pairs_per_s, "total_edges": self.total_edges,
                "total_pairs": self.total_pairs, "total_steps": self.total_steps}


class StepTimer:
    """Per-section wall timer for coarse host-side breakdowns (data loading
    against the step against logging). Blocking, as the JAX package's: where
    the process uses the card, a section waits for the current stream's work
    before it stops its clock, so the section's time includes the work it
    queued."""

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if _on_card():
                torch.cuda.current_stream().synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        """{section: {"total_s", "calls", "mean_ms"}}, sections sorted."""
        return {k: {"total_s": v, "calls": self.counts[k], "mean_ms": 1e3 * v / self.counts[k]}
                for k, v in sorted(self.totals.items())}
