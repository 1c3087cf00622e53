"""Tracing and throughput instrumentation (counterpart of
caster_dta_tpu/utils/profiling.py).

``trace`` captures CPU and CUDA activity with ``torch.profiler`` into a
Chrome trace that TensorBoard's profiler plugin and Perfetto read;
``annotate`` names a region in that trace (and, on the card, an NVTX range);
``ThroughputMeter`` keeps the training loop's edges/s and pairs/s;
``StepTimer`` sums host wall time by section.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


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


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the trace timeline (``record_function``), and an
    NVTX range where the process uses the card."""
    nvtx = _on_card()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
