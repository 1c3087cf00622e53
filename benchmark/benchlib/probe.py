"""What the benchmark reads of a traced run, from its own files: a
profiled slice of the window (torch.profiler, bounded to a few steps or
batches) reduced to device busy time, kernel time by name and the idle
gaps; and the bytes each captured graph's segment operations need, taken
from the op layer's call shapes while the graph is captured."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch


class OpBytes:
    """Wraps the port's segment entry points (caster_dta_torch.ops.
    cuda_segment: gather_rows K2, segment_sum_sorted K1, scatter_rows K3)
    and, while a CUDA graph is being captured, adds to ``bytes[key]`` what
    each call needs: its inputs read once and its output written once. The
    runner sets ``key`` to the step or batch being captured."""

    NAMES = ("gather_rows", "segment_sum_sorted", "scatter_rows")

    def __init__(self):
        self.key = None
        self.bytes: dict = defaultdict(int)
        self._saved: dict = {}

    def _wrap(self, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.key is not None and torch.cuda.is_current_stream_capturing():
                tensors = [a for a in args if isinstance(a, torch.Tensor)] + [out]
                self.bytes[self.key] += sum(t.numel() * t.element_size() for t in tensors)
            return out
        return wrapped

    def install(self) -> None:
        from caster_dta_torch.ops import cuda_segment

        for name in self.NAMES:
            self._saved[name] = getattr(cuda_segment, name)
            setattr(cuda_segment, name, self._wrap(self._saved[name]))

    def remove(self) -> None:
        from caster_dta_torch.ops import cuda_segment

        for name, fn in self._saved.items():
            setattr(cuda_segment, name, fn)
        self._saved.clear()


class Slice:
    """A profiled slice: ``start()`` and ``stop()`` synchronise the card
    and bracket a torch.profiler session; ``summary`` holds what it read."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.summary = None
        self.active = False
        self.done = False

    def start(self) -> None:
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.active = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.active, self.done = False, True

    def finish(self) -> None:
        """Read the trace (after the window: reading it takes seconds)."""
        if self.done and self.summary is None:
            self.summary = summarize(self.prof, self.t1 - self.t0)
            self.prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        """A named host span in the trace (record_function) while profiling."""
        if self.active:
            with torch.profiler.record_function(name):
                yield
        else:
            yield


def _union(intervals: np.ndarray) -> tuple:
    """Merged [start, end] intervals -> (their total length, the merged list)."""
    if len(intervals) == 0:
        return 0.0, intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    m = np.array(merged)
    return float((m[:, 1] - m[:, 0]).sum()), m


def summarize(prof, window_s: float, top: int = 10, gaps_examined: int = 400) -> dict:
    """busy seconds (union of device operations), device seconds by name,
    the window, and the idle gaps named by the innermost host operation
    running at their middle."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if getattr(e, "is_user_annotation", False):
            continue            # a host span mirrored on the device, not an operation
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU and tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    by_name: dict = defaultdict(float)
    for s, e, n in dev:
        by_name[n] += (e - s) * 1e-6
    iv = np.array([(s, e) for s, e, _ in dev], float).reshape(-1, 2)
    busy_us, merged = _union(iv)
    gaps: dict = defaultdict(float)
    if len(merged) > 1 and host:
        g = np.stack([merged[:-1, 1], merged[1:, 0]], 1)
        g = g[np.argsort(g[:, 0] - g[:, 1])][:gaps_examined]
        hs = np.array([h[0] for h in host])
        he = np.array([h[1] for h in host])
        names = [h[2] for h in host]
        for a, b in g:
            mid = 0.5 * (a + b)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = ("no host op" if not len(inside) else
                    names[inside[np.argmin(he[inside] - hs[inside])]])
            gaps[name] += (b - a) * 1e-6
    return {"busy_s": busy_us * 1e-6, "window_s": window_s, "kernel_s": dict(by_name),
            "n_device_ops": len(dev),
            "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:top],
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:top]}


def kernel_seconds(summary: dict, patterns) -> float:
    """Device seconds of the operations whose name holds one of ``patterns``."""
    return sum(s for n, s in summary["kernel_s"].items() if any(p in n for p in patterns))
