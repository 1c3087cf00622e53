"""Shared arithmetic of the metric readers under metrics/: each reader is a
file of its own that calls one of these on the run's context. A reader
returns None when its run holds nothing for it to read; a share of a peak
or a roofline is never made up as 0."""
from __future__ import annotations

import os

import numpy as np

from benchlib.peaks import PEAKS
from benchlib.probe import kernel_seconds
from benchlib.spec import BENCH_DIR


def rate(ctx, runner: str, count: str = "pairs"):
    """Work of the whole window over the window's seconds."""
    if ctx.cell.mix["runner"] != runner or not ctx.measure.get("window_s"):
        return None
    return ctx.measure[count] / ctx.measure["window_s"]


def percentile_ms(ctx, key: str, q: float):
    xs = ctx.measure.get(key)
    return None if not xs else float(np.percentile(np.asarray(xs) * 1e3, q))


def mean_ms(ctx, key: str):
    xs = ctx.measure.get(key)
    return None if not xs else float(np.mean(xs) * 1e3)


def idle_pct(ctx, runner: str):
    s = ctx.trace.get("slice")
    if s is None or ctx.cell.mix["runner"] != runner or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def mfu_pct(ctx, runner: str):
    s = ctx.trace.get("slice")
    if s is None or ctx.cell.mix["runner"] != runner or not ctx.trace.get("flops"):
        return None
    return 100.0 * ctx.trace["flops"] / (s["window_s"] * ctx.trace["peak_flops"])


def kernel_names(list_file: str) -> list:
    with open(os.path.join(BENCH_DIR, "metrics", list_file)) as f:
        return [line.strip() for line in f if line.strip() and not line.startswith("#")]


def roofline_pct(ctx, runner: str, list_file: str):
    """The bytes the slice's operations need at the peak bandwidth, over the
    device time of the kernels that list_file names."""
    s = ctx.trace.get("slice")
    if s is None or ctx.cell.mix["runner"] != runner or not ctx.trace.get("seg_bytes"):
        return None
    t = kernel_seconds(s, kernel_names(list_file))
    if t <= 0:
        return None
    return 100.0 * ctx.trace["seg_bytes"] / PEAKS["hbm_bytes_per_s"] / t
