#!/usr/bin/env python3
"""Host cost of one span (``caster_dta_torch.utils.profiling.annotate``):
the seconds of ``with annotate(name, value): pass`` less those of an empty
statement, the fastest of 7 repeats, with no profiler and under
torch.profiler (where each span also enters a ``record_function``). Where a
card is there its context is made first, so each span also pushes an NVTX
range, as on the card's hot paths.

    python3 scripts/span_cost.py [spans a repeat]

Prints one JSON line: the device (the card's name and power limit), the
microseconds a span without and with a profiler.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import timeit

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from caster_dta_torch.utils.profiling import annotate  # noqa: E402


def per_span_us(n: int) -> float:
    g = {"annotate": annotate}
    span = min(timeit.repeat("with annotate('cost.span', 5): pass", globals=g, number=n,
                             repeat=7))
    empty = min(timeit.repeat("pass", globals=g, number=n, repeat=7))
    return (span - empty) / n * 1e6


def main(n: int = 200_000) -> None:
    acts = [torch.profiler.ProfilerActivity.CPU]
    device = "cpu"
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        device = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True,
                                text=True).stdout.strip()
    off = per_span_us(n)
    with torch.profiler.profile(activities=acts):
        on = per_span_us(max(n // 20, 1))
    print(json.dumps({"device": device, "spans_a_repeat": n, "us_no_profiler": off,
                      "us_profiler": on}))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
