"""The kernel wrappers' launch counters, read and moved as one.

Each wrapper of ops/cuda_segment.py, ops/cuda_gvp_message.py and
ops/cuda_attention.py adds one to its ``LAUNCHES`` entry where it launches its
kernel from Python. Under CUDA graph capture that Python call records the
launch but runs nothing, and a replay runs every recorded launch with no
Python call. So a captured graph keeps the counts its capture added
(``since``), takes them back out (``add(delta, -1)``) and adds them again on
every replay (``add(delta)``): the counters then say what ran on the card.
"""
from __future__ import annotations

from caster_dta_torch.ops import cuda_attention, cuda_gvp_message, cuda_segment

COUNTERS = (cuda_segment.LAUNCHES, cuda_gvp_message.LAUNCHES, cuda_attention.LAUNCHES)


def snapshot() -> dict:
    """Every kernel's count now, as one dict."""
    return {k: v for counter in COUNTERS for k, v in counter.items()}


def since(before: dict) -> dict:
    """The counts added since ``before`` (a ``snapshot``), kernels that did
    not launch left out."""
    return {k: v - before[k] for k, v in snapshot().items() if v != before[k]}


def add(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counters (negative ``times`` takes
    them back)."""
    for counter in COUNTERS:
        for k in counter.keys() & delta.keys():
            counter[k] += times * delta[k]


def reset() -> None:
    for counter in COUNTERS:
        for k in counter:
            counter[k] = 0
