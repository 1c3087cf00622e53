"""The kernel wrappers' launch counters, read and moved as one.

Each wrapper of ops/cuda_segment.py, ops/cuda_gvp_message.py and
ops/cuda_attention.py adds one to its ``LAUNCHES`` entry where it launches its
kernel from Python. Under CUDA graph capture that Python call records the
launch but runs nothing, and a replay runs every recorded launch with no
Python call. So a captured graph keeps the counts its capture added
(``since``), takes them back out (``add(delta, -1)``) and adds them again on
every replay (``add(delta)``): the counters then say what ran on the card.

Beside its count each wrapper adds the bytes of its launch to its ``BYTES``
entry (``bytes_snapshot``): the kernels' share of utils/traffic.py's count,
which a ``ctypes`` launch hides from PyTorch's dispatcher. A replay adds no
bytes: traffic is counted on an eager run.
"""
from __future__ import annotations

from caster_dta_torch.ops import cuda_attention, cuda_gvp_message, cuda_segment

COUNTERS = (cuda_segment.LAUNCHES, cuda_gvp_message.LAUNCHES, cuda_attention.LAUNCHES)
BYTE_COUNTERS = (cuda_segment.BYTES, cuda_gvp_message.BYTES, cuda_attention.BYTES)


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


def bytes_snapshot() -> dict:
    """The bytes every kernel's launches have read and written so far."""
    return {k: v for counter in BYTE_COUNTERS for k, v in counter.items()}


def reset() -> None:
    for counter in COUNTERS + BYTE_COUNTERS:
        for k in counter:
            counter[k] = 0
