"""The comparisons that decide ``correct``: gaps between what the program's
timed path produced and the plain reference's answer for the same inputs."""
from __future__ import annotations

import numpy as np


def rel_gap(prog, ref) -> float:
    """max |prog - ref| / |ref| over paired numbers."""
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(p - r) / np.maximum(np.abs(r), 1e-30)))


def leaf_gaps(prog: dict, ref: dict) -> np.ndarray:
    """Each leaf's gap between two norms of it, against the reference's norm
    of that leaf or of the median leaf, whichever is larger (some gradients
    are all but zero)."""
    names = sorted(ref)
    r = np.array([ref[n] for n in names], np.float64)
    p = np.array([prog[n] for n in names], np.float64)
    floor = max(float(np.median(r)), 1e-30)
    return np.abs(p - r) / np.maximum(r, floor)


def worst_leaf(prog: dict, ref: dict) -> float:
    return float(np.max(leaf_gaps(prog, ref)))


def median_leaf(prog: dict, ref: dict) -> float:
    return float(np.median(leaf_gaps(prog, ref)))


def moved_entries(grad: dict, share: float = 1e-3) -> dict:
    """leaf -> bool mask of the entries whose reference gradient is not
    nought to rounding: at least ``share`` of the median leaf's RMS
    gradient. (A key's bias under softmax has no gradient; Adam moves it by
    round-off alone, on either side.)"""
    rms = [float(g.norm()) / max(g.numel(), 1) ** 0.5 for g in grad.values()]
    floor = share * float(np.median(rms))
    return {k: g.abs() >= floor for k, g in grad.items()}


def masked_norms(tensors: dict, masks: dict) -> dict:
    """Each leaf's norm over its masked entries, for leaves with any entry."""
    return {k: float(t[masks[k]].norm()) for k, t in tensors.items() if bool(masks[k].any())}


def max_abs(pairs) -> float:
    """max |a - b| over (a, b) array pairs; inf where shapes differ."""
    out = 0.0
    for a, b in pairs:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape:
            return float("inf")
        if a.size:
            out = max(out, float(np.max(np.abs(a - b))))
    return out
