#!/usr/bin/env python3
"""Where two CPU answers that chip_smoke.cpu_reference kept differ.

    python3 scripts/cpu_reference_diff.py chip_smoke_out/cpu_reference_<what>.pt

``cpu_reference`` writes the first two CPU runs of a reference to
``$CHIP_SMOKE_OUT`` when their bits differ. For answers that are
run_model_on_dataset records (or a tuple whose first part is), prints each
column whose cells differ, the rows (pair_idx) where they do and the largest
difference there; for tensors, the largest difference of each.
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def main(path: str) -> int:
    kept = torch.load(path, weights_only=False)
    first, second = kept["first"], kept["second"]
    if isinstance(first, tuple):
        first, second = first[0], second[0]
    print(f"{kept['what']}: first run against second")
    if not isinstance(first, dict):
        for i, (a, b) in enumerate(zip(first, second)):
            d = (a.double() - b.double()).abs().max().item()
            print(f"  part {i}: max|d| {d:.3e}")
        return 0
    rows = first.get("pair_idx", range(len(next(iter(first.values())))))
    for column in first:
        where, worst = [], 0.0
        for p, a, b in zip(rows, first[column], second[column]):
            if a is None or isinstance(a, str):
                if a != b:
                    where.append(p)
                continue
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            if a.shape != b.shape or not np.array_equal(a, b):
                where.append(p)
                if a.shape == b.shape:
                    worst = max(worst, float(np.abs(a - b).max()))
        if where:
            print(f"  {column}: pairs {where}, max|d| {worst:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
