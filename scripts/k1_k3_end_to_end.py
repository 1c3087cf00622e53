#!/usr/bin/env python3
"""End-to-end times of several versions of ``segment.cu`` (K1, K2, K3) side
by side in one process, on the card: the replayed flagship request and the
explainer's seconds a batch on the replayed fused evaluate path.

    python3 scripts/k1_k3_end_to_end.py --source A.cu --tag a --source B.cu --tag b \
        [--rounds 2] [--requests 20]

Each version is built with nvcc (``ops/build.py``, keyed by content) from a
directory ``caster_dta_torch/_build/e2e/<tag>/`` holding it beside the
repo's other sources, and swapped in as ``cuda_segment``'s library. Then, in
turns (a, b, b, a; ``--rounds`` of them), with ``runs/davis_seed9`` loaded on
the card afresh for each turn (its CUDA graphs are per model):

- the flagship request (``chip_smoke.FLAGSHIP``, seed 0) served by
  ``predict``: the first call captures, then the median host time of
  ``--requests`` replays, each synchronised;
- the evaluate phase's data (``chip_smoke.EVAL_PAIRS`` pairs of
  ``chip_smoke.EVAL_DATA`` in batches of ``chip_smoke.EVAL_BATCH``) through
  ``evaluate_batches`` on the fused path with the explainer (a first run
  captures, the second replays) and without it: the explainer's seconds a
  batch, (with - without) / batches, as ``chip_smoke.py``'s evaluate phase
  reports it. The records of every version must be the first version's bit
  for bit.

The kernels are latency-bound microseconds, so these are readings, not a
claim. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import os
import shutil
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (sizes, nvidia-smi)
from caster_dta_torch.data.batching import (BucketedLoader, synthetic_pair_batch,  # noqa: E402
                                            synthetic_pair_dataset)
from caster_dta_torch.inference.evaluation import evaluate_batches  # noqa: E402
from caster_dta_torch.inference.serve import load_run, predict  # noqa: E402
from caster_dta_torch.nn import gvp  # noqa: E402
from caster_dta_torch.ops import build  # noqa: E402
from caster_dta_torch.ops import cuda_segment as cs  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "e2e")


def library(tag: str, source: str) -> build.Built:
    """``source`` built as cuda_segment's library (the other sources the
    repo's)."""
    where = os.path.join(OUT, tag)
    os.makedirs(where, exist_ok=True)
    for name in os.listdir(build.CSRC_DIR):
        if name.endswith((".cu", ".cuh", ".h")):
            shutil.copy(os.path.join(build.CSRC_DIR, name), where)
    shutil.copy(source, os.path.join(where, "segment.cu"))
    csrc = build.CSRC_DIR
    build.CSRC_DIR, cs._built = where, None
    try:
        return cs.load_library()
    finally:
        build.CSRC_DIR = csrc


def use(built: build.Built) -> None:
    cs._built = built
    cs._routes.clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--tag", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--requests", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_k3_end_to_end: needs an NVIDIA card", file=sys.stderr)
        return 1
    if not args.source or len(args.source) != len(args.tag):
        raise SystemExit("give a --tag for every --source")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}", flush=True)
    libs = {tag: library(tag, src) for tag, src in zip(args.tag, args.source)}
    request = synthetic_pair_batch(**chip_smoke.FLAGSHIP, seed=0)
    dataset = synthetic_pair_dataset(chip_smoke.EVAL_PAIRS, **chip_smoke.EVAL_DATA)
    batches = list(BucketedLoader(dataset, max_num=4_000_000,
                                  max_batch_size=chip_smoke.EVAL_BATCH, shuffle=False))
    serve_ms = {tag: [] for tag in libs}
    explain_s = {tag: [] for tag in libs}
    first_records = None
    order = list(libs)
    for r in range(args.rounds):
        for tag in (order if r % 2 == 0 else order[::-1]):
            use(libs[tag])
            run = load_run(chip_smoke.RUN_DIR)
            predict(run, request)          # captures
            torch.cuda.synchronize()
            times = []
            for _ in range(args.requests):
                t0 = time.perf_counter()
                predict(run, request)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            serve_ms[tag].append(statistics.median(times))
            with gvp.fused_message():
                evaluate_batches(run.model, dataset, batches, do_explainer=True)   # captures
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                records = evaluate_batches(run.model, dataset, batches, do_explainer=True)
                torch.cuda.synchronize()
                with_s = time.perf_counter() - t0
                evaluate_batches(run.model, dataset, batches, do_explainer=False)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                evaluate_batches(run.model, dataset, batches, do_explainer=False)
                torch.cuda.synchronize()
                without_s = time.perf_counter() - t0
            explain_s[tag].append((with_s - without_s) / len(batches))
            if first_records is None:
                first_records = records
            elif not all(np.array_equal(np.asarray(a), np.asarray(b)) for k in records
                         for a, b in zip(records[k], first_records[k])):
                raise AssertionError(f"{tag}: the explained records differ from the first "
                                     "version's")
            print(f"round {r} {tag}: flagship request replayed {serve_ms[tag][-1]:.3f} ms "
                  f"(median of {args.requests}); the explainer's seconds a batch, fused, "
                  f"replayed {explain_s[tag][-1]:.4f} s", flush=True)
    for tag in libs:
        print(f"{tag}: flagship request replayed {' '.join(f'{x:.3f}' for x in serve_ms[tag])} "
              f"ms; explained fused batch {' '.join(f'{x:.4f}' for x in explain_s[tag])} s "
              f"({len(batches)} batches; records bit for bit the first version's)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
