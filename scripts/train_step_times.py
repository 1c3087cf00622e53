#!/usr/bin/env python3
"""The eager bf16 Adam train step's time on the card (``Trainer.train_step``
one batch at a time), for one or more checkouts of the port side by side.

    python3 scripts/train_step_times.py [--root DIR [--tag NAME]] ... [--steps N]
        [--rounds R]

Each ``--root`` (default: this checkout) is a directory holding a
``caster_dta_torch`` package. The roots run in the order given and then in
the reverse order (first, second, ..., second, first), that ``--rounds``
times, each run in a process of its own that imports the package from its
root. A run loads this checkout's ``runs/davis_seed9`` and trains on
``chip_smoke.py``'s first flagship request (B=32, protein 512/4096, molecule
64/256, seed 0), bf16, Adam at lr 1e-4, dropout on, as ``chip_smoke.py``'s
train phase does, once for each config its ``TrainConfig`` accepts: ``scan_steps=False`` (the
eager optimizer) and ``scan_steps=True`` (the capturable optimizer the graph
path shares with ``train_step``). Within a run the configs go in the order
A, B, B, A, ``--steps`` timed steps a turn after 3 untimed ones, each step
between two CUDA events. Then torch.profiler over 5 more steps gives the
kernels per step and their device time. Per root and config the script
prints the median of all its timed steps, each run's median in run order,
protein edges/s at the median, the kernels per step and the device's idle
share of the median step.

Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_DIR = os.path.join(HERE, "runs", "davis_seed9")
FLAGSHIP = dict(b=32, n_p=512, e_p=4096, n_m=64, e_m=256)
CONFIGS = (("scan_steps=False", dict(scan_steps=False)),
           ("scan_steps=True", dict(scan_steps=True)))


def one_run(root: str, steps: int) -> list:
    """The configs' times with the package of ``root`` -> one dict per
    config and turn, then one per config with its profile."""
    sys.path.insert(0, root)
    import torch

    import caster_dta_torch
    from caster_dta_torch.data.batching import synthetic_pair_batch
    from caster_dta_torch.inference.serve import load_run
    from caster_dta_torch.train.loop import Trainer, TrainConfig

    pkg = os.path.dirname(os.path.abspath(caster_dta_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise RuntimeError(f"caster_dta_torch came from {pkg}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = synthetic_pair_batch(**FLAGSHIP, seed=0).to("cuda")
    p_edges = int(batch.protein.edge_mask.sum())
    trainers = {}
    for name, extra in CONFIGS:
        try:
            config = TrainConfig(compute_dtype="bfloat16", optimizer="adam", lr=1e-4, seed=0,
                                 **extra)
        except NotImplementedError:
            continue          # a version that does not know the field
        trainers[name] = Trainer(load_run(RUN_DIR, device="cuda").model, config, device="cuda")
    order = list(trainers) + list(trainers)[::-1]
    out = []
    for name in order:
        trainer = trainers[name]
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.train_step(batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out.append({"config": name, "times_ms": times})
    from torch.profiler import ProfilerActivity, profile
    for name, trainer in trainers.items():
        n = 5
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                trainer.train_step(batch)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        out.append({"config": name, "p_edges": p_edges, "kernels_per_step": len(kernels) / n,
                    "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=[])
    ap.add_argument("--tag", action="append", default=[])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_run(args.one, args.steps)))
        return 0
    roots = [os.path.abspath(r) for r in args.root] or [HERE]
    tags = args.tag + [os.path.basename(r) for r in roots[len(args.tag):]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip() or 'nvidia-smi gave nothing'}", flush=True)
    results: dict = {}
    n_run = 0
    for i in (list(range(len(roots))) + list(range(len(roots)))[::-1]) * args.rounds:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", roots[i],
                               "--steps", str(args.steps)], capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"the run of {roots[i]} failed ({proc.returncode})")
        for entry in json.loads(proc.stdout.strip().splitlines()[-1]):
            slot = results.setdefault((tags[i], entry["config"]), {"runs": []})
            if "times_ms" in entry:
                if not slot["runs"] or slot["runs"][-1][0] != n_run:
                    slot["runs"].append((n_run, []))
                slot["runs"][-1][1].extend(entry["times_ms"])
            else:
                slot.setdefault("profiles", []).append(entry)
        print(f"run {n_run}: {tags[i]} ({roots[i]})", flush=True)
        n_run += 1
    for (tag, config), slot in results.items():
        every = [t for _, run in slot["runs"] for t in run]
        median = statistics.median(every)
        kernels = statistics.median(p["kernels_per_step"] for p in slot["profiles"])
        kernel_ms = statistics.median(p["kernel_ms"] for p in slot["profiles"])
        print(f"{tag} {config}: eager bf16 Adam step median {median:.3f} ms over {len(every)} "
              f"steps (run medians "
              f"{', '.join(f'{n}: {statistics.median(t):.3f}' for n, t in slot['runs'])}; min "
              f"{min(every):.3f}, max {max(every):.3f}); protein edges/s "
              f"{slot['profiles'][0]['p_edges'] / median * 1e3:.1f}; {kernels:.0f} kernels, "
              f"{kernel_ms:.3f} ms of kernels per step, device idle {1 - kernel_ms / median:.1%} "
              f"of the median step (torch.profiler)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
