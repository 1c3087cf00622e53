"""The benchmark of caster_dta_torch (the PyTorch and CUDA port) on NVIDIA
GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. One run is one process: it makes the cell's
traffic and weights from the seed, sets up the port (every shape the
traffic uses warmed up, every graph captured), measures for ``--seconds``,
checks what the window produced against the plain reference under
benchmark/reference, and prints one JSON line last on standard output.
With ``--trace 0`` the line holds the cell's end-to-end metrics; with
``--trace 1`` a bounded slice of the window runs under torch.profiler and
the line holds the per-layer metrics, ``device.busy_s``/``window_s`` and a
``breakdown``. Each number compared with the reference is printed beside
its limit, last on standard error and last in the line (``checks``).

Exits non-zero and prints no result when no card is there (or fewer than
the cell asks for), when the program cannot be imported, and when
``jax``, ``jaxlib``, ``flax``, ``optax`` or ``caster_dta_tpu`` is among the
loaded modules once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "caster_dta_tpu"})


def _cache_env() -> None:
    """Every build and kernel cache in fixed directories of the checkout
    (the port's nvcc builds already go to caster_dta_torch/_build/)."""
    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ.pop("TORCH_ALLOW_TF32_CUBLAS_OVERRIDE", None)   # would force TF32 (nn/common.py)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def result_line(ctx, metrics: dict, device: dict, breakdown=None) -> dict:
    """The contract's last line: correct, attempted, failed, metrics, device,
    breakdown (traced runs) and, last, the numbers compared and their limits."""
    out = {"correct": ctx.correct, "attempted": int(ctx.attempted), "failed": int(ctx.failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in ctx.checks}
    return out


def execute(args, device, started: float) -> dict:
    """Set up, measure and check one run of ``args.workload`` on ``device``
    -> the result line (tests call this on the CPU, past the look for a
    card). Raises RuntimeError when modules of JAX are loaded after the
    window."""
    import torch

    from benchlib import spec
    from benchlib.context import Context

    cell = spec.load_cell(args.workload)
    ctx = Context(args, cell, torch.device(device), started=started)
    ctx.mark("imports")
    runner = spec.load_module(os.path.join(HERE, "benchlib", "runners", cell.mix["runner"] + ".py"))
    runner.run(ctx)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = ctx.device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell.entry["chips"]), "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    breakdown = None
    if args.trace and ctx.trace.get("slice"):
        s = ctx.trace["slice"]
        dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
        breakdown = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    line = result_line(ctx, metrics, dev, breakdown)
    print(f"correct: {line['correct']} (attempted {ctx.attempted}, failed {ctx.failed})",
          file=sys.stderr)
    for c in ctx.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    return line


def main(argv=None) -> int:
    _cache_env()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    from benchlib.context import process_start

    started = process_start()
    args = parse(argv)
    import torch

    from benchlib import spec

    chips = int(spec.load_cell(args.workload).entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    import caster_dta_torch  # noqa: F401  (fails here, before any work, without the program)

    try:
        line = execute(args, "cuda", started)
    except RuntimeError as err:
        if "modules of JAX" not in str(err):
            raise
        print(f"benchmark: {err}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
