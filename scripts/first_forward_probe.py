#!/usr/bin/env python3
"""Probe for the first-CPU-forward fault (ROADMAP Queue 3): now and then a
process's first CPU forward of the port has given answers ~1e-4 pKd off on a
batch's first pairs, while later forwards agreed with each other bit for bit.

Each round starts K processes at once. Each loads runs/davis_seed9 on the
CPU, makes the same seeded batch, and runs the served forward twice with no
warm-up before the first. It reports whether the first answer equals the
second bit for bit, and if not which pairs differ and by how much, and (with
``--hooks``) the first module, in call order, whose output differs between
the two runs and whether its input already differed, and (with ``--ops N``) the first of the forward's first N aten
ops whose output differs (a float64 checksum of each op's output, taken by a
dispatch mode).

    python3 scripts/first_forward_probe.py --rounds 20 --processes 4 [--pin]
    python3 scripts/first_forward_probe.py --rounds 20 --threads 1
    python3 scripts/first_forward_probe.py --where
    python3 scripts/first_forward_probe.py --time 20

Each process runs on torch's default thread count unless ``--threads`` is
given. With ``--pin`` each process pins MKL's code path as the port's entry
points do (``caster_dta_torch.device.pin_mkl_code_path`` after ``import
torch``, before the first forward); set nothing in the environment for that.
``--where`` reads back the code path MKL took (``mkl_serv_cbwr_get``) in
fresh processes where ``MKL_CBWR=COMPATIBLE`` is set before ``import torch``,
after it, after a first GEMM, or not at all. ``--time N`` times N served
forwards (after 2 warm-up forwards) in a fresh process with the pin and in
one without it, in turns, and prints each median. One JSON line per process and round goes to ``--out`` (default
chiprun_out/first_forward_probe.jsonl); the last line printed sums them up.
Runs on the CPU only; nothing here touches a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = {"flagship": dict(b=32, n_p=512, e_p=4096, n_m=64, e_m=256),
           "small": dict(b=8, n_p=128, e_p=1024, n_m=48, e_m=256)}


def _op_sums(torch, limit: int):
    """A dispatch mode that records (op, checksums of its tensor outputs) of
    the first ``limit`` ops."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Sums(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if len(self.seen) >= limit:
                return out
            sums = tuple((float(t.double().sum()), float(t.double().abs().sum()))
                         for t in tree_flatten(out)[0]
                         if isinstance(t, torch.Tensor) and t.is_floating_point())
            self.seen.append((str(func), sums))
            return out

    return Sums


def one_process(batch: str, seed: int, threads: int | None, hooks: bool,
                ops: int = 0, pin: bool = False) -> dict:
    """Two forwards of one seeded batch in this fresh process -> the report."""
    sys.path.insert(0, HERE)
    import torch

    if pin:
        from caster_dta_torch.device import pin_mkl_code_path

        pin_mkl_code_path()
    if threads:
        torch.set_num_threads(threads)
    from caster_dta_torch.data.batching import synthetic_pair_batch
    from caster_dta_torch.inference.serve import load_run
    from caster_dta_torch.nn.common import f32_precision

    run = load_run(os.path.join(HERE, "runs", "davis_seed9"), device="cpu")
    b = synthetic_pair_batch(**BATCHES[batch], seed=seed)
    outputs: list = []
    inputs: list = []
    if hooks:
        def keep(module, args, out):
            t = out[0] if isinstance(out, tuple) else out
            if isinstance(t, torch.Tensor):
                outputs[-1].append((names[module], t.detach().clone()))

        def keep_input(module, args):
            t = args[0] if args else None
            t = t[0] if isinstance(t, tuple) else t
            if isinstance(t, torch.Tensor):
                inputs[-1][names[module]] = t.detach().clone()

        names = {m: n or "model" for n, m in run.model.named_modules()}
        for m in names:
            m.register_forward_hook(keep)
            m.register_forward_pre_hook(keep_input)
    answers, recorded = [], []
    for _ in range(2):
        outputs.append([])
        inputs.append({})
        mode = _op_sums(torch, ops)() if ops else contextlib.nullcontext()
        with torch.no_grad(), f32_precision(), mode:
            score, _ = run.model(b.protein, b.molecule, return_attention=False)
        answers.append(score[:, 0])
        if ops:
            recorded.append(mode.seen)
    first, second = answers
    diff = (first - second).abs()
    rows = torch.nonzero(diff).flatten().tolist()
    report = {"pid": os.getpid(), "threads": torch.get_num_threads(),
              "mkl_cbwr": mkl_code_path(torch), "equal":
              bool(torch.equal(first, second)), "differing_pairs": rows,
              "max_abs_diff": float(diff.max()), "first_divergent_module": None}
    if hooks and rows:
        for (name, a), (_, b2) in zip(*outputs):
            if a.shape != b2.shape or not torch.equal(a, b2):
                d = (a - b2).abs().reshape(a.shape[0], -1).amax(1)
                x0, x1 = inputs[0].get(name), inputs[1].get(name)
                report.update(first_divergent_module=name,
                              first_divergent_pairs=torch.nonzero(d).flatten().tolist(),
                              first_divergent_max_abs=float(d.max()),
                              first_divergent_scale=float(a.abs().max()),
                              its_input_equal=None if x0 is None else bool(torch.equal(x0, x1)))
                break
    if ops and rows:
        for i, (x, y) in enumerate(zip(*recorded)):
            if x != y:
                report.update(first_divergent_op=x[0], op_index=i,
                              ops_before=[op for op, _ in recorded[0][max(0, i - 4):i]])
                break
    return report


def mkl_code_path(torch) -> int:
    """The code path MKL runs (``mkl_serv_cbwr_get(MKL_CBWR_BRANCH)``): 1
    unpinned (``MKL_CBWR_BRANCH_OFF``), 3 COMPATIBLE. Torch links MKL into
    ``libtorch_cpu``; the call starts MKL where it has not run yet."""
    import ctypes

    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cpu.so"))
    lib.mkl_serv_cbwr_get.restype = ctypes.c_int
    return int(lib.mkl_serv_cbwr_get(ctypes.c_int(1)))


WHERE = {"before import torch": "MKL_CBWR before the import",
         "after import torch": "MKL_CBWR after the import, before any GEMM",
         "after a first GEMM": "MKL_CBWR after one 64 x 64 matmul",
         "not set": "no MKL_CBWR"}


def where_child(where: str) -> dict:
    """In this fresh process: set MKL_CBWR=COMPATIBLE at ``where``, run a
    GEMM, read back the code path MKL took."""
    if where == "before import torch":
        os.environ["MKL_CBWR"] = "COMPATIBLE"
    import torch

    a = torch.randn(64, 64)
    if where == "after import torch":
        os.environ["MKL_CBWR"] = "COMPATIBLE"
    if where == "after a first GEMM":
        a @ a
        os.environ["MKL_CBWR"] = "COMPATIBLE"
    a @ a
    return {"where": where, "mkl_cbwr": mkl_code_path(torch)}


def time_child(batch: str, seed: int, n: int, pin: bool) -> dict:
    """Host seconds of n served CPU forwards (after 2 warm-up forwards) in
    this fresh process, pinned or not."""
    sys.path.insert(0, HERE)
    import torch

    if pin:
        from caster_dta_torch.device import pin_mkl_code_path

        pin_mkl_code_path()
    from caster_dta_torch.data.batching import synthetic_pair_batch
    from caster_dta_torch.inference.serve import load_run
    from caster_dta_torch.nn.common import f32_precision

    run = load_run(os.path.join(HERE, "runs", "davis_seed9"), device="cpu")
    b = synthetic_pair_batch(**BATCHES[batch], seed=seed)
    times = []
    for i in range(n + 2):
        t0 = time.perf_counter()
        with torch.no_grad(), f32_precision():
            run.model(b.protein, b.molecule, return_attention=False)
        if i >= 2:
            times.append(time.perf_counter() - t0)
    return {"pin": pin, "mkl_cbwr": mkl_code_path(torch), "threads": torch.get_num_threads(),
            "seconds": times}


def _child(args_list: list) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "MKL_CBWR"}
    out = subprocess.run([sys.executable, os.path.abspath(__file__), *args_list], env=env,
                         capture_output=True, text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--processes", type=int, default=4)
    p.add_argument("--threads", type=int, default=None,
                   help="torch threads a process (default: torch's own count)")
    p.add_argument("--batch", choices=sorted(BATCHES), default="flagship")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hooks", action="store_true",
                   help="record every module's output to name the first that differs")
    p.add_argument("--ops", type=int, default=0,
                   help="checksum the first N aten ops' outputs to name the first that "
                        "differs")
    p.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                 "first_forward_probe.jsonl"))
    p.add_argument("--pin", action="store_true",
                   help="pin MKL's code path in each process as the entry points do")
    p.add_argument("--where", action="store_true",
                   help="read back MKL's code path for each place of the pin")
    p.add_argument("--time", type=int, default=0, metavar="N",
                   help="time N forwards with the pin and N without, in turns")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--where-child", help=argparse.SUPPRESS)
    p.add_argument("--time-child", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        print(json.dumps(one_process(args.batch, args.seed, args.threads, args.hooks,
                                     args.ops, args.pin)))
        return 0
    if args.where_child:
        print(json.dumps(where_child(args.where_child)))
        return 0
    if args.time_child:
        print(json.dumps(time_child(args.batch, args.seed, args.time_child, args.pin)))
        return 0
    if args.where:
        for where, what in WHERE.items():
            print(f"{what}: MKL's code path {_child(['--where-child', where])['mkl_cbwr']} "
                  f"(1 unpinned, 3 COMPATIBLE)")
        return 0
    if args.time:
        import statistics

        runs = {True: [], False: []}
        for pin in (False, True, True, False):
            rep = _child(["--time-child", str(args.time), "--batch", args.batch, "--seed",
                          str(args.seed), *(["--pin"] if pin else [])])
            runs[pin].append(statistics.median(rep["seconds"]))
            print(json.dumps(rep), flush=True)
        print(json.dumps({"batch": args.batch, "forwards a process": args.time,
                          "median seconds, pinned": runs[True],
                          "median seconds, not pinned": runs[False]}))
        return 0
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "--batch", args.batch,
           "--seed", str(args.seed)] + (["--threads", str(args.threads)] if args.threads else [])
    cmd += (["--hooks"] if args.hooks else []) + (["--ops", str(args.ops)] if args.ops else [])
    cmd += ["--pin"] if args.pin else []
    total = differing = 0
    t0 = time.perf_counter()
    with open(args.out, "a") as log:
        for r in range(args.rounds):
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
                     for _ in range(args.processes)]
            for proc in procs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"round {r}: a probe process exited with "
                                       f"{proc.returncode}")
                rep = dict(json.loads(out.strip().splitlines()[-1]), round=r)
                log.write(json.dumps(rep) + "\n")
                total += 1
                differing += not rep["equal"]
                if not rep["equal"]:
                    print(f"round {r}: first forward differs: {rep}", flush=True)
            print(f"round {r}: {args.processes} processes done", flush=True)
    print(json.dumps({"processes": total, "first_forward_differs": differing,
                      "rounds": args.rounds, "per_round": args.processes, "batch": args.batch,
                      "threads": args.threads or "torch default", "pin": args.pin,
                      "MKL_CBWR in the environment": os.environ.get("MKL_CBWR"),
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
