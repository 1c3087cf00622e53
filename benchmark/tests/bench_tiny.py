"""A copy of the benchmark at a size a CPU test can run, and a runner that
drives a run past the look for a card, optionally with a fault planted in
the program underneath.

    python bench_tiny.py <copy root> <workload> <seed> [<fault> [<device>]]

prints the run's result line (on the CPU unless a device is named). The
copy holds the committed benchmark files with every mix cut to a few small
proteins and ligands, the configurations computing in f32 (so that a sound
run matches the reference to rounding), and the run's seconds short.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_TABLE = "tiny_sizes.json"


def tiny_copy(dst: str) -> str:
    """The benchmark under ``dst`` (BENCHMARK.json and benchmark/), cut small."""
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    b = os.path.join(dst, "benchmark")
    with open(os.path.join(b, "data", TINY_TABLE), "w") as f:
        json.dump({"proteins": [{"target": f"t{i}", "residues": n, "edges": int(2.5 * n)}
                                for i, n in enumerate((24, 30, 40, 52, 60, 70))]}, f)
    for name in os.listdir(os.path.join(b, "mixes")):
        path = os.path.join(b, "mixes", name)
        with open(path) as f:
            mix = json.load(f)
        train = mix["runner"] == "train"
        mix["targets"] = ({"table": TINY_TABLE, "select": "all"} if train else
                          {"table": TINY_TABLE, "select": "quantiles", "count": 3})
        mix["ligands"] = dict(mix["ligands"], count=8, atoms=[6, 10], tail_atoms=[11, 14])
        # batches of 4 in training: a bucket with enough steps to be replayed on the card
        mix["budget"] = {"max_num": 40000, "max_batch_size": 4 if train else 8}
        if train:
            mix["check"]["val_pairs"] = 6
        else:
            mix["explainer"]["epochs"] = 3
            mix["trace"] = {"from_batch": 1, "batches": 2}
        with open(path, "w") as f:
            json.dump(mix, f)
    for name in os.listdir(os.path.join(b, "configs")):
        path = os.path.join(b, "configs", name)
        with open(path) as f:
            conf = json.load(f)
        conf["train_compute_dtype"] = "float32"
        with open(path, "w") as f:
            json.dump(conf, f)
    return dst


def run(root: str, workload: str, seed: int, fault: str = "", timeout: float = 600,
        device: str = "cpu") -> dict:
    """One run of ``workload`` in the copy at ``root`` on ``device`` -> its
    result line."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), root, workload, str(seed),
                           fault, device], capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    if proc.returncode != 0:
        raise RuntimeError(f"run failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


# --------------------------------------------------------------- faults

def _plant(fault: str) -> None:
    """Break the timed path underneath, as a faulty program would."""
    import torch

    from caster_dta_torch.inference import evaluation, explain, replay
    from caster_dta_torch.train import loop

    if fault == "train_replay_state_unchanged":     # captured steps leave the weights unchanged
        apply_grads = loop.Trainer._apply_grads

        def eager_only(self, grads, *a):
            if not torch.cuda.is_current_stream_capturing():
                apply_grads(self, grads, *a)
        loop.Trainer._apply_grads = eager_only
    elif fault == "train_state_unchanged":          # every step leaves the weights as they were
        apply = loop.Trainer._apply_grads
        loop.Trainer._apply_grads = lambda self, grads, *a: apply(
            self, [torch.zeros_like(g) for g in grads], *a)
    elif fault == "train_half_batch":               # the loss's mean over half of each batch
        loss = loop.Trainer._loss

        def half(self, protein, molecule, target, weight):
            w = weight.clone()
            w[w.shape[0] // 2:] = 0.0
            return loss(self, protein, molecule, target, w)
        loop.Trainer._loss = half
    elif fault == "train_answer_altered":           # a prediction altered where it is made
        body = loop.Trainer._eval_body
        loop.Trainer._eval_body = lambda self, p, m: body(self, p, m) + 0.5
    elif fault == "screen_answer_altered":
        fwd = replay.forward
        replay.forward = lambda model, p, m: (lambda o: (o[0] + 0.5,) + o[1:])(fwd(model, p, m))
    elif fault == "screen_half_batch":              # half of each batch's records never made
        add = evaluation._add_rows

        def half(rows, dataset, batch, *a):
            import dataclasses
            w = batch.weight.clone()
            w[w.shape[0] // 2:] = 0.0
            return add(rows, dataset, dataclasses.replace(batch, weight=w), *a)
        evaluation._add_rows = half
    elif fault == "screen_state_unchanged":         # the explainer's masks never move
        init = explain.DTAModelExplainer.__init__
        explain.DTAModelExplainer.__init__ = lambda self, model, *a, **k: init(
            self, model, **dict(k, n_epochs=0))
    elif fault:
        raise ValueError(f"unknown fault {fault!r}")


def _main(root: str, workload: str, seed: str, fault: str = "", device: str = "cpu") -> None:
    sys.path[:0] = [os.path.join(root, "benchmark"), REPO]
    import torch

    torch.set_num_threads(2)
    import run as bench_run
    from benchlib.context import process_start

    _plant(fault)
    args = bench_run.parse(["--workload", workload, "--seed", seed, "--seconds", "1.5",
                            "--trace", "0"])
    print(json.dumps(bench_run.execute(args, device, process_start())))


if __name__ == "__main__":
    _main(*sys.argv[1:])
