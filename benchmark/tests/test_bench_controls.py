"""The controls come out not correct: the plain reference put in the
program's place one precision below the configuration's (fp8 products for
the bf16 training cells; TF32 for the f32 screening cells, which needs the
card), and the planted faults, read by benchmark/calibrate.py on a tiny
copy of the benchmark and held to the cells' own limits. On the card at
the cells' sizes the same script gives the readings the limits were set
from (PERF.md)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import bench_tiny

REPO = bench_tiny.REPO


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return bench_tiny.tiny_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    return "cuda"


def _readings(root: str, workload: str, device: str) -> list:
    proc = subprocess.run([sys.executable, os.path.join(root, "benchmark", "calibrate.py"),
                           "--workload", workload, "--seeds", "2147483659", "--device", device],
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]


def _fails(row: dict, workload: str) -> bool:
    with open(os.path.join(REPO, "benchmark", "limits", workload + ".json")) as f:
        limits = json.load(f)
    return any(row[k] > v for k, v in limits.items() if k in row)


@pytest.mark.parametrize("workload", ["train-davis.lba-gine", "train-davis.cpd-gatv2"])
def test_train_controls_fail(tiny, workload):
    rows = {r["variant"]: r for r in _readings(tiny, workload, "cpu")}
    assert _fails(rows["fp8"], workload) and _fails(rows["half_batch"], workload), rows


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["explain-screen.lba-gine"])
def test_screen_controls_fail(tiny, workload, card):
    rows = {r["variant"]: r for r in _readings(tiny, workload, card)}
    assert all(_fails(r, workload) for r in rows.values()), rows
