"""A run with the timed path broken underneath comes out not correct, and
the same run unbroken comes out correct: each fault a cell can have, on a
tiny copy of the benchmark on the CPU (bench_tiny.py), past the look for a
card; and on the card, a fault confined to the captured train step (the CPU
captures nothing). One chip: no exchange between chips to leave out."""
from __future__ import annotations

import pytest

import bench_tiny

SEED = 2147483659          # past 32 signed bits

FAULTS = {
    "train-davis.lba-gine": ("train_state_unchanged", "train_half_batch", "train_answer_altered"),
    "train-davis.cpd-gatv2": ("train_state_unchanged", "train_half_batch",
                              "train_answer_altered"),
    "explain-screen.lba-gine": ("screen_state_unchanged", "screen_half_batch",
                                "screen_answer_altered"),
}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return bench_tiny.tiny_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_sound_run_is_correct(tiny, workload):
    line = bench_tiny.run(tiny, workload, SEED)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in sorted(FAULTS.items())
                                            for f in fs])
def test_fault_is_not_correct(tiny, workload, fault):
    line = bench_tiny.run(tiny, workload, SEED, fault)
    assert not line["correct"], line["checks"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs of the train step exist only on the card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["", "train_replay_state_unchanged"])
@pytest.mark.parametrize("workload", ["train-davis.lba-gine", "train-davis.cpd-gatv2"])
def test_captured_step_fault_on_card(tiny, card, workload, fault):
    line = bench_tiny.run(tiny, workload, SEED, fault, device=card)
    checks = line["checks"]
    if not fault:
        assert line["correct"], checks
        return
    assert not line["correct"], checks
    assert checks["replay_change_rel"]["value"] > checks["replay_change_rel"]["limit"], checks
