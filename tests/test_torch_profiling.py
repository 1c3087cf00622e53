"""The port's instrumentation (caster_dta_torch/utils/): tests/test_profiling.py's
three cases on ``ThroughputMeter``, ``StepTimer`` and ``annotate``, ``trace``
writing a Chrome trace, and the op-boundary byte count (utils/traffic.py): a
matmul moves a + b + out bytes, views and allocations none, a kernel
wrapper's plain twin on the CPU is counted through the dispatch mode, and on
the card (marked ``gpu``; ``python -m pytest --noconftest -o addopts="" -m gpu
tests/test_torch_profiling.py``) the wrapper reports its own bytes.

``ThroughputMeter`` moved here from train/loop.py, which still exports it.
"""
import glob
import json
import time

import pytest
import torch

from caster_dta_torch.ops import cuda_segment as cs
from caster_dta_torch.ops import launches
from caster_dta_torch.utils.profiling import StepTimer, ThroughputMeter, annotate, trace
from caster_dta_torch.utils.traffic import TrafficCounter, op_traffic, shape_bytes


def test_throughput_meter_counts():
    m = ThroughputMeter(window=4)
    assert m.edges_per_s == 0.0
    for _ in range(6):
        m.step(1000, 8)
        time.sleep(0.002)
    s = m.summary()
    assert s["steps"] == 6
    assert s["total_edges"] == 6000 and s["total_pairs"] == 48
    assert m.edges_per_s > 0 and m.pairs_per_s > 0
    # windowed rate reflects recent steps only (window+1 timestamps kept)
    assert len(m._t) <= 5


def test_step_timer_sections():
    t = StepTimer()
    with t.section("load"):
        time.sleep(0.003)
    with t.section("load"):
        time.sleep(0.003)
    with t.section("step"):
        time.sleep(0.001)
    rep = t.report()
    assert rep["load"]["calls"] == 2
    assert rep["load"]["total_s"] >= 0.006
    assert rep["step"]["calls"] == 1
    assert set(rep["load"]) == {"total_s", "calls", "mean_ms"}


def test_annotate_runs():
    with annotate("region"):
        x = sum(range(100))
    assert x == 4950


def test_meter_is_the_training_loops():
    from caster_dta_torch.train import loop

    assert loop.ThroughputMeter is ThroughputMeter


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(16, 16)
    with trace(str(tmp_path)):
        with annotate("matmul region"):
            (a @ a).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "matmul region" in names and "aten::mm" in names


def test_matmul_counts_its_operands_and_result_and_views_count_nothing():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    total, per_op = op_traffic(torch.matmul, a, b)
    assert total == shape_bytes((8, 16), torch.float32) + shape_bytes(
        (16, 4), torch.float32) + shape_bytes((8, 4), torch.float32) == per_op["aten.mm"]
    total, per_op = op_traffic(lambda: (a.t(), a[1:3], a[0], a.expand(2, 8, 16), a.view(128),
                                        a.detach(), a.transpose(0, 1), a.as_strided((2, 2), (1, 1)),
                                        torch.empty(5), torch.empty_like(a)))
    assert total == 0 and per_op and set(per_op.values()) == {0}
    assert shape_bytes((), torch.bfloat16) == 2


def test_plain_twin_is_counted_through_the_dispatcher():
    """On the CPU a kernel wrapper runs its plain version: its aten ops are
    counted and the wrapper reports no bytes of its own."""
    table = torch.randn(2, 10, 6)
    idx = torch.randint(0, 10, (2, 7), dtype=torch.int32)
    before = launches.bytes_snapshot()
    with TrafficCounter() as c:
        out = cs.gather_rows(table, idx)
    assert launches.bytes_snapshot() == before
    assert cs.K2 not in c.per_op
    assert c.per_op["aten.index_select"] == (table.numel() + out.numel()) * 4 + idx.numel() * 8
    assert c.total >= c.per_op["aten.index_select"]


@pytest.mark.gpu
def test_wrapper_on_the_card_reports_its_bytes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    table = torch.randn(2, 10, 6, device="cuda")
    idx = torch.randint(0, 10, (2, 7), dtype=torch.int32, device="cuda")
    total, per_op = op_traffic(cs.gather_rows, table, idx)
    torch.cuda.synchronize()
    want = table.numel() * 4 + idx.numel() * 4 + 2 * 7 * 6 * 4
    assert per_op[cs.K2] == want and total == want
