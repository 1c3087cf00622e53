"""The readers of the program's spans (benchlib/spans.py and the metrics
that use it) on a synthetic ring with known spans and window: each reads
its value; each returns None where the ring overwrote part of what it
reads, on a cell of the other runner, and where the program keeps no ring
(an older program)."""
from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import pytest

import bench_tiny

REPO = bench_tiny.REPO
sys.path[:0] = [os.path.join(REPO, "benchmark"), REPO]

from benchlib import spec  # noqa: E402
from caster_dta_torch.utils import profiling  # noqa: E402

S = 10**9          # ns a second
T0, T1 = 100.0, 200.0

# set-up: a warm-up and a capture of each bucket; the window: two screened
# batches (loader, pack, forward, two explainer towers, fetch, records), a
# train replay on each side of them, and a span that crosses the window's end
SETUP = [("graph.warmup", 10, 12, -1), ("graph.capture", 12, 15, 900),
         ("loader.batch", 16, 17, 8), ("graph.warmup", 20, 21.5, -1),
         ("graph.capture", 21.5, 22, 1100)]
WINDOW = [("train.replay", 100.5, 101, 4000),
          ("loader.batch", 101, 101.004, 8), ("inference.pack", 101.004, 101.005, -1),
          ("inference.forward", 101.005, 101.010, 1000),
          ("inference.explain", 101.010, 101.040, 6000),
          ("inference.explain", 101.040, 101.070, 7000),
          ("inference.fetch", 101.070, 101.080, -1), ("inference.records", 101.080, 101.083, 8),
          ("loader.batch", 101.083, 101.085, 6), ("inference.pack", 101.085, 101.086, -1),
          ("inference.forward", 101.090, 101.095, 1200),
          ("inference.explain", 101.095, 101.125, 6000),
          ("inference.explain", 101.125, 101.155, 7000),
          ("inference.fetch", 101.155, 101.165, -1), ("inference.records", 101.165, 101.170, 6),
          ("train.replay", 150, 150.5, 5000), ("inference.forward", 199.9, 200.1, 1)]
WANT = {"host_gap_ms_per_batch.screen": ("screen", 10.0),       # 101.080 -> 101.090
        "loader_work_ms_per_batch.screen": ("screen", 3.0),
        "graph_nodes_per_batch.screen": ("screen", (1000 + 1200 + 26000) / 2),
        "graph_nodes_per_step.train": ("train", 4500.0),
        "capture_s": (None, 2 + 3 + 1.5 + 0.5)}


def _ring(spans, size=64) -> profiling.SpanRing:
    ring = profiling.SpanRing(size)
    for name, s, e, v in spans:
        ring.record(name, round(s * S), round(e * S), v)
    return ring


def _ctx(runner: str, traced: bool = False):
    mix = {"runner": runner, "trace": {"from_batch": 2, "batches": 2}}
    return SimpleNamespace(window_t0=T0, window_t1=T1, traced=traced,
                           cell=SimpleNamespace(mix=mix))


def _read(name: str, ctx):
    return spec.metric_reader(name).read(ctx)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_its_spans(monkeypatch, name):
    monkeypatch.setattr(profiling, "RING", _ring(SETUP + WINDOW))
    runner, want = WANT[name]
    for r in ([runner] if runner else ["screen", "train"]):
        assert _read(name, _ctx(r)) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_returns_none_on_an_overwritten_range(monkeypatch, name):
    """A ring one span too small for the set-up and the window loses the
    first set-up span: every reader of set-up says None. A ring that lost
    the window's first spans says None to the window's readers too."""
    runner = WANT[name][0] or "train"
    monkeypatch.setattr(profiling, "RING", _ring(SETUP + WINDOW, size=len(SETUP + WINDOW) - 1))
    assert (_read(name, _ctx(runner)) is None) == (name == "capture_s")
    monkeypatch.setattr(profiling, "RING", _ring(SETUP + WINDOW, size=len(WINDOW) - 2))
    assert _read(name, _ctx(runner)) is None


@pytest.mark.parametrize("name", sorted(n for n, (r, _) in WANT.items() if r))
def test_reader_returns_none_on_the_other_runner(monkeypatch, name):
    monkeypatch.setattr(profiling, "RING", _ring(SETUP + WINDOW))
    other = {"screen": "train", "train": "screen"}[WANT[name][0]]
    assert _read(name, _ctx(other)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_returns_none_without_the_programs_ring(monkeypatch, name):
    monkeypatch.delattr(profiling, "RING")
    assert _read(name, _ctx(WANT[name][0] or "train")) is None


def test_counts_of_eager_work_are_not_read(monkeypatch):
    """A forward that ran eagerly in the window (value -1) carries no count:
    the screen's nodes a batch says None rather than a wrong count."""
    spans = [s if s[0] != "inference.forward" or s[1] > 101.05 else s[:3] + (-1,)
             for s in WINDOW]
    monkeypatch.setattr(profiling, "RING", _ring(SETUP + spans))
    assert _read("graph_nodes_per_batch.screen", _ctx("screen")) is None
    assert _read("host_gap_ms_per_batch.screen", _ctx("screen")) == pytest.approx(10.0)


def test_the_entries_name_their_readers_cells():
    """Each new metric lists the cells whose runner writes its spans."""
    cells = {w["name"]: spec.load_cell(w["name"]).mix["runner"]
             for w in spec.load_json(os.path.join(REPO, "BENCHMARK.json"))["workloads"]}
    metrics = {m["name"]: m for m in
               spec.load_json(os.path.join(REPO, "BENCHMARK.json"))["per_layer"]}
    for name, (runner, _) in WANT.items():
        listed = set(metrics[name]["workloads"])
        assert listed == {c for c, r in cells.items() if runner in (None, r)}, name


def test_host_gap_leaves_out_the_traced_slice(monkeypatch):
    """Eight batches 5 ms apart, but the gaps around a traced slice of
    batches 2 and 3: the profiler's start before batch 2 (0.5 s), its stop
    before batch 4 (3 s) and its spans' cost before batch 3 (6 ms). A
    traced run leaves those three out; an untraced one reads them all."""
    gap = {2: 0.5, 3: 0.006, 4: 3.0}
    spans, t = [], 110.0
    for k in range(8):
        t += gap.get(k, 0.005) if k else 0.0
        spans += [("inference.forward", t, t + 0.01, 1000), ("inference.fetch", t + 0.05,
                                                             t + 0.06, -1)]
        t += 0.06
    monkeypatch.setattr(profiling, "RING", _ring(spans))
    assert _read("host_gap_ms_per_batch.screen", _ctx("screen", traced=True)) == \
        pytest.approx(5.0)
    assert _read("host_gap_ms_per_batch.screen", _ctx("screen")) == \
        pytest.approx((4 * 5 + 500 + 6 + 3000) / 7)
