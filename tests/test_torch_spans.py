"""The port's spans (caster_dta_torch/utils/profiling.py ``annotate``, the
ring ``RING``, ``span_summary``) and where the hot paths place them, and the
device operations counted on each captured graph (train/graphs.py).

On the CPU: the ring records, keeps a time range and counts what it
overwrote; ``record_function`` is entered only while a profiler runs; the
screening entry (``evaluate_batches``) gives its spans a batch in order
(forward, the explainer once a tower, fetch, records) and the records of the
loop as it was before them; the loader gives one span a batch; the CPU
trainer one ``train.upload`` a megabatch.

On the card (marked ``gpu``; no JAX here, so it runs where only PyTorch is
installed):

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_spans.py -s

each captured graph's node count (train step, eval forward, served forward,
explainer loop) equals the kernels, copies and memsets torch.profiler sees
in one replay of it; replays stay the eager steps bit for bit under a
profiler; launch counts are the eager steps'; a second pass over captured
buckets captures nothing.
"""
import json
import time

import numpy as np
import pytest
import torch

from caster_dta_torch.data.batching import BucketedLoader, synthetic_pair_dataset
from caster_dta_torch.data.device_cache import DeviceResidentLoader
from caster_dta_torch.inference import evaluation, explain, replay
from caster_dta_torch.inference.evaluation import evaluate_batches
from caster_dta_torch.inference.explain import DTAModelExplainer
from caster_dta_torch.models.joint import make_joint_gnn
from caster_dta_torch.ops import cuda_segment as cs
from caster_dta_torch.ops import launches
from caster_dta_torch.train import graphs
from caster_dta_torch.train.loop import Trainer, TrainConfig
from caster_dta_torch.utils import profiling
from caster_dta_torch.utils.profiling import RING, SpanRing, annotate, span_summary

PROTEIN = dict(base_conv="lbamodel", in_channels=[17, 3], edge_dim=[32, 1], num_ntypes=21,
               num_etypes=1, ntype_emb_dim=None, etype_emb_dim=None, num_convs=2,
               hidden_channels=[8, 2], edge_hidden_channels=[8, 1], out_channels=16,
               dropout_rate=0.25, activation="leaky_relu", aggr="sum")
MOLECULE = dict(base_conv="gine", in_channels=41, edge_dim=9, num_ntypes=10, num_etypes=5,
                ntype_emb_dim=None, etype_emb_dim=None, num_convs=2, hidden_channels=8,
                out_channels=16, dropout_rate=0.0, activation="leaky_relu", aggr="sum",
                gin_trainable_eps=True)
JOINT = dict(residue_lin_depth=1, atom_lin_depth=1, n_attention_heads=4, attention_dropout=0.0,
             protein_lin_depth=1, molecule_lin_depth=1, pairwise_embedding_dim=32,
             out_lin_depth=1, out_lin_factor=0.5, out_lin_norm_type=None,
             activation="leaky_relu", dropout=0.25, element_pooling="mean",
             include_residual_stream=True, residual_dim_ff_scale=2, num_cross_attn_layers=1,
             include_post_pool_layernorm=False)
LADDERS = dict(protein_node_ladder=(16, 32, 48), edge_ladder=(128, 256, 512),
               molecule_node_ladder=(8, 16), molecule_edge_ladder=(32, 64))
# the per-step launches of tests/test_torch_graph_replay.py's model
PER_STEP = {cs.K1: 4, cs.K2: 8, cs.K3: 3}


def _model(device="cpu"):
    return make_joint_gnn(PROTEIN, MOLECULE, generator=torch.Generator().manual_seed(0),
                          **JOINT).to(device)


def _dataset():
    return synthetic_pair_dataset(7, 3, 3, protein_nodes=[(10, 40)], molecule_nodes=(6, 14),
                                  seed=21)


def _loader(dataset):
    return BucketedLoader(dataset, max_num=3000, max_batch_size=4, shuffle=False, **LADDERS)


def _since(t0: float, prefix: str = "") -> list:
    return [r for r in RING.records(t0) if r[0].startswith(prefix)]


# ---------------------------------------------------------------- the ring
def test_ring_keeps_a_time_range_by_start():
    ring = SpanRing(size=8)
    for name, s, e, v in (("b", 30, 40, 2), ("a", 10, 20, -1), ("a", 50, 65, 7)):
        ring.record(name, s * 10**9, e * 10**9, v)
    assert ring.records() == [("a", 10.0, 20.0, -1), ("b", 30.0, 40.0, 2), ("a", 50.0, 65.0, 7)]
    assert ring.records(25.0) == [("b", 30.0, 40.0, 2), ("a", 50.0, 65.0, 7)]
    assert ring.records(15.0, 45.0) == [("b", 30.0, 40.0, 2)]
    assert ring.records(None, 20.0) == [("a", 10.0, 20.0, -1)]
    s = ring.summary()
    assert list(s) == ["a", "b"] and s["a"]["count"] == 2 and s["a"]["total_s"] == 25.0
    assert s["a"]["mean_ms"] == 12_500.0 and s["b"]["p95_ms"] == 10_000.0
    assert ring.summary(25.0)["a"]["count"] == 1
    assert ring.overwritten == 0 and not ring.lost()


def test_ring_counts_what_it_overwrote():
    """A ninth span in a ring of 8 takes the first one's place: the ring
    counts it, and says that spans ending at or before its end were lost
    and later ones were not."""
    ring = SpanRing(size=8)
    for k in range(12):
        ring.record(f"s{k % 3}", k * 10**9, k * 10**9 + 5, k)
    assert ring.recorded == 12 and ring.overwritten == 4
    assert [r[3] for r in ring.records()] == list(range(4, 12))
    assert ring.lost() and ring.lost(0.0) and ring.lost(3.0)
    assert not ring.lost(3.5) and not ring.lost(4.0)
    assert ring.records(3.5)[0][3] == 4


def test_annotate_records_into_the_ring_with_its_value():
    t0 = time.perf_counter()
    with annotate("test.plain"):
        x = sum(range(100))
    with annotate("test.valued", 7):
        pass
    with annotate("test.set") as span:
        span.value = 11
    with pytest.raises(ValueError):
        with annotate("test.raised"):
            raise ValueError("a span ends with its block, whatever ends it")
    got = _since(t0, "test.")
    assert [(n, v) for n, _, _, v in got] == [("test.plain", profiling.NO_VALUE),
                                              ("test.valued", 7), ("test.set", 11),
                                              ("test.raised", profiling.NO_VALUE)]
    assert all(t0 <= s <= e <= time.perf_counter() for _, s, e, _ in got)
    assert x == 4950 and span_summary(t0)["test.set"]["count"] == 1


def test_record_function_only_under_a_profiler(monkeypatch):
    """Without a profiler ``annotate`` never builds a ``record_function``
    (it is made to fail here); under one, the profiler's events hold the
    span's name, and the ring holds the span either way."""
    real = torch.profiler.record_function

    def refused(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    t0 = time.perf_counter()
    with annotate("test.quiet"):
        pass
    monkeypatch.setattr(torch.profiler, "record_function", real)
    a = torch.randn(8, 8)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("test.traced", 3):
            (a @ a).sum()
    names = {e.name for e in prof.events()}
    assert "test.traced" in names and "test.quiet" not in names
    assert [n for n, *_ in _since(t0, "test.")] == ["test.quiet", "test.traced"]


# ------------------------------------------------------- where they are placed
def _records_before_spans(model, dataset, batches, epochs: int) -> dict:
    """evaluate_batches' loop as it was before its spans: forward, explainer,
    then each output to the host inside the records' call (the CPU path)."""
    explainer = DTAModelExplainer(model, n_epochs=epochs)
    rows = {k: [] for k in evaluation.COLUMNS}
    model.eval()
    for batch in batches:
        score, w_rd, w_dr = replay.forward(model, batch.protein, batch.molecule)
        exp = {k: evaluation._np(v) for k, v in
               explainer.explain_model(batch.protein, batch.molecule).items()}
        evaluation._add_rows(rows, dataset, batch, dataset.unscale_target(evaluation._np(score)),
                             evaluation._np(w_rd), evaluation._np(w_dr), exp)
    order = np.argsort(np.asarray(rows["pair_idx"]), kind="stable")
    out = {k: [v[i] for i in order] for k, v in rows.items()}
    out["max_protein_explanation"] = list(out["protein_explanation"])
    out["max_molecule_explanation"] = list(out["molecule_explanation"])
    return out


def _same_records(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert len(a[k]) == len(b[k]), k
        for x, y in zip(a[k], b[k]):
            assert (np.array_equal(x, y) if hasattr(x, "shape") else x == y), k


def test_screening_entry_spans_in_order_and_records_unchanged():
    """Each batch: forward, the explainer once a tower, fetch, records (its
    value the batch's real pairs), in turn; the records equal those of the
    loop before the spans, bit for bit."""
    dataset = _dataset()
    batches = list(_loader(dataset))
    model = _model()
    want = _records_before_spans(model, dataset, batches, epochs=1)
    t0 = time.perf_counter()
    got = evaluate_batches(model, dataset, iter(batches), do_explainer=True, explainer_epochs=1)
    _same_records(got, want)
    spans = _since(t0, "inference.")
    per_batch = ["inference.forward", "inference.explain", "inference.explain",
                 "inference.fetch", "inference.records"]
    assert [n for n, *_ in spans] == per_batch * len(batches)
    for k, batch in enumerate(batches):
        forward, _, _, fetch, records = spans[5 * k:5 * k + 5]
        assert forward[3] == profiling.NO_VALUE             # eager: no graph
        assert records[3] == int((batch.weight > 0).sum())
        assert fetch[1] >= forward[2]
        if k:
            assert forward[1] >= spans[5 * k - 1][2]


def test_loader_spans_one_a_batch_with_its_real_pairs():
    dataset = _dataset()
    t0 = time.perf_counter()
    batches = list(_loader(dataset))
    spans = _since(t0, "loader.")
    assert len(batches) >= 2 and [n for n, *_ in spans] == ["loader.batch"] * len(batches)
    assert [v for *_, v in spans] == [int((b.weight > 0).sum()) for b in batches]
    assert sum(v for *_, v in spans) == len(dataset)


def test_cpu_trainer_uploads_once_a_megabatch():
    """The CPU runs a store's megabatches eagerly: one ``train.upload`` a
    megabatch (its value the steps), train and eval; one fetch an epoch of
    each; no replays, warm-ups or captures."""
    dataset = synthetic_pair_dataset(40, 6, 5, protein_nodes=[(10, 40)], molecule_nodes=(6, 14),
                                     seed=3)
    store = DeviceResidentLoader(BucketedLoader(dataset, None, max_num=3000, max_batch_size=6,
                                                coalesce_min_batches=1, **LADDERS), device="cpu")
    steps = [mega.n_steps for mega, _ in store.iter_megabatches()]
    assert len(steps) > 1
    trainer = Trainer(_model(), TrainConfig(seed=5), device="cpu")
    t0 = time.perf_counter()
    trainer.train_epoch(store, 1e-3)
    trainer.eval_epoch(store)
    spans = _since(t0)
    names = [n for n, *_ in spans]
    uploads = [v for n, *_, v in spans if n == "train.upload"]
    assert sorted(uploads[:len(steps)]) == sorted(uploads[len(steps):]) == sorted(steps)
    assert names.count("train.fetch") == names.count("eval.fetch") == 1
    assert not {"train.replay", "eval.replay", "graph.warmup", "graph.capture"} & set(names)


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


@pytest.fixture
def node_types(monkeypatch):
    """Every capture's node types, by capture, as graphs.capture_node_types
    read them."""
    seen = []
    count = graphs.capture_node_types

    def recording(stream):
        out = count(stream)
        seen.append(out)
        return out

    monkeypatch.setattr(graphs, "capture_node_types", recording)
    return seen


def _graph_device_ops(fn, path) -> tuple:
    """(device operations of the one graph launch inside ``fn()``, device
    operations outside it), from torch.profiler's trace: kernels, copies and
    memsets, matched to the launch by correlation id."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch = {e["args"]["correlation"] for e in events
              if e.get("cat") == "cuda_runtime" and "cudaGraphLaunch" in e.get("name", "")}
    assert len(launch) == 1, launch
    ops = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    inside = sum(e.get("args", {}).get("correlation") in launch for e in ops)
    return inside, len(ops) - inside


def _megabatch(device):
    pairs = synthetic_pair_dataset(40, 6, 5, [(10, 40)], (6, 14), seed=3)
    store = DeviceResidentLoader(BucketedLoader(
        pairs, None, max_num=16_000_000, max_batch_size=6, seed=3,
        protein_node_ladder=(48,), edge_ladder=(512,), molecule_node_ladder=(16,),
        molecule_edge_ladder=(64,)), device=device)
    (mega, _), = store.iter_megabatches()
    return mega


@pytest.mark.gpu
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_and_eval_nodes_are_the_profilers_ops(cuda, node_types, tmp_path, grad_accum):
    mega = _megabatch(cuda)
    trainer = Trainer(_model(), TrainConfig(seed=5, grad_accum=grad_accum), device=cuda)
    t0 = time.perf_counter()
    trainer.train_megabatch(mega, [1e-3] * mega.n_steps)
    trainer.eval_megabatch(mega)
    torch.cuda.synchronize()
    for kind in ("train", "eval"):
        step = trainer.captured_step(kind, mega)
        for variant in step.graphs:
            inside, outside = _graph_device_ops(lambda: step.replay(variant),
                                                tmp_path / f"{kind}{variant}.json")
            print(f"{kind} variant {variant}: {step.nodes[variant]} nodes; profiler "
                  f"{inside} in the launch, {outside} outside it")
            assert step.nodes[variant] == inside > 0
    captures = [v for n, *_, v in _since(t0, "graph.capture")]
    assert captures == [sum(trainer.captured_step(k, mega).nodes.values())
                        for k in ("train", "eval")]
    print("node types by capture:", node_types)
    assert all(set(t) <= set(graphs.NODE_TYPES.values()) for t in node_types)


@pytest.mark.gpu
def test_served_forward_and_explainer_nodes_are_the_profilers_ops(cuda, node_types, tmp_path):
    """Through the entry: the first pass captures each bucket's forward and
    each tower's loop, the second replays them; each graph's nodes equal
    the profiler's operations in one replay, and the second pass's spans
    carry them."""
    model = _model(cuda).eval()
    dataset = _dataset()
    evaluate_batches(model, dataset, _loader(dataset), explainer_epochs=3)
    t0 = time.perf_counter()
    evaluate_batches(model, dataset, _loader(dataset), explainer_epochs=3)
    torch.cuda.synchronize()
    steps = {"forward": replay.replayed_forward(model).graphs,
             "explain": explain._graph_cache(model)}
    for kind, cache in steps.items():
        keys = cache.keys()
        assert keys
        for j, key in enumerate(keys):
            step = cache.get(key)
            inside, outside = _graph_device_ops(step.replay, tmp_path / f"{kind}{j}.json")
            print(f"{kind} graph {j}: {step.nodes[True]} nodes; profiler {inside} in the "
                  f"launch, {outside} outside it")
            assert step.nodes[True] == inside > 0
    spans = _since(t0, "inference.")
    fwd = {v for n, *_, v in spans if n == "inference.forward"}
    exp = {v for n, *_, v in spans if n == "inference.explain"}
    assert fwd == {steps["forward"].get(k).nodes[True] for k in steps["forward"].keys()}
    assert exp == {steps["explain"].get(k).nodes[True] for k in steps["explain"].keys()}
    assert not _since(t0, "graph.")
    print("node types by capture:", node_types)


@pytest.mark.gpu
def test_replays_under_a_profiler_equal_eager_steps(cuda):
    """Two passes over a bucket, the second under torch.profiler (every span
    then also a record_function): the eager steps' losses, predictions,
    parameters and launches, bit for bit; the second pass captures nothing
    and replays every step, each span carrying the graph's nodes."""
    mega = _megabatch(cuda)
    k = mega.n_steps
    eager, graph = Trainer(_model(), TrainConfig(seed=5), device=cuda), \
        Trainer(_model(), TrainConfig(seed=5), device=cuda)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for traced in (False, True):
        want = [eager.train_step(mega.batch(j), 1e-3) for j in range(k)]
        launches.reset()
        t0 = time.perf_counter()
        if traced:
            with torch.profiler.profile(activities=acts) as prof:
                losses, preds = graph.train_megabatch(mega, [1e-3] * k)
                torch.cuda.synchronize()
            assert "train.replay" in {e.name for e in prof.events()}
        else:
            losses, preds = graph.train_megabatch(mega, [1e-3] * k)
        torch.cuda.synchronize()
        assert {n: v for n, v in launches.snapshot().items() if v} == {
            n: v * k for n, v in PER_STEP.items()}
        assert torch.equal(losses, torch.stack([loss for loss, _ in want]))
        assert torch.equal(preds, torch.stack([pred for _, pred in want]))
        names = [n for n, *_ in _since(t0)]
        if traced:
            nodes = graph.captured_step("train", mega).nodes[True]
            assert names == ["train.upload"] + ["train.replay"] * k
            assert {v for n, *_, v in _since(t0, "train.replay")} == {nodes}
        else:
            assert names.count("graph.capture") == 1
            assert names.count("graph.warmup") == graphs.WARMUP_STEPS
    assert graph.captured_step("train", mega).launches[True] == PER_STEP
    assert all(torch.equal(a, b) for a, b in zip(eager.params, graph.params))
