"""The harness finds its parts by name, a later configuration, mix or metric
needs only new files and entries, the result line keeps the contract's
keys, the no-JAX check compares whole top-level names, the mixes make the
same inputs from the same seed, and a run with no card, or with no program,
prints no result."""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import bench_tiny

REPO = bench_tiny.REPO
BENCH = os.path.join(REPO, "benchmark")
sys.path[:0] = [BENCH, REPO]

from benchlib import spec, traffic  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_resolves():
    b = _bench()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        plain = cell.reference()
        assert plain.param_shapes(cell.config["model_kwargs"])
        assert os.path.isfile(os.path.join(BENCH, "benchlib", "runners",
                                           cell.mix["runner"] + ".py"))
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(m["name"]).read)


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        reports = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert any(m["name"] == "setup_s" for m in reports) and len(reports) >= 2
        assert any(w["name"] in m.get("workloads", cells) for m in b["per_layer"])
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    n = 24                          # what has to fit: the full 24 cells
    assert (2 + 14 * n) * (b["run_seconds"] + 60) + n * 180 + 1200 <= 43200


def _hashes(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if "__pycache__" not in p:
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_added_config_mix_and_metric_need_no_edit(tmp_path):
    root = bench_tiny.tiny_copy(str(tmp_path))
    b = os.path.join(root, "benchmark")
    before = _hashes(root)
    before.pop("BENCHMARK.json")
    # a new configuration (its file and its reference), mix and metric: files only
    with open(os.path.join(b, "configs", "caster-lba-gine.json")) as f:
        conf = json.load(f)
    conf["name"] = "lba-gine-wide"
    conf["model_kwargs"]["joint_gnn_kwargs"]["pairwise_embedding_dim"] = 256
    with open(os.path.join(b, "configs", "lba-gine-wide.json"), "w") as f:
        json.dump(conf, f)
    shutil.copy(os.path.join(b, "reference", "caster-lba-gine.py"),
                os.path.join(b, "reference", "lba-gine-wide.py"))
    with open(os.path.join(b, "mixes", "train-davis.json")) as f:
        mix = json.load(f)
    mix["split"] = [0.6, 0.2, 0.2]
    with open(os.path.join(b, "mixes", "train-small.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(b, "limits", "train-small.wide.json"), "w") as f:
        json.dump({"loss_rel": 1e-3, "grad_norm_rel": 1e-3, "change_rel": 1e-3,
                   "replay_grad_rel": 1e-3, "replay_change_rel": 1e-3, "val_pred_abs": 1e-3}, f)
    with open(os.path.join(b, "metrics", "epochs_in_window.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.measure.get('epochs')\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "lba-gine-wide", "source": "https://example.org",
                             "file": "benchmark/configs/lba-gine-wide.json",
                             "reduced": ["joint_gnn_kwargs"], "why": "test"})
    bench["workloads"].append({"name": "train-small.wide", "config": "lba-gine-wide",
                               "traffic": "train-small", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_pairs_per_s":
            m["workloads"].append("train-small.wide")
    bench["end_to_end"].append({"name": "epochs_in_window", "unit": "epochs", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["train-small.wide"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    line = bench_tiny.run(root, "train-small.wide", 7)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"train_pairs_per_s", "setup_s", "epochs_in_window"}
    after = _hashes(root)
    assert {k: after[k] for k in before} == before


def test_result_line_has_the_contracts_keys(tmp_path):
    root = bench_tiny.tiny_copy(str(tmp_path))
    line = bench_tiny.run(root, "explain-screen.lba-gine", 11)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def test_forbidden_modules_compare_whole_top_level_names():
    import run

    loaded = ["caster_dta_torch", "caster_dta_torch.ops", "caster_dta_tpux", "jaxtyping",
              "flaxen.x", "jax", "jax.numpy", "caster_dta_tpu.nn", "optax._src", "jaxlib"]
    assert run.forbidden_modules(loaded) == ["caster_dta_tpu.nn", "jax", "jax.numpy", "jaxlib",
                                             "optax._src"]


@pytest.mark.parametrize("mix_name", ["train-davis", "explain-screen"])
def test_mix_makes_the_same_inputs_from_the_same_seed(mix_name):
    mix = spec.load_json(os.path.join(BENCH, "mixes", mix_name + ".json"))
    mix = dict(mix, ligands=dict(mix["ligands"], count=min(mix["ligands"]["count"], 68)))
    a, b = traffic.generate(mix, 4294967311), traffic.generate(mix, 4294967311)
    c = traffic.generate(mix, 12345)
    assert a.pairs == b.pairs and np.array_equal(a.targets, b.targets)
    for k in a.proteins:
        for f in ("node_s", "node_v", "edge_index", "edge_s", "edge_v", "node_type"):
            assert np.array_equal(a.proteins[k][f], b.proteins[k][f])
    for k in a.molecules:
        assert np.array_equal(a.molecules[k]["edge_index"], b.molecules[k]["edge_index"])
    sizes = lambda t: sorted((g["n_nodes"], g["n_edges"]) for g in t.proteins.values())  # noqa
    assert sizes(a) == sizes(c)
    assert sorted(g["n_edges"] for g in a.molecules.values()) == \
        sorted(g["n_edges"] for g in c.molecules.values())
    assert not np.array_equal(a.proteins[0]["node_s"], c.proteins[0]["node_s"])


def _cli(root: str):
    return subprocess.run([sys.executable, os.path.join(root, "benchmark", "run.py"),
                           "--workload", "explain-screen.lba-gine", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=root, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    proc = _cli(REPO)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    proc = _cli(str(tmp_path))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
