"""Each configuration's plain reference agrees with caster_dta_torch on the
CPU at a tiny size, on seeded weights and one padded batch: the eval
forward (scores and both attention maps), three Adam steps with dropout
drawn from the same seed (losses, first gradients, weights), and the
explainer's masks. f32 on both sides: only the order of sums differs."""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

import bench_tiny

REPO = bench_tiny.REPO
sys.path[:0] = [os.path.join(REPO, "benchmark"), REPO]

from benchlib import batches, model as model_mod, spec, traffic  # noqa: E402

CONFIGS = ["caster-lba-gine", "caster-cpd-gatv2"]
TOL = 2e-5


def _setup(config: str, seed: int = 3):
    conf = spec.load_json(os.path.join(REPO, "benchmark", "configs", config + ".json"))
    plain = spec.load_module(os.path.join(REPO, "benchmark", "reference", "plain.py"),
                             "bench_reference_plain")
    mix = {"targets": {"table": "davis_sizes.json", "select": "quantiles", "count": 3},
           "ligands": {"count": 4, "atoms": [6, 10], "tail_share": 0.1, "tail_atoms": [11, 14],
                       "rings": [1, 3]}, "size_seed": 1}
    t = traffic.generate(mix, seed)
    t.proteins = {k: traffic.protein_graph(np.random.default_rng(k), 20 + 7 * k, 50 + 17 * k)
                  for k in t.proteins}
    kw = conf["model_kwargs"]
    weights = model_mod.make_weights(plain.param_shapes(kw), seed, torch.device("cpu"))
    ids = list(range(len(t.pairs)))[:6]
    bucket = (48, 256, 16, 64)
    return plain, kw, t, weights, ids, bucket


def _port_batch(rb: dict):
    from caster_dta_torch.data.graphs import GraphBatch

    return (GraphBatch(**rb["protein"]), GraphBatch(**rb["molecule"]))


@pytest.mark.parametrize("config", CONFIGS)
def test_forward_agrees(config):
    from caster_dta_torch.inference.replay import forward

    plain, kw, t, weights, ids, bucket = _setup(config)
    rb = batches.reference_batch(t, ids, bucket, "cpu")
    model = model_mod.port_model(kw, weights, "cpu").eval()
    got = forward(model, *_port_batch(rb))
    ref = plain.predict(kw, weights, rb["protein"], rb["molecule"], plain.Precision("f32"))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("config", CONFIGS)
def test_three_steps_with_dropout_agree(config):
    from caster_dta_torch.train.loop import TrainConfig, Trainer

    plain, kw, t, weights, ids, bucket = _setup(config)
    target = np.linspace(-1, 1, len(ids)).astype(np.float32)
    weight = np.ones(len(ids), np.float32)
    weight[-1] = 0.0
    rb = batches.reference_batch(t, ids, bucket, "cpu", target, weight)
    model = model_mod.port_model(kw, weights, "cpu")
    trainer = Trainer(model, TrainConfig(lr=1e-3, seed=2147483659, scan_steps=False),
                      device="cpu")
    from caster_dta_torch.data.batching import PairBatch

    batch = PairBatch(*_port_batch(rb), rb["target"], rb["weight"],
                      torch.arange(len(ids), dtype=torch.int32))
    losses = [float(trainer.train_step(batch)[0]) for _ in range(3)]
    ref = plain.train_steps(kw, weights, [rb] * 3, 1e-3, 2147483659, plain.Precision("f32"))
    np.testing.assert_allclose(losses, ref["loss"], rtol=TOL)
    final = dict(trainer.model.named_parameters())
    for name, change in ref["change"][2].items():
        torch.testing.assert_close(final[name].detach() - weights[name], change, atol=TOL,
                                   rtol=1e-3)


def test_explainer_agrees():
    from caster_dta_torch.inference.explain import DTAModelExplainer

    plain, kw, t, weights, ids, bucket = _setup("caster-lba-gine")
    rb = batches.reference_batch(t, ids, bucket, "cpu")
    model = model_mod.port_model(kw, weights, "cpu").eval()
    got = DTAModelExplainer(model, n_epochs=4).explain_model(*_port_batch(rb))
    drv = spec.load_module(os.path.join(REPO, "benchmark", "benchlib", "runners", "screen.py"))
    init = {(side, kind): drv._initial_logits(tuple(rb[side][f"{kind}_mask"].shape), j, "cpu")
            for side in ("protein", "molecule") for j, kind in enumerate(("node", "edge"))}
    ref = plain.explain(kw, weights, rb["protein"], rb["molecule"], init, plain.Precision("f32"),
                        n_epochs=4)
    for k in ("protein", "molecule", "protein_edges", "molecule_edges"):
        torch.testing.assert_close(got[k], ref[k], atol=TOL, rtol=TOL)
