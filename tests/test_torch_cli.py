"""The port's training CLI (caster_dta_torch/train/driver.py ``main``) on the
CPU, ``--dataset synthetic``, against the JAX package's: the run artifacts
have the JAX schemas and values for the same dataset, the JAX package's
``load_model_from_checkpoint`` serves the port's best-val checkpoint within
1e-4 pKd of the port, a resumed run equals the straight run bit for bit
(history and final parameters, as tests/test_pipeline.py holds the JAX
package's), the zero-epoch "finish" resume gives the same test metrics, and
the multi-device flags raise. The JAX side trains nothing: it builds its
dataset, reads the port's files and runs one eager forward.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from caster_dta_torch.data.batching import BucketedLoader as TorchLoader
from caster_dta_torch.inference import checkpoint as t_ckpt
from caster_dta_torch.inference import serve
from caster_dta_torch.train import checkpoints, driver
from caster_dta_torch.train.loop import TrainConfig
from caster_dta_tpu.data.batching import BucketedLoader as JaxLoader
from caster_dta_tpu.data.datasets import load_dataset as jax_load_dataset
from caster_dta_tpu.data.pairs import ProteinMoleculeDataset as JaxPMD
from caster_dta_tpu.inference.checkpoint import load_model_from_checkpoint as jax_load_model
from caster_dta_tpu.train import driver as jax_driver
from caster_dta_tpu.train import metrics as jax_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 4


def _argv(data_root, out, *more):
    return ["--dataset", "synthetic", "--data-root", str(data_root), "--out-folder", str(out),
            "--device", "cpu", "--n-workers", "0", "--seed", "9", *more]


def _history(res):
    return [(h["epoch"], h["lr"], h["train"], h["val"]) for h in res["history"]]


def _leaves(tree, out=None):
    out = [] if out is None else out
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            _leaves(tree[k], out)
        else:
            out.append(np.asarray(tree[k]))
    return out


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    res = driver.main(_argv(root / "data", root / "a", "--n-epochs", str(EPOCHS)))
    return root, res


def test_cli_artifacts_match_jax(straight):
    root, res = straight
    out = root / "a"
    names = set(os.listdir(out))
    assert {"train_command.txt", "dataset_kwargs.json", "dataset_rescale_params.json",
            "model_kwargs.json", "model_summary.txt", "model_standardprint.txt",
            "train_history.json", "test_metrics.json", "train_state.msgpack"} <= names
    assert sum(n.startswith("bestvalmodel_synthetic_val") for n in names) == 1
    assert sum(n.startswith("finalmodel_synthetic_val") for n in names) == 1
    with open(out / "train_command.txt") as f:
        assert f.read().startswith(sys.executable + " ")

    # the JAX package's dataset and artifacts for the same synthetic data
    df = jax_load_dataset("synthetic", data_root=str(root / "jax_data"))
    jd = JaxPMD(df, n_workers=0, **jax_driver.DEFAULT_DATASET_KWARGS)
    pk, mk, jk = jax_driver.default_model_kwargs(jd.metadata_dict)
    loaded = {n: json.load(open(out / n)) for n in ("dataset_kwargs.json",
                                                   "dataset_rescale_params.json",
                                                   "model_kwargs.json")}
    assert loaded["dataset_kwargs.json"] == json.loads(
        json.dumps(jax_driver.DEFAULT_DATASET_KWARGS))
    assert loaded["dataset_rescale_params.json"] == jd._report_scale_data()
    assert loaded["model_kwargs.json"] == json.loads(json.dumps(
        {"protein_gnn_kwargs": pk, "molecule_gnn_kwargs": mk, "joint_gnn_kwargs": jk}))
    assert res["dataset"].metadata_dict == jd.metadata_dict
    np.testing.assert_array_equal(res["dataset"].affinity_data, jd.affinity_data)

    history = json.load(open(out / "train_history.json"))
    assert [h["epoch"] for h in history] == list(range(EPOCHS))
    # the keys of the JAX fit's history entries (caster_dta_tpu/train/loop.py)
    assert all(set(h) == {"epoch", "lr", "train", "val", "time_s", "edges_per_s"}
               for h in history)
    metrics = json.load(open(out / "test_metrics.json"))
    assert metrics.keys() == jax_metrics.regression_report(np.arange(4.0), np.arange(4.0)).keys()
    assert all(np.isfinite(v) for v in metrics.values())


def test_jax_serves_the_port_checkpoint(straight):
    root, res = straight
    out = str(root / "a")
    ds = res["dataset"]
    df = jax_load_dataset("synthetic", data_root=str(root / "jax_data"))
    jd = JaxPMD(df, n_workers=0, **jax_driver.DEFAULT_DATASET_KWARGS)
    idx = list(range(len(ds)))
    t_batch = next(iter(TorchLoader(ds, idx, shuffle=False)))
    j_batch = next(iter(JaxLoader(jd, idx, shuffle=False)))
    np.testing.assert_array_equal(t_batch.pair_idx.numpy(), np.asarray(j_batch.pair_idx))

    run = serve.load_run(out, device="cpu")
    port_aff, _ = serve.predict(run, t_batch)
    model, variables, _ = jax_load_model(out)
    with jax.default_device(jax.devices("cpu")[0]):
        score, _ = model.apply(variables, j_batch.protein, j_batch.molecule, deterministic=True)
    jax_aff = jd.unscale_target(np.asarray(score)[:, 0])
    np.testing.assert_allclose(port_aff.numpy(), jax_aff, rtol=0, atol=1e-4)

    # the port's own loader of a run folder: the same weights
    model_t, params, kwargs = t_ckpt.load_model_from_checkpoint(out, device="cpu")
    assert kwargs == run.model_kwargs
    for a, b in zip(model_t.state_dict().values(), run.model.state_dict().values()):
        assert torch.equal(a, b)
    assert len(_leaves(params)) == len(_leaves(variables["params"]))


def test_resumed_run_equals_straight_run(straight, tmp_path):
    root, res = straight
    out = tmp_path / "b"
    first = driver.main(_argv(root / "data", out, "--n-epochs", "2"))
    assert [h["epoch"] for h in first["history"]] == [0, 1]
    st = checkpoints.load_train_state(str(out))
    assert st["epoch"] == 1 and st["opt_state"]["count"] > 0
    assert st["rng"]["device"] == "cpu" and st["rng"]["dropout"].dtype == np.uint8
    for name in ("mu", "nu"):
        assert len(_leaves(st["opt_state"][name])) == len(_leaves(st["params"]))
    # the resumed run's test metrics must not come from a pre-interrupt best file
    for f in os.listdir(out):
        if f.startswith(("bestval", "besttrain", "final")):
            os.remove(out / f)
    resumed = driver.main(_argv(root / "data", out, "--n-epochs", str(EPOCHS), "--resume"))
    assert _history(resumed) == _history(res)
    got = checkpoints.load_params(checkpoints.get_best_model(str(out), "final"))
    want = checkpoints.load_params(checkpoints.get_best_model(str(root / "a"), "final"))
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(a, b)

    # "finish": n_epochs already reached runs no epoch, then the final
    # checkpoint and the test metrics
    finished = driver.main(_argv(root / "data", out, "--n-epochs", str(EPOCHS), "--resume"))
    assert [h["epoch"] for h in finished["history"]] == list(range(EPOCHS))
    assert finished["test_metrics"] == resumed["test_metrics"]


def test_skip_training_and_checkpoint_flows(straight, tmp_path):
    root, res = straight
    a = str(root / "a")
    report = driver.main(_argv(root / "data", tmp_path / "c", "--skip-training",
                               "--checkpoint", a))
    assert report == res["test_metrics"]
    # --checkpoint without --skip-training fine-tunes from the checkpoint's
    # weights and kwargs: zero epochs leave them as they were
    best = checkpoints.get_best_model(a, "val")
    tuned = driver.main(_argv(root / "data", tmp_path / "d", "--n-epochs", "0",
                              "--checkpoint", best))
    assert tuned["history"] == []
    with open(os.path.join(a, "model_kwargs.json")) as f, \
            open(tmp_path / "d" / "model_kwargs.json") as g:
        assert json.load(f) == json.load(g)
    got = checkpoints.load_params(checkpoints.get_best_model(str(tmp_path / "d"), "final"))
    for x, y in zip(_leaves(got), _leaves(checkpoints.load_params(best))):
        np.testing.assert_array_equal(x, y)


def test_dataset_with_checkpoint_params(straight, tmp_path):
    root, res = straight
    ds = t_ckpt.create_dataset_with_checkpoint_params(res["dataset"].records, str(root / "a"),
                                                      cache_dir=str(tmp_path), n_workers=0)
    assert ds.metadata_dict == res["dataset"].metadata_dict
    assert ds._report_scale_data() == res["dataset"]._report_scale_data()
    assert any(n.startswith("dataset_torch_") for n in os.listdir(tmp_path))
    np.testing.assert_array_equal(ds.unscale_target(ds.affinity_data),
                                  res["dataset"].unscale_target(res["dataset"].affinity_data))


def test_cache_prefix_differs_from_jax(straight):
    root, _ = straight
    names = os.listdir(root / "data" / "cache")
    assert names and all(n.startswith(driver.CACHE_PREFIX) for n in names)
    assert not any(n.startswith("00_datasetobj__") for n in names)


@pytest.mark.parametrize("flag", [["--n-dp", "2"], ["--gp", "2"], ["--coordinator", "h:1"],
                                  ["--n-processes", "2"], ["--process-id", "0"]])
def test_multi_device_flags_refused(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        driver.main(_argv(tmp_path / "data", tmp_path / "x", *flag))
    assert not (tmp_path / "data").exists()   # refused before any work


def test_train_config_refusals_and_defaults():
    cfg = TrainConfig()
    assert (cfg.save_state_every, cfg.resume, cfg.log_every) == (25, False, 0)
    for kw in (dict(n_dp=2), dict(gp=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
            TrainConfig(**kw)
    TrainConfig(n_dp=1, gp=1, resume=True, save_state_every=0)


def _reference_run(tmp_path, keys=lambda k: k, molecule=None):
    """A run folder with runs/davis_seed9's model_kwargs.json (its molecule
    tower swapped for ``molecule``) and the seeded random state dict of the
    reference-named TorchJointGNN (tests/ref_torch_exec.py) saved with
    torch.save under ``keys(name)`` -> (mirror, kwargs, .pt path)."""
    from tests.ref_torch_exec import TorchJointGNN

    with open(os.path.join(REPO, "runs", "davis_seed9", "model_kwargs.json")) as f:
        kwargs = json.load(f)
    torch.manual_seed(11)
    mirror = TorchJointGNN(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                           **kwargs["joint_gnn_kwargs"]).eval()
    with torch.no_grad():   # a non-zero eps, as a trained model has
        for conv in mirror.molecule_gnn.gnn_model.conv_list:
            conv.eps.fill_(0.25)
    if molecule is not None:
        kwargs["molecule_gnn_kwargs"]["base_conv"] = molecule
    (tmp_path / "model_kwargs.json").write_text(json.dumps(kwargs))
    path = tmp_path / "bestmodel_davis.pt"
    torch.save({keys(k): v for k, v in mirror.state_dict().items()}, path)
    return mirror, kwargs, str(path)


def _reference_pairs():
    """tests/test_golden_parity.py's probe pairs, atom types below the run's
    10 (the mirror one-hot encodes them)."""
    from tests.test_golden_parity import _random_pair_graphs

    pairs = _random_pair_graphs(np.random.default_rng(7))
    for p in pairs:
        p["m_ntype"] = np.minimum(p["m_ntype"], 9)
    return pairs


def test_reference_pt_checkpoints_refused(tmp_path):
    """A .pt run whose towers the JAX package's importer does not take (here
    GIN for molecules) is refused by both packages, with JAX's words."""
    _, _, path = _reference_run(tmp_path, molecule="gin")
    with pytest.raises(NotImplementedError, match="lbamodel .protein. . gine .molecule.; got "
                                                  "lbamodel/gin"):
        t_ckpt.load_model_from_checkpoint(str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="got lbamodel/gin"):
        jax_load_model(str(tmp_path), param_file=path)


def test_reference_pt_checkpoint_serves_as_jax_and_the_reference(tmp_path):
    """The reference-named state dict loads strictly onto the port's
    JointGNN (the GVPs' dummy_param entries dropped) and serves within 1e-4
    pKd of the JAX package's load of the same file and of the mirror's own
    forward; the JAX tree it returns is the one JAX's importer builds."""
    from tests.test_golden_parity import _jax_batches, _torch_batch
    from tests.test_torch_zoo_models import _torch_graph

    mirror, kwargs, path = _reference_run(tmp_path)
    model, params, model_kwargs = t_ckpt.load_model_from_checkpoint(str(tmp_path), device="cpu")
    assert model_kwargs == kwargs and not model.training
    jm, variables, _ = jax_load_model(str(tmp_path), param_file=path)
    for a, b in zip(_leaves(params), _leaves(jax.device_get(variables["params"]))):
        np.testing.assert_array_equal(a, b)
    pairs = _reference_pairs()
    pg, mg = _jax_batches(pairs)
    with torch.no_grad():
        score, _ = model(_torch_graph(pg), _torch_graph(mg))
        ref, _ = mirror(*_torch_batch(pairs), b=len(pairs))
    j_score, _ = jm.apply(variables, pg, mg)
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score), rtol=0, atol=1e-4)
    np.testing.assert_allclose(score.numpy(), ref.numpy(), rtol=0, atol=1e-4)


def test_reference_pt_checkpoint_with_compile_prefixes(tmp_path):
    """torch.compile's ``_orig_mod.`` prefixes are stripped: the same
    weights as the plain file's, bit for bit."""
    for name, keys in (("plain", lambda k: k), ("compiled", lambda k: "_orig_mod." + k)):
        (tmp_path / name).mkdir()
        _reference_run(tmp_path / name, keys=keys)
    plain = t_ckpt.load_model_from_checkpoint(str(tmp_path / "plain"), device="cpu")[0]
    compiled = t_ckpt.load_model_from_checkpoint(str(tmp_path / "compiled"), device="cpu")[0]
    want = plain.state_dict()
    got = compiled.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_log_every_prints_progress(straight, tmp_path, capsys):
    root, _ = straight
    from caster_dta_torch.train.loop import Trainer
    ds = straight[1]["dataset"]
    model = t_ckpt.build_model(json.load(open(root / "a" / "model_kwargs.json")))
    trainer = Trainer(model, TrainConfig(log_every=1, device_data_budget=None), device="cpu")
    loader = TorchLoader(ds, None, max_batch_size=4, seed=0)
    trainer.train_epoch(loader, 1e-4, epoch=3)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("  E 3 batch")]
    assert len(lines) == len(loader)
