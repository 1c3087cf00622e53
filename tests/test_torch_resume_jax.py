"""The port resumes train states that the JAX package wrote
(caster_dta_tpu/train/checkpoints.py ``save_train_state``): optax's
``inject_hyperparams`` state with Adam's moments as flat vectors
(optax.flatten, the JAX trainer's layout) or param trees, and a JAX key in
place of the port's dropout generator state.

Tolerances: the split of a flat moment is exact (the same f32 values in
``ravel_pytree``'s order), so the moments are held bit for bit. One resumed
epoch at dropout 0 in f32 against JAX's own resume of the same folder: epoch
losses and parameters within F32_TOL = 1e-5 relative (the same Adam step in
other sum orders, as in tests/test_torch_train.py).
"""
import json
import os
import shutil
import warnings

import jax
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from flax import serialization
from jax.flatten_util import ravel_pytree

from caster_dta_tpu.interop.torch_import import import_joint_gnn
from caster_dta_tpu.models.joint import make_joint_gnn as jax_make_joint_gnn
from caster_dta_tpu.train import checkpoints as jcheckpoints
from caster_dta_tpu.train import optim as joptim
from caster_dta_tpu.train.loop import TrainConfig as JaxTrainConfig, fit as jax_fit
from caster_dta_torch.data import batching
from caster_dta_torch.inference.checkpoint import build_model
from caster_dta_torch.interop.from_jax import state_dict_from_jax
from caster_dta_torch.models.joint import make_joint_gnn
from caster_dta_torch.train import checkpoints
from caster_dta_torch.train.loop import Trainer, TrainConfig, fit
from caster_dta_torch.train.loop import split_dataset as trainer_split

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RUNS = ("davis_finetune_ref", "davis_seed9", "kiba_short", "metz_short")
F32_TOL = 1e-5
DROPOUT_WARNING = "not the JAX run's"

KWARGS = dict(
    protein_gnn_kwargs=dict(
        base_conv="lbamodel", in_channels=[17, 3], edge_dim=[32, 1], num_ntypes=21,
        num_etypes=1, ntype_emb_dim=None, etype_emb_dim=None, num_convs=1,
        hidden_channels=[8, 2], edge_hidden_channels=[8, 1], out_channels=16,
        dropout_rate=0.0, activation="leaky_relu", aggr="sum"),
    molecule_gnn_kwargs=dict(
        base_conv="gine", in_channels=41, edge_dim=9, num_ntypes=10, num_etypes=5,
        ntype_emb_dim=None, etype_emb_dim=None, num_convs=1, hidden_channels=8,
        out_channels=16, dropout_rate=0.0, activation="leaky_relu", aggr="sum"),
    joint_gnn_kwargs=dict(
        residue_lin_depth=1, atom_lin_depth=1, n_attention_heads=4, attention_dropout=0.0,
        protein_lin_depth=1, molecule_lin_depth=1, pairwise_embedding_dim=32,
        out_lin_depth=1, activation="leaky_relu", dropout=0.0, num_cross_attn_layers=1))
# one bucket of 4 batches of up to 6 pairs
LOADER = dict(max_num=3000, max_batch_size=6)
LADDERS = dict(protein_node_ladder=(32,), edge_ladder=(256,), molecule_node_ladder=(16,),
               molecule_edge_ladder=(64,))
PER_BATCH = dict(scan_steps=False, device_data_budget=None, save_state_every=1, seed=9,
                 scheduler="plateau")


def _port_model(seed=0):
    return make_joint_gnn(KWARGS["protein_gnn_kwargs"], KWARGS["molecule_gnn_kwargs"],
                          generator=torch.Generator().manual_seed(seed),
                          **KWARGS["joint_gnn_kwargs"])


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(tree[k])
    return out


def _run_trainer(run):
    with open(os.path.join(REPO, "runs", run, "model_kwargs.json")) as f:
        kwargs = json.load(f)
    return Trainer(build_model(kwargs), TrainConfig(), device="cpu")


@pytest.mark.parametrize("run", JAX_RUNS)
def test_flat_moments_split_as_ravel_pytree(run):
    """Each JAX-written train state of the repo: the port's split of the
    flat ``mu`` and ``nu`` equals ``ravel_pytree``'s unravel on the file's
    param tree, leaf by leaf, bit for bit, and lands in the optimizer state
    in place; the JAX key seeds the dropout generator from the config, with
    one warning."""
    st = checkpoints.load_train_state(os.path.join(REPO, "runs", run))
    _, unravel = ravel_pytree(jax.tree_util.tree_map(np.asarray, st["params"]))
    trainer = _run_trainer(run)
    ported = trainer.opt_state_from_jax(st["opt_state"])
    assert ported["count"] == int(st["opt_state"]["inner_state"]["0"]["count"]) > 0
    for name in ("mu", "nu"):
        flat = np.asarray(st["opt_state"]["inner_state"]["0"][name])
        want = _leaves(jax.tree_util.tree_map(np.asarray, unravel(flat)))
        got = _leaves(ported[name])
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    trainer.set_params(st["params"])
    trainer.load_opt_state_tree(st["opt_state"])
    flat_mu = np.asarray(st["opt_state"]["inner_state"]["0"]["mu"])
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, unravel(flat_mu)), trainer.model)
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    for n, p in zip(names, trainer.params):
        state = trainer.optimizer.state[p]
        assert torch.equal(state["exp_avg"], sd[n]), n
        assert float(state["step"]) == ported["count"]
    assert st["rng"]["jax_key"].shape == (2,)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer.load_rng_state(st["rng"])
    assert sum(DROPOUT_WARNING in str(w.message) for w in caught) == 1
    assert torch.equal(trainer.generator.get_state(),
                       torch.Generator().manual_seed(TrainConfig().seed).get_state())


@pytest.mark.parametrize("run", JAX_RUNS)
def test_fit_continues_a_jax_run(run, dataset, tmp_path):
    """fit(resume=True), what the CLI's --resume calls, on each JAX-written
    train state (with its run's model_kwargs) and seeded synthetic pairs:
    one more epoch runs from the file's history and Adam's step count goes
    on from the file's."""
    src = os.path.join(REPO, "runs", run)
    for name in ("train_state.msgpack", "model_kwargs.json"):
        shutil.copy(os.path.join(src, name), tmp_path / name)
    st = checkpoints.load_train_state(str(tmp_path))
    with open(tmp_path / "model_kwargs.json") as f:
        model = build_model(json.load(f))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = fit(model, dataset, "synthetic", str(tmp_path),
                  TrainConfig(resume=True, **PER_BATCH), n_epochs=st["epoch"] + 2,
                  verbose=False, ladder_kwargs=LADDERS, device="cpu", **LOADER)
    assert res["history"][:-1] == st["history"]
    assert res["history"][-1]["epoch"] == st["epoch"] + 1
    assert np.isfinite(res["history"][-1]["train"])
    count = int(st["opt_state"]["inner_state"]["0"]["count"])
    trainer = res["trainer"]
    steps = {float(trainer.optimizer.state[p]["step"]) for p in trainer.params}
    n_batches = len(batching.BucketedLoader(dataset, trainer_split(dataset, PER_BATCH["seed"])[0], **LOADER,
                                            **LADDERS, shuffle=False))
    assert steps == {count + n_batches}


def test_flat_moment_of_the_wrong_length_is_refused():
    st = checkpoints.load_train_state(os.path.join(REPO, "runs", "davis_seed9"))
    trainer = _run_trainer("davis_seed9")
    inner = st["opt_state"]["inner_state"]["0"]
    inner["mu"] = np.asarray(inner["mu"])[:-1]
    with pytest.raises(ValueError, match="does not match|shorter"):
        trainer.opt_state_from_jax(st["opt_state"])


@pytest.fixture(scope="module")
def dataset():
    ds = batching.synthetic_pair_dataset(30, 4, 4, protein_nodes=[(10, 30)],
                                         molecule_nodes=(6, 12), seed=5)
    ds.dataframe = pd.DataFrame(index=range(len(ds)))   # JAX's split reads its index
    return ds


def _jax_params(model):
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return import_joint_gnn(sd, KWARGS)["params"]


@pytest.mark.parametrize("flat_params", [False, True])
def test_resumed_epoch_matches_jax_resume(dataset, tmp_path, flat_params):
    """The JAX package trains one epoch and writes its train state; JAX and
    the port each resume the folder for one more epoch (f32, dropout 0):
    the resumed epoch's losses and the final parameters agree within
    F32_TOL, and the port warns once about the dropout stream."""
    jm = jax_make_joint_gnn(KWARGS["protein_gnn_kwargs"], KWARGS["molecule_gnn_kwargs"],
                            **KWARGS["joint_gnn_kwargs"])
    init = _jax_params(_port_model())
    first = tmp_path / "first"
    jcfg = dict(PER_BATCH, flat_params=flat_params)
    jax_fit(jm, dataset, "synthetic", str(first), JaxTrainConfig(**jcfg), n_epochs=1,
            verbose=False, initial_params=init, ladder_kwargs=LADDERS, **LOADER)
    raw = checkpoints.unpackb(open(first / "train_state.msgpack", "rb").read())
    assert np.asarray(raw["opt_state"]["inner_state"]["0"]["mu"]).ndim == 1   # flat moments
    shutil.copytree(first, tmp_path / "jax")
    shutil.copytree(first, tmp_path / "port")

    want = jax_fit(jm, dataset, "synthetic", str(tmp_path / "jax"),
                   JaxTrainConfig(resume=True, **jcfg), n_epochs=2, verbose=False,
                   ladder_kwargs=LADDERS, **LOADER)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = fit(_port_model(seed=1), dataset, "synthetic", str(tmp_path / "port"),
                  TrainConfig(resume=True, **PER_BATCH), n_epochs=2, verbose=False,
                  ladder_kwargs=LADDERS, device="cpu", **LOADER)
    assert sum(DROPOUT_WARNING in str(w.message) for w in caught) == 1
    assert len(got["history"]) == len(want["history"]) == 2
    assert got["history"][0] == want["history"][0]          # read back from the file
    for key in ("lr", "train", "val"):
        a, b = got["history"][1][key], want["history"][1][key]
        assert abs(a - b) <= F32_TOL * abs(b), (key, a, b)
    want_params = _leaves(jax.tree_util.tree_map(np.asarray, want["params"]))
    got_params = _leaves(got["params"])
    assert got_params.keys() == want_params.keys()
    for k, w in want_params.items():
        np.testing.assert_allclose(got_params[k], w, rtol=F32_TOL, atol=F32_TOL * np.abs(w).max(),
                                   err_msg=k)


def _jax_state(tx, params):
    """An optax state after one update, as the JAX package writes it."""
    grads = jax.tree_util.tree_map(lambda p: 0.1 * jax.numpy.ones_like(p), params)
    state = tx.init(params)
    _, state = tx.update(grads, state, params)
    return serialization.to_state_dict(jax.device_get(state))


def test_tree_moments_map_by_name():
    """Moments kept as param trees (optax without flatten) map onto the
    parameters by name, bit for bit."""
    trainer = Trainer(_port_model(), TrainConfig(), device="cpu")
    params = jax.tree_util.tree_map(jax.numpy.asarray, trainer.params_tree())
    state = _jax_state(joptim.make_optimizer("adam", 1e-3, flatten=False), params)
    trainer.load_opt_state_tree(state)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state["inner_state"]["0"]["nu"]),
                             trainer.model)
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    for n, p in zip(names, trainer.params):
        assert torch.equal(trainer.optimizer.state[p]["exp_avg_sq"], sd[n]), n
        assert float(trainer.optimizer.state[p]["step"]) == 1


@pytest.mark.parametrize("layout", ["adamw", "clipped adam"])
def test_adamw_and_clipped_layouts_read(layout):
    """AdamW, and Adam after clip_by_global_norm (the JAX Trainer's chain
    with ``clip_norm``), with flat moments: read onto the trainer of the same
    config, bit for bit."""
    cfg = (dict(optimizer="adamw", weight_decay=0.01) if layout == "adamw"
           else dict(clip_norm=1.0))
    trainer = Trainer(_port_model(), TrainConfig(**cfg), device="cpu")
    params = jax.tree_util.tree_map(jax.numpy.asarray, trainer.params_tree())
    tx = joptim.make_optimizer(cfg.get("optimizer", "adam"), 1e-3, cfg.get("weight_decay", 0.0))
    if layout != "adamw":
        tx = optax.chain(optax.clip_by_global_norm(1.0), tx)
    state = _jax_state(tx, params)
    trainer.load_opt_state_tree(state)
    inner = state["inner_state"] if layout == "adamw" else state["1"]["inner_state"]
    _, unravel = ravel_pytree(jax.tree_util.tree_map(np.asarray, trainer.params_tree()))
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, unravel(inner["0"]["mu"])),
                             trainer.model)
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    for n, p in zip(names, trainer.params):
        assert torch.equal(trainer.optimizer.state[p]["exp_avg"], sd[n]), n
        assert float(trainer.optimizer.state[p]["step"]) == 1


def _unknown_layouts():
    return {
        "adam_l2": joptim.make_optimizer("adam", 1e-3, weight_decay=0.01),
        "sgd_momentum": joptim.make_optimizer("sgd", 1e-3),
        "multisteps": optax.MultiSteps(joptim.make_optimizer("adam", 1e-3), every_k_schedule=2),
    }


@pytest.mark.parametrize("layout", sorted(_unknown_layouts()))
def test_unknown_optax_layout_refused_before_anything_is_written(dataset, tmp_path, layout):
    """fit(resume=True) on a JAX train state of another optax layout raises
    ValueError and writes nothing: the folder keeps only the train state,
    byte for byte."""
    model = _port_model()
    params = jax.tree_util.tree_map(jax.numpy.asarray,
                                    Trainer(model, TrainConfig(), device="cpu").params_tree())
    tx = _unknown_layouts()[layout]
    jcheckpoints.save_train_state(
        str(tmp_path), params=params, opt_state=tx.init(params), rng=jax.random.key(0),
        epoch=0, best_train=1.0, best_val=1.0, n_since_best_val=0, lr=1e-3, history=[],
        scheduler=None)
    before = (tmp_path / "train_state.msgpack").read_bytes()
    with pytest.raises(ValueError, match="cannot resume|does not hold"):
        fit(model, dataset, "synthetic", str(tmp_path), TrainConfig(resume=True, **PER_BATCH),
            n_epochs=2, verbose=False, ladder_kwargs=LADDERS, device="cpu", **LOADER)
    assert os.listdir(tmp_path) == ["train_state.msgpack"]
    assert (tmp_path / "train_state.msgpack").read_bytes() == before
