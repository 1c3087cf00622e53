"""Port parity for training: caster_dta_torch's train step, optimizers,
schedulers, loader, metrics, checkpoints and ``fit`` against caster_dta_tpu
on the same seeded numpy inputs and the same weights, on the CPU.

The port's random init goes to the JAX package through its own importer
(``import_joint_gnn``), so both trainers start from the same weights.
Dropout is 0 in the parity cases: the two packages draw their masks from
different generators. On the JAX side in bf16, ``segment.USE_PALLAS`` is on,
so its backward runs the TPU kernels' f32-accumulating VJPs in interpret
mode, as the port's kernels accumulate in f32.

Tolerances: f32 losses within 1e-5 relative per step and parameters within
1e-5 absolute after the steps (the same sums in other orders); bf16 losses
within 2e-2 relative (bf16 rounding in other places of the two libraries'
matmuls and reductions).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from caster_dta_tpu.data import batching as jbatching
from caster_dta_tpu.interop.torch_import import import_joint_gnn
from caster_dta_tpu.models.joint import make_joint_gnn as jax_make_joint_gnn
from caster_dta_tpu.ops import segment as jseg
from caster_dta_tpu.train import checkpoints as jcheckpoints
from caster_dta_tpu.train import metrics as jmetrics
from caster_dta_tpu.train import optim as joptim
from caster_dta_tpu.train.loop import Trainer as JaxTrainer, TrainConfig as JaxTrainConfig
from caster_dta_torch.data import batching
from caster_dta_torch.inference import serve
from caster_dta_torch.interop.from_jax import to_jax_params
from caster_dta_torch.models.joint import make_joint_gnn
from caster_dta_torch.nn.common import compute_dtype, get_compute_dtype
from caster_dta_torch.train import checkpoints, metrics, optim
from caster_dta_torch.train.loop import Trainer, TrainConfig, fit, split_dataset

F32_TOL = 1e-5
BF16_LOSS_RTOL = 2e-2

KWARGS = dict(
    protein_gnn_kwargs=dict(
        base_conv="lbamodel", in_channels=[17, 3], edge_dim=[32, 1], num_ntypes=21,
        num_etypes=1, ntype_emb_dim=None, etype_emb_dim=None, num_convs=2,
        hidden_channels=[8, 2], edge_hidden_channels=[8, 1], out_channels=16,
        dropout_rate=0.0, activation="leaky_relu", aggr="sum"),
    molecule_gnn_kwargs=dict(
        base_conv="gine", in_channels=41, edge_dim=9, num_ntypes=10, num_etypes=5,
        ntype_emb_dim=None, etype_emb_dim=None, num_convs=2, hidden_channels=8,
        out_channels=16, dropout_rate=0.0, activation="leaky_relu", aggr="sum",
        gin_trainable_eps=True),
    joint_gnn_kwargs=dict(
        residue_lin_depth=1, atom_lin_depth=1, n_attention_heads=4, attention_dropout=0.0,
        protein_lin_depth=1, molecule_lin_depth=1, pairwise_embedding_dim=32,
        out_lin_depth=1, out_lin_factor=0.5, out_lin_norm_type=None,
        activation="leaky_relu", dropout=0.0, element_pooling="mean",
        include_residual_stream=True, residual_dim_ff_scale=2, num_cross_attn_layers=1,
        include_post_pool_layernorm=False))
BUCKET = (3, 24, 160, 12, 40)   # B, N_P, E_P, N_M, E_M


@pytest.fixture(autouse=True)
def _compute_dtype_does_not_leak():
    """No test starts or ends inside a compute-dtype context: a bf16
    trainer's setting lives only around its own steps."""
    assert get_compute_dtype() is None
    yield
    assert get_compute_dtype() is None


def _port_model(seed=0):
    return make_joint_gnn(KWARGS["protein_gnn_kwargs"], KWARGS["molecule_gnn_kwargs"],
                          generator=torch.Generator().manual_seed(seed),
                          **KWARGS["joint_gnn_kwargs"])


def _jax_params(model):
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return import_joint_gnn(sd, KWARGS)["params"]


def _run_both(monkeypatch, n_steps, compute, **cfg):
    """n_steps train steps of both packages from the same weights on the same
    batch -> (jax losses, port losses, jax params, port params)."""
    if compute == "bfloat16":
        monkeypatch.setattr(jseg, "USE_PALLAS", True)
    model = _port_model()
    jb = graft._synthetic_batch(*BUCKET, seed=1)
    tb = batching.synthetic_pair_batch(*BUCKET, seed=1)
    jm = jax_make_joint_gnn(KWARGS["protein_gnn_kwargs"], KWARGS["molecule_gnn_kwargs"],
                            **KWARGS["joint_gnn_kwargs"])
    jt = JaxTrainer(jm, JaxTrainConfig(compute_dtype=compute, device_data_budget=None, **cfg),
                    jb)
    jt.set_params(_jax_params(model))
    tt = Trainer(model, TrainConfig(compute_dtype=compute, **cfg), device="cpu")
    p, o, rng = jt.params, jt.opt_state, jt.rng
    j_losses, t_losses = [], []
    for _ in range(n_steps):
        p, o, loss, _, rng = jt._train_step(p, o, jb, rng, np.float32(jt.config.lr))
        j_losses.append(float(loss))
        t_losses.append(float(tt.train_step(tb)[0]))
    return np.array(j_losses), np.array(t_losses), jax.device_get(p), tt.params_tree()


def _max_leaf_diff(a, b):
    diffs = jax.tree_util.tree_map(lambda x, y: float(np.abs(np.asarray(x) - y).max()), a, b)
    return max(jax.tree_util.tree_leaves(diffs))


def test_adam_steps_match_jax_f32(monkeypatch):
    j_losses, t_losses, jp, tp = _run_both(monkeypatch, 3, None)
    np.testing.assert_allclose(t_losses, j_losses, rtol=F32_TOL)
    assert t_losses[-1] < t_losses[0]
    assert _max_leaf_diff(jp, tp) <= F32_TOL


def test_adam_steps_match_jax_bf16(monkeypatch):
    j_losses, t_losses, _, _ = _run_both(monkeypatch, 3, "bfloat16")
    np.testing.assert_allclose(t_losses, j_losses, rtol=BF16_LOSS_RTOL)


def test_clip_and_grad_accumulation_match_optax(monkeypatch):
    """clip_by_global_norm (a norm small enough to clip every update) under
    MultiSteps(k=2): 4 steps apply two clipped running means; the first and
    third step leave the parameters as they were."""
    j_losses, t_losses, jp, tp = _run_both(monkeypatch, 4, None, clip_norm=0.05,
                                           grad_accum=2)
    np.testing.assert_allclose(t_losses, j_losses, rtol=F32_TOL)
    assert t_losses[0] == t_losses[1] and t_losses[2] == t_losses[3]
    assert t_losses[2] != t_losses[1]
    assert _max_leaf_diff(jp, tp) <= F32_TOL


def test_grad_accumulation_advances_adam_only_on_the_kth_step():
    model = _port_model()
    tt = Trainer(model, TrainConfig(grad_accum=3), device="cpu")
    tb = batching.synthetic_pair_batch(*BUCKET, seed=1)
    before = [p.detach().clone() for p in tt.params]
    for _ in range(2):
        tt.train_step(tb)
    assert all(torch.equal(a, p) for a, p in zip(before, tt.params))
    assert not tt.optimizer.state
    tt.train_step(tb)
    assert not all(torch.equal(a, p) for a, p in zip(before, tt.params))
    assert {int(s["step"]) for s in tt.optimizer.state.values()} == {1}


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "sgd_nomomentum"])
def test_optimizers_match_optax(name):
    """One parameter vector, a scripted gradient sequence, lr changed per
    step through param_groups and through optax's injected hyperparams."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(17,)).astype(np.float32)
    grads = rng.normal(size=(5, 17)).astype(np.float32)
    lrs = [1e-2, 5e-3, 5e-3, 2e-3, 1e-3]
    wd = 0.01 if name in ("adam", "adamw") else 0.0
    tx = joptim.make_optimizer(name, lrs[0], weight_decay=wd, flatten=False)
    jp = jax.numpy.asarray(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optim.make_optimizer(name, [tp], lrs[0], weight_decay=wd)
    for g, lr in zip(grads, lrs):
        joptim.set_learning_rate(state, lr)
        updates, state = tx.update(jax.numpy.asarray(g), state, jp)
        jp = jp + updates
        optim.set_learning_rate(opt, lr)
        tp.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def _scheduler_pairs():
    base = 1e-3
    return [
        ("plateau", joptim.make_scheduler("plateau", base), optim.make_scheduler("plateau", base)),
        ("plateau p2", joptim.ReduceLROnPlateau(base, factor=0.5, patience=2, min_lr=2e-4),
         optim.ReduceLROnPlateau(base, factor=0.5, patience=2, min_lr=2e-4)),
        ("cosine", joptim.make_scheduler("cosine", base), optim.make_scheduler("cosine", base)),
        ("anneal_restart", joptim.make_scheduler("anneal_restart", base),
         optim.make_scheduler("anneal_restart", base)),
        ("anneal_restart_decay", joptim.make_scheduler("anneal_restart_decay", base),
         optim.make_scheduler("anneal_restart_decay", base)),
        ("restart T_mult 2", joptim.CosineAnnealingWarmRestarts(base, T_0=3, T_mult=2),
         optim.CosineAnnealingWarmRestarts(base, T_0=3, T_mult=2)),
        ("exponential", joptim.make_scheduler("exponential", base),
         optim.make_scheduler("exponential", base)),
    ]


def test_schedulers_match_jax():
    """A scripted run: fractional epochs for the batch schedulers, a
    validation metric that improves, plateaus (ties count as no
    improvement), and improves again."""
    metric = np.concatenate([np.linspace(1.0, 0.5, 20), np.full(60, 0.5),
                             np.linspace(0.49, 0.3, 10), np.full(70, 0.3)])
    for name, js, ts in _scheduler_pairs():
        got, want = [], []
        for k, m in enumerate(metric):
            epoch = k * 0.37
            want += [js.step(epoch=epoch), js.step(metric=float(m))]
            got += [ts.step(epoch=epoch), ts.step(metric=float(m))]
        assert got == want, name
        assert len(set(got)) > 1, name
    assert optim.BATCH_SCHEDULERS == joptim.BATCH_SCHEDULERS
    assert optim.make_scheduler(None, 1e-3) is None
    with pytest.raises(ValueError):
        optim.make_scheduler("step", 1e-3)


def test_plateau_steps_on_strict_improvement_only():
    """metric < best, not torch's relative threshold of 1e-4."""
    s = optim.ReduceLROnPlateau(1.0, factor=0.5, patience=1)
    for m in (1.0, 0.99999, 0.99998, 0.99997):
        assert s.step(metric=m) == 1.0


def test_metrics_match_jax(rng):
    pred = rng.normal(size=200)
    target = np.round(pred + rng.normal(size=200) * 0.5, 1)   # ties in y_true
    pred[::7] = pred[1::7][:len(pred[::7])]                    # ties in y_pred
    assert metrics.regression_report(pred, target) == jmetrics.regression_report(pred, target)


@pytest.fixture(scope="module")
def dataset():
    """Pairs of 6 proteins (10-40 residues) and 5 molecules (6-14 atoms)."""
    return batching.synthetic_pair_dataset(40, 6, 5, protein_nodes=[(10, 40)],
                                           molecule_nodes=(6, 14), seed=3)


LADDERS = dict(protein_node_ladder=(16, 32, 48), edge_ladder=(128, 256, 512),
               molecule_node_ladder=(8, 16), molecule_edge_ladder=(32, 64))


def test_bucketed_loader_matches_jax(dataset):
    """Same buckets, coalescing, epoch-indexed shuffle and padded batches,
    in the same order, over two epochs."""
    kw = dict(max_num=3000, max_batch_size=6, shuffle=True, seed=5, coalesce_min_batches=1,
              **LADDERS)
    jl = jbatching.BucketedLoader(dataset, list(range(len(dataset))), **kw)
    tl = batching.BucketedLoader(dataset, list(range(len(dataset))), **kw)
    assert len(tl) == len(jl) and tl.buckets() == jl.buckets()
    assert len(tl.buckets()) >= 2
    for _ in range(2):
        n = 0
        for jb, tb in zip(jl, tl):
            assert tb.bucket == jb.bucket
            assert tl.last_batch_edges == jl.last_batch_edges
            for side in ("protein", "molecule"):
                for name in ("node_s", "node_v", "node_type", "node_mask", "edge_src",
                             "edge_dst", "edge_s", "edge_v", "edge_type", "edge_mask"):
                    np.testing.assert_array_equal(getattr(getattr(tb, side), name).numpy(),
                                                  np.asarray(getattr(getattr(jb, side), name)))
            for name in ("target", "weight", "pair_idx"):
                np.testing.assert_array_equal(getattr(tb, name).numpy(), getattr(jb, name))
            n += 1
        assert n == len(tl)
    assert batching.dataset_budgets("kiba") == jbatching.dataset_budgets("kiba")
    assert batching.dataset_budgets("davis") == jbatching.dataset_budgets("davis")


def test_dataset_scaling_round_trips(dataset):
    raw = np.array([dataset.unscale_target(dataset[i][2]) for i in range(len(dataset))])
    for kinds in (["standardize"], ["minmax"], ["log", "standardize"]):
        ds = batching.PairDataset(dataset.protein_data, dataset.molecule_data,
                                  list(dataset.pair_indices.values()), raw, kinds)
        np.testing.assert_allclose(ds.unscale_target(ds.affinity_data), raw, rtol=1e-5)
        assert ds.rescale_params()["scale_output"] == kinds


def test_to_jax_params_is_the_importers_tree():
    model = _port_model(seed=7)
    mine = to_jax_params(model)
    want = _jax_params(model)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(want)
    assert _max_leaf_diff(want, mine) == 0.0


def test_split_matches_jax(dataset):
    class WithFrame:      # the JAX split reads a dataframe's columns
        dataframe = type("Frame", (), {"columns": ()})()

        def __len__(self):
            return len(dataset)

    from caster_dta_tpu.train.loop import split_dataset as jax_split
    assert split_dataset(dataset, 9) == jax_split(WithFrame(), 9)


@pytest.mark.parametrize("field,value", [("n_dp", 2), ("gp", 2)])
def test_unported_config_fields_raise(field, value):
    """Multi-device training is ported (parallel/): n_dp and gp take a rank
    count, and a count below 1 raises."""
    assert getattr(TrainConfig(**{field: value}), field) == value
    with pytest.raises(ValueError, match=field):
        TrainConfig(**{field: 0})
    TrainConfig(n_dp=1, gp=1)


@pytest.mark.parametrize("field,value", [("resume", True), ("save_state_every", 25)])
def test_ported_config_fields_accepted(field, value):
    """Train-state checkpoints and resume are ported (train/checkpoints.py
    save_train_state, fit's resume): the fields take any value."""
    assert getattr(TrainConfig(**{field: value}), field) == value


def test_trainer_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_port_model(), TrainConfig())


def test_eval_loss_is_the_masked_loss_without_dropout():
    """eval_loss: the weighted MSE of the real pairs of a padded batch, with
    dropout off, and it leaves no gradient behind."""
    kwargs = json.loads(json.dumps(KWARGS))
    kwargs["joint_gnn_kwargs"]["dropout"] = 0.5
    model = make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                           generator=torch.Generator().manual_seed(0),
                           **kwargs["joint_gnn_kwargs"])
    tt = Trainer(model, TrainConfig(), device="cpu")
    tb = batching.synthetic_pair_batch(*BUCKET, seed=1)
    tb.weight[-1] = 0.0                                   # a padding pair
    pred = tt.eval_step(tb)
    want = ((pred - tb.target)[:-1] ** 2).mean()
    got = tt.eval_loss(tb)
    torch.testing.assert_close(got, want)
    assert torch.equal(got, tt.eval_loss(tb)) and not got.requires_grad


def test_compute_dtype_is_scoped():
    with compute_dtype(torch.bfloat16):
        assert get_compute_dtype() is torch.bfloat16
        with compute_dtype(None):
            assert get_compute_dtype() is None
        assert get_compute_dtype() is torch.bfloat16
    model = _port_model()
    Trainer(model, TrainConfig(compute_dtype="bfloat16"), device="cpu").train_step(
        batching.synthetic_pair_batch(*BUCKET, seed=1))
    assert get_compute_dtype() is None
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_fit_writes_checkpoints_that_jax_reads_and_load_run_serves(dataset, tmp_path):
    """Two epochs of fit on the CPU: the best-val file reads back in the JAX
    package equal to the port's own reading, and serve.load_run serves it."""
    out = str(tmp_path / "run")
    pk, mk, jk = (KWARGS[k] for k in ("protein_gnn_kwargs", "molecule_gnn_kwargs",
                                      "joint_gnn_kwargs"))
    checkpoints.save_run_artifacts(out, {"dataset": "synthetic"}, dataset.rescale_params(),
                                   pk, mk, jk)
    cfg = TrainConfig(n_epochs=2, lr=1e-3, compute_dtype="bfloat16", seed=1)
    res = fit(_port_model(seed=2), dataset, "synthetic", out, cfg, max_num=3000,
              max_batch_size=6, verbose=False, ladder_kwargs=LADDERS, device="cpu")
    assert len(res["history"]) == 2
    assert set(res["test_metrics"]) == {"mse", "rmse", "mae", "pearson", "concordance_index"}
    assert np.isfinite(res["best_val"]) and res["throughput"]["total_steps"] > 0
    names = sorted(os.listdir(out))
    assert sum(n.startswith("bestvalmodel_synthetic_val") for n in names) == 1
    assert sum(n.startswith("besttrainmodel_synthetic_train") for n in names) == 1
    assert sum(n.startswith("finalmodel_synthetic_val") for n in names) == 1
    for name in ("model_summary.txt", "model_standardprint.txt", "model_kwargs.json",
                 "dataset_kwargs.json", "dataset_rescale_params.json", "train_command.txt"):
        assert name in names

    best = checkpoints.get_best_model(out, "val")
    assert best == jcheckpoints.get_best_model(out, "val")
    template = _jax_params(_port_model())
    theirs = jcheckpoints.load_params(template, best)
    mine = checkpoints.load_params(best)
    assert jax.tree_util.tree_structure(theirs) == jax.tree_util.tree_structure(mine)
    assert _max_leaf_diff(theirs, mine) == 0.0

    run = serve.load_run(out, device="cpu")
    assert run.param_file == best
    with open(os.path.join(out, "model_kwargs.json")) as f:
        assert json.load(f)["joint_gnn_kwargs"] == jk
    aff, _ = serve.predict(run, batching.synthetic_pair_batch(*BUCKET, seed=4))
    assert aff.shape == (BUCKET[0],) and bool(torch.isfinite(aff).all())


def test_f32_precision_is_scoped_to_predict_and_the_trainer():
    """predict and every Trainer step and eval run with IEEE f32 matmuls and
    convolutions (no TF32), and leave the process's settings as they were."""
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    saved = (matmul.fp32_precision, conv.fp32_precision)
    seen = []
    model = _port_model()
    model.register_forward_pre_hook(
        lambda module, args: seen.append((matmul.fp32_precision, conv.fp32_precision)))
    tb = batching.synthetic_pair_batch(*BUCKET, seed=1)
    try:
        matmul.fp32_precision = conv.fp32_precision = "tf32"
        trainer = Trainer(model, TrainConfig(), device="cpu")
        trainer.train_step(tb)
        assert (matmul.fp32_precision, conv.fp32_precision) == ("tf32", "tf32")
        trainer.eval_step(tb)
        trainer.eval_loss(tb)
        assert (matmul.fp32_precision, conv.fp32_precision) == ("tf32", "tf32")
        run = serve.LoadedRun(model.eval(), KWARGS, {"scale_output": []}, "", torch.device("cpu"))
        serve.predict(run, tb)
        assert (matmul.fp32_precision, conv.fp32_precision) == ("tf32", "tf32")
    finally:
        matmul.fp32_precision, conv.fp32_precision = saved
    assert seen == [("ieee", "ieee")] * 4
