"""Port parity for scan-over-steps: caster_dta_torch's Trainer over a
device-resident store (bucket by bucket, ``train_megabatch`` and
``eval_megabatch``) against its own per-batch path and against the JAX
Trainer with ``scan_steps=True``, on the CPU, where the same megabatch code
runs eagerly. On the card the steps are CUDA-graph replays
(tests/test_torch_graph_replay.py).

Tolerances: the port's scan and per-batch paths are the same calls in the
same order, so exactly equal, dropout included (one generator, drawn in the
same order). Against JAX in f32 with dropout 0: epoch losses, parameters and
eval predictions within F32_TOL = 1e-5 (the same sums in other orders, as in
tests/test_torch_train.py); pair indices exactly.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from caster_dta_tpu.data import batching as jbatching
from caster_dta_tpu.data.device_cache import DeviceResidentLoader as JaxDeviceResidentLoader
from caster_dta_tpu.interop.torch_import import import_joint_gnn
from caster_dta_tpu.models.joint import make_joint_gnn as jax_make_joint_gnn
from caster_dta_tpu.train import optim as joptim
from caster_dta_tpu.train.loop import Trainer as JaxTrainer, TrainConfig as JaxTrainConfig
from caster_dta_torch.data import batching
from caster_dta_torch.data.device_cache import DeviceResidentLoader
from caster_dta_torch.models.joint import make_joint_gnn
from caster_dta_torch.nn import gvp as tgvp
from caster_dta_torch.ops import cuda_gvp_message as cgm
from caster_dta_torch.ops import cuda_segment as cs
from caster_dta_torch.ops import launches
from caster_dta_torch.train import graphs, optim
from caster_dta_torch.train.loop import Trainer, TrainConfig

F32_TOL = 1e-5

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
LADDERS = dict(protein_node_ladder=(16, 32, 48), edge_ladder=(128, 256, 512),
               molecule_node_ladder=(8, 16), molecule_edge_ladder=(32, 64))
# three buckets of 2-7 batches of up to 6 pairs
MULTI = dict(max_num=3000, max_batch_size=6, coalesce_min_batches=1, **LADDERS)


@pytest.fixture(scope="module")
def dataset():
    """Pairs of 6 proteins (10-40 residues) and 5 molecules (6-14 atoms)."""
    return batching.synthetic_pair_dataset(40, 6, 5, protein_nodes=[(10, 40)],
                                           molecule_nodes=(6, 14), seed=3)


def _port_model(seed=0, dropout=0.0):
    kwargs = json.loads(json.dumps(KWARGS))
    kwargs["joint_gnn_kwargs"]["dropout"] = dropout
    kwargs["protein_gnn_kwargs"]["dropout_rate"] = dropout
    return make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                          generator=torch.Generator().manual_seed(seed),
                          **kwargs["joint_gnn_kwargs"])


def _jax_params(model):
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return import_joint_gnn(sd, KWARGS)["params"]


def _max_leaf_diff(a, b):
    diffs = jax.tree_util.tree_map(lambda x, y: float(np.abs(np.asarray(x) - y).max()), a, b)
    return max(jax.tree_util.tree_leaves(diffs))


def _stores(dataset, idx, **kw):
    """The port's and the JAX package's store over the same loader."""
    return (DeviceResidentLoader(batching.BucketedLoader(dataset, idx, **kw), device="cpu"),
            JaxDeviceResidentLoader(jbatching.BucketedLoader(dataset, idx, **kw)))


def _jax_trainer(store, model, **cfg):
    example = next(iter(store))
    store.loader.epoch = 0          # the example took epoch 0's shuffle
    jm = jax_make_joint_gnn(KWARGS["protein_gnn_kwargs"], KWARGS["molecule_gnn_kwargs"],
                            **KWARGS["joint_gnn_kwargs"])
    jt = JaxTrainer(jm, JaxTrainConfig(scan_steps=True, **cfg), example)
    jt.set_params(_jax_params(model))
    return jt


def test_train_config_defaults_are_jaxs():
    """Every field both configs have defaults alike (train-state checkpoints
    every 25 epochs, no resume, no per-batch log), but the two the port still
    refuses (data and graph parallelism)."""
    mine = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    refused = {"n_dp", "gp"}
    shared = (mine.keys() & theirs.keys()) - refused
    assert {"device_data_budget", "scan_steps", "lr", "grad_accum", "save_state_every",
            "resume", "log_every"} <= shared
    assert {k: mine[k] for k in shared} == {k: theirs[k] for k in shared}
    assert TrainConfig().device_data_budget == 4_000_000_000 and TrainConfig().scan_steps


def test_scan_equals_the_per_batch_path_on_one_bucket(dataset):
    """One bucket, dropout on: the megabatch path takes the per-batch path's
    steps in the same order from one generator, so two epochs give the same
    losses, parameters and eval answers, bit for bit (the counterpart of
    tests/test_pipeline.py::test_scan_steps_matches_per_batch)."""
    mk = lambda: DeviceResidentLoader(batching.BucketedLoader(
        dataset, None, max_num=16_000_000, max_batch_size=8, shuffle=True, seed=3, **LADDERS),
        device="cpu")
    dl_a, dl_b = mk(), mk()
    assert len(dl_a.buckets()) == 1, "fixture must stay single-bucket"
    tr_a = Trainer(_port_model(dropout=0.25), TrainConfig(seed=5), device="cpu")
    tr_b = Trainer(_port_model(dropout=0.25), TrainConfig(seed=5, scan_steps=False),
                   device="cpu")
    for _ in range(2):
        loss_a, _ = tr_a.train_epoch(dl_a, 1e-3)
        loss_b, _ = tr_b.train_epoch(dl_b, 1e-3)
        assert loss_a == loss_b
    assert all(torch.equal(a, b) for a, b in zip(tr_a.params, tr_b.params))
    assert not all(torch.equal(a, b) for a, b in zip(tr_a.params, _port_model().parameters()))
    ev_a, ev_b = tr_a.eval_epoch(dl_a), tr_b.eval_epoch(dl_b)
    assert ev_a[0] == ev_b[0]
    for a, b in zip(ev_a[1:], ev_b[1:]):
        np.testing.assert_array_equal(a, b)


def test_scan_epochs_match_jax_f32(dataset):
    """Two epochs over three buckets, a cosine batch schedule (a new learning
    rate every step), f32, dropout 0, the same weights: epoch losses,
    learning rates and parameters, then the eval scan over a held-out loader
    (predictions and pair indices)."""
    train_idx, val_idx = list(range(30)), list(range(30, 40))
    port, theirs = _stores(dataset, train_idx, shuffle=True, seed=7, **MULTI)
    assert len(port.buckets()) >= 2
    model = _port_model()
    jt = _jax_trainer(theirs, model, seed=5)
    tt = Trainer(model, TrainConfig(seed=5), device="cpu")
    j_sched, t_sched = (m.make_scheduler("cosine", 1e-4) for m in (joptim, optim))
    j_lr = t_lr = 1e-4
    for epoch in range(2):
        j_loss, j_lr = jt.train_epoch(theirs, j_lr, j_sched, epoch, len(train_idx))
        t_loss, t_lr = tt.train_epoch(port, t_lr, t_sched, epoch, len(train_idx))
        np.testing.assert_allclose(t_loss, j_loss, rtol=F32_TOL)
        assert t_lr == j_lr
    assert _max_leaf_diff(jax.device_get(jt.params), tt.params_tree()) <= F32_TOL

    port_val, their_val = _stores(dataset, val_idx, shuffle=False, seed=8, **MULTI)
    j_ev, t_ev = jt.eval_epoch(their_val), tt.eval_epoch(port_val)
    np.testing.assert_allclose(t_ev[0], j_ev[0], rtol=F32_TOL)
    np.testing.assert_allclose(t_ev[1], j_ev[1], rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(t_ev[2], j_ev[2])
    np.testing.assert_array_equal(t_ev[3], j_ev[3])
    assert sorted(t_ev[3].tolist()) == val_idx


def test_scan_grad_accumulation_and_clip_match_jax(dataset):
    """grad_accum=2 with a clipping norm under scan: MultiSteps' count runs
    across the megabatches (buckets of odd batch counts) as in optax."""
    port, theirs = _stores(dataset, None, shuffle=True, seed=7, **MULTI)
    counts = [-(-len(v) // port.loader.bucket_batch_size(b)) for b, v in port.buckets().items()]
    assert any(c % 2 for c in counts), counts
    model = _port_model()
    jt = _jax_trainer(theirs, model, seed=5, grad_accum=2, clip_norm=0.05)
    tt = Trainer(model, TrainConfig(seed=5, grad_accum=2, clip_norm=0.05), device="cpu")
    for _ in range(2):
        j_loss, _ = jt.train_epoch(theirs, 1e-4)
        t_loss, _ = tt.train_epoch(port, 1e-4)
        np.testing.assert_allclose(t_loss, j_loss, rtol=F32_TOL)
        assert tt._mini_step == int(jt.opt_state.mini_step)
    assert _max_leaf_diff(jax.device_get(jt.params), tt.params_tree()) <= F32_TOL


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_counter_arithmetic():
    """A capture's counts come back out of the counters and go in again on
    every replay: after a capture and n replays the counters read n times a
    replay's launches, as n eager steps would."""
    launches.reset()
    cs.LAUNCHES[cs.K1] = 5                 # earlier, eager launches stay
    before = launches.snapshot()
    per_step = {cs.K1: 4, cs.K2: 8, cs.K3: 3, cgm.K5F: 2}
    for k, v in per_step.items():          # what a capture's Python calls add
        (cs.LAUNCHES if k in cs.LAUNCHES else cgm.LAUNCHES)[k] += v
    delta = launches.since(before)
    assert delta == per_step
    launches.add(delta, -1)
    assert launches.snapshot() == before
    graph, out = _StubGraph(), torch.zeros(3)
    step = graphs.CapturedStep(torch.zeros(4, dtype=torch.int32), {True: graph}, {True: out},
                               {True: delta}, keep=None)
    row = torch.arange(4, dtype=torch.int32)
    for _ in range(3):
        assert step.run(row) is out
    assert graph.replays == 3 and torch.equal(step.row, row)
    now = launches.snapshot()
    assert now[cs.K1] == 5 + 3 * 4 and now[cs.K2] == 24 and now[cs.K3] == 9
    assert now[cgm.K5F] == 6 and now[cgm.K5B] == 0 and now[cs.K7] == 0
    launches.reset()
    assert not any(launches.snapshot().values())


def test_step_rows_round_trip_with_aligned_fields():
    """A step's learning rate and divisor ahead of its batch's packed rows:
    the header words and every field come back exactly, each field at the
    same 64-byte alignment as in a batch's own packed rows."""
    rng = np.random.default_rng(0)
    k, b = 3, 21
    p_rows, m_rows = rng.integers(0, 100, (2, k, b)).astype(np.int32)
    target, weight = rng.normal(size=(2, k, b)).astype(np.float32)
    lrs, divs = np.array([1e-3, 2e-3, 3e-4], np.float32), np.array([1, 2, 1], np.float32)
    packed = torch.from_numpy(graphs.pack_rows(p_rows, m_rows, target, weight, lrs, divs))
    assert packed.shape == (k, graphs.row_width(b)) and packed.dtype == torch.int32
    assert packed.shape[1] % graphs.FIELD_ALIGN == 0
    for j in range(k):
        step = graphs.unpack_row(packed[j], b)
        assert step.lr.shape == () and step.lr.item() == lrs[j] and step.div.item() == divs[j]
        for got, want in zip(step[2:], (p_rows[j], m_rows[j], target[j], weight[j])):
            assert np.array_equal(got.numpy(), want) and got.dtype == torch.from_numpy(want).dtype
            assert (got.storage_offset() - packed[j].storage_offset()) % graphs.FIELD_ALIGN == 0


def test_graph_key_names_the_model_path(dataset):
    """A captured step runs the path the model took at capture, so its key
    changes with the fused message switch and with any attention module's
    ``use_pallas``."""
    mega, _ = next(_stores(dataset, None, **MULTI)[0].iter_megabatches())
    model = _port_model()
    tt = Trainer(model, TrainConfig(), device="cpu")
    plain = tt._graph_key("train", mega)
    assert tt._graph_key("train", mega) == plain and tt._graph_key("eval", mega) != plain
    with tgvp.fused_message():
        fused = tt._graph_key("train", mega)
    attention = [m for m in model.modules() if hasattr(m, "use_pallas")]
    assert attention
    attention[0].use_pallas = True
    blockwise = tt._graph_key("train", mega)
    attention[0].use_pallas = False
    assert len({plain, fused, blockwise}) == 3 and tt._graph_key("train", mega) == plain


@pytest.mark.parametrize("name", ["sgd", "sgd_nomomentum"])
@pytest.mark.parametrize("capturable", [False, True])
def test_sgd_tensor_learning_rate_matches_optax(name, capturable):
    """SGD is CapturableSGD whatever ``capturable`` says, its learning rate an
    f32 tensor that ``set_learning_rate`` writes in place (from a tensor, as
    the scan path passes it), against optax as
    tests/test_torch_train.py::test_optimizers_match_optax."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(17,)).astype(np.float32)
    grads = rng.normal(size=(5, 17)).astype(np.float32)
    lrs = [1e-2, 5e-3, 5e-3, 2e-3, 1e-3]
    tx = joptim.make_optimizer(name, lrs[0], flatten=False)
    jp = jax.numpy.asarray(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optim.make_optimizer(name, [tp], lrs[0], capturable=capturable)
    lr_tensor = opt.param_groups[0]["lr"]
    assert isinstance(opt, optim.CapturableSGD) and lr_tensor.dtype == torch.float32
    for g, lr in zip(grads, lrs):
        joptim.set_learning_rate(state, lr)
        updates, state = tx.update(jax.numpy.asarray(g), state, jp)
        jp = jp + updates
        optim.set_learning_rate(opt, torch.tensor(lr))
        assert opt.param_groups[0]["lr"] is lr_tensor and lr_tensor.item() == np.float32(lr)
        tp.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
