"""The card's scan path: a bucket's train step and eval forward as CUDA-graph
replays (caster_dta_torch/train/graphs.py) against the same steps run
eagerly (``train_step`` of a trainer with the same config, so the same
capturable optimizer), on the card. Every kernel of the step is deterministic and the
dropout generator is registered with each graph, so replays give the eager
steps' losses, predictions and parameters bit for bit, dropout on. The
capturable optimizers the card trains with are held against the CPU's
non-capturable ones, within 1e-5.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one. No JAX here, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_graph_replay.py
"""
import numpy as np
import pytest
import torch

from caster_dta_torch.data.batching import BucketedLoader, synthetic_pair_dataset
from caster_dta_torch.data.device_cache import DeviceResidentLoader
from caster_dta_torch.models.joint import make_joint_gnn
from caster_dta_torch.nn import gvp
from caster_dta_torch.ops import cuda_gvp_message as cgm
from caster_dta_torch.ops import cuda_segment as cs
from caster_dta_torch.ops import launches
from caster_dta_torch.train import graphs, optim
from caster_dta_torch.train.loop import Trainer, TrainConfig

pytestmark = pytest.mark.gpu

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
F32_TOL = 1e-5
# per step: one K1 and one K2 per conv forward, one K2 per K1 and one K3 per
# gather whose table needs a gradient backward (the first GINE conv's does not)
PER_STEP = {cs.K1: 4, cs.K2: 8, cs.K3: 3}
# fused message path: each of the 2 GVP convs adds K5 fwd and bwd, K6 twice
PER_STEP_FUSED = {**PER_STEP, cgm.K5F: 2, cgm.K5B: 2, cgm.K6: 4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _megabatch(device):
    """One bucket of 7 batches of 6 pairs, the last partial."""
    pairs = synthetic_pair_dataset(40, 6, 5, [(10, 40)], (6, 14), seed=3)
    store = DeviceResidentLoader(BucketedLoader(
        pairs, None, max_num=16_000_000, max_batch_size=6, seed=3,
        protein_node_ladder=(48,), edge_ladder=(512,), molecule_node_ladder=(16,),
        molecule_edge_ladder=(64,)), device=device)
    (mega, _), = store.iter_megabatches()
    assert mega.n_steps == 7 and mega.weight[-1].sum() < 6
    return mega


def _trainer(device, **cfg) -> Trainer:
    """A trainer with scan_steps on (the capturable optimizer on the card):
    ``train_megabatch`` replays graphs, ``train_step`` steps eagerly."""
    model = make_joint_gnn(PROTEIN, MOLECULE, generator=torch.Generator().manual_seed(0), **JOINT)
    return Trainer(model, TrainConfig(seed=5, **cfg), device=device)


@pytest.mark.parametrize("compute", [None, "bfloat16"])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_replays_equal_eager_steps(cuda, compute, grad_accum):
    """Two passes over a bucket's megabatch (warm-up steps, the capture, then
    replays only): the same losses, predictions and parameters as the same
    steps taken one by one, and the eager steps' kernel launches."""
    mega = _megabatch(cuda)
    k = mega.n_steps
    eager = _trainer(cuda, compute_dtype=compute, grad_accum=grad_accum)
    graph = _trainer(cuda, compute_dtype=compute, grad_accum=grad_accum)
    lrs = np.linspace(1e-3, 4e-4, k).astype(np.float32)
    for _ in range(2):
        want = [eager.train_step(mega.batch(j), float(lrs[j])) for j in range(k)]
        launches.reset()
        losses, preds = graph.train_megabatch(mega, lrs)
        torch.cuda.synchronize()
        assert launches.snapshot() == {**{n: 0 for n in launches.snapshot()},
                                       **{n: v * k for n, v in PER_STEP.items()}}
        assert torch.equal(losses, torch.stack([loss for loss, _ in want]))
        assert torch.equal(preds, torch.stack([pred for _, pred in want]))
    captured = graph.captured_step("train", mega)
    assert captured is not None and set(captured.graphs) == (
        {False, True} if grad_accum > 1 else {True})
    assert captured.launches[True] == PER_STEP
    assert all(torch.equal(a, b) for a, b in zip(eager.params, graph.params))
    assert not all(torch.equal(a, b) for a, b in zip(
        graph.params, _trainer(cuda).params))
    got = graph.eval_megabatch(mega)
    assert torch.equal(got, torch.stack([eager.eval_step(mega.batch(j)) for j in range(k)]))
    assert graph.captured_step("eval", mega) is not None


def test_buckets_sharing_the_pool_replay_in_turns(cuda):
    """Two buckets whose graphs share one memory pool, replayed in turns over
    three passes (each capture may reuse the other's freed memory): still
    the eager steps' losses, parameters and eval predictions, bit for bit."""
    pairs = synthetic_pair_dataset(40, 6, 5, [(10, 18), (26, 31)], (6, 14), seed=4)
    store = DeviceResidentLoader(BucketedLoader(
        pairs, None, max_num=16_000_000, max_batch_size=4, seed=3, coalesce=False,
        protein_node_ladder=(24, 48), edge_ladder=(256, 512), molecule_node_ladder=(16,),
        molecule_edge_ladder=(64,)), device=cuda)
    megas = [mega for mega, _ in store.iter_megabatches()]
    assert len(megas) == 2 and min(m.n_steps for m in megas) > graphs.WARMUP_STEPS
    eager, graph = _trainer(cuda), _trainer(cuda)
    for _ in range(3):
        for mega in megas:
            lrs = [1e-3] * mega.n_steps
            want = torch.stack([eager.train_step(mega.batch(j), lrs[j])[0]
                                for j in range(mega.n_steps)])
            assert torch.equal(graph.train_megabatch(mega, lrs)[0], want)
    assert all(torch.equal(a, b) for a, b in zip(eager.params, graph.params))
    for _ in range(2):
        for mega in megas:
            want = torch.stack([eager.eval_step(mega.batch(j)) for j in range(mega.n_steps)])
            assert torch.equal(graph.eval_megabatch(mega), want)
    assert all(graph.captured_step(kind, mega) is not None
               for kind in ("train", "eval") for mega in megas)


def test_a_bucket_shorter_than_the_warm_up_runs_eagerly(cuda):
    mega = _megabatch(cuda)
    short = type(mega)(mega.bucket, mega.p_store, mega.m_store, *(
        a[:graphs.WARMUP_STEPS] for a in (mega.p_rows, mega.m_rows, mega.target, mega.weight,
                                          mega.pair_idx)))
    trainer = _trainer(cuda)
    losses, _ = trainer.train_megabatch(short, [1e-3] * short.n_steps)
    assert bool(torch.isfinite(losses).all())
    assert trainer.captured_step("train", short) is None


def test_one_trainer_replays_the_path_it_runs(cuda):
    """One trainer over one bucket, the fused message path off, on, off and
    on again: each setting gets its own captured step and replays its own
    path (its launch counts say which), bit for bit the eager steps taken
    under the same setting."""
    mega = _megabatch(cuda)
    k = mega.n_steps
    eager, graph = _trainer(cuda), _trainer(cuda)
    lrs = [1e-3] * k
    for fused in (False, True, False, True):
        per_step = PER_STEP_FUSED if fused else PER_STEP
        with gvp.fused_message(fused):
            want = torch.stack([eager.train_step(mega.batch(j), lrs[j])[0] for j in range(k)])
            launches.reset()
            losses, _ = graph.train_megabatch(mega, lrs)
            torch.cuda.synchronize()
            assert {n: v for n, v in launches.snapshot().items() if v} == {
                n: v * k for n, v in per_step.items()}
            assert torch.equal(losses, want)
            assert graph.captured_step("train", mega).launches[True] == per_step
    assert all(torch.equal(a, b) for a, b in zip(eager.params, graph.params))


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "sgd_nomomentum"])
def test_capturable_optimizers_match_the_cpu_step(cuda, name):
    """The card's capturable optimizer (a device learning rate; Adam's bias
    correction on the device) against the CPU's non-capturable step, which
    tests/test_torch_train.py holds against optax: a scripted gradient
    sequence, the learning rate changed every step, within F32_TOL, the
    tolerance the port's Adam steps are held to against JAX. Adam's
    capturable form rounds in other places (a parameter may move by an ulp
    or two), so not within the 1e-6 of the optax test."""
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(4099, generator=gen)
    grads = torch.randn(5, 4099, generator=gen)
    lrs = [1e-2, 5e-3, 5e-3, 2e-3, 1e-3]
    wd = 0.01 if name.startswith("adam") else 0.0
    params = {dev: torch.nn.Parameter(p0.clone().to(dev)) for dev in ("cpu", cuda)}
    opts = {dev: optim.make_optimizer(name, [p], lrs[0], weight_decay=wd,
                                      capturable=dev != "cpu") for dev, p in params.items()}
    for g, lr in zip(grads, lrs):
        for dev, p in params.items():
            optim.set_learning_rate(opts[dev], lr)
            p.grad = g.to(dev)
            opts[dev].step()
    torch.testing.assert_close(params[cuda].detach().cpu(), params["cpu"].detach(),
                               rtol=F32_TOL, atol=F32_TOL)
