"""The training CLI's resume on the card: a run interrupted after 2 epochs and
resumed with ``--resume`` equals a straight 4-epoch run bit for bit (the
history and the final checkpoint's bytes), with the default config (the
device-resident store, each bucket's train step and eval forward as CUDA-graph
replays, bf16 Adam, dropout on). The train state saved after graph replays is
the state the straight run holds at that epoch, and the resumed run loads the
capturable Adam's device state and the dropout generator before its own
captures.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one. No JAX here, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cli_gpu.py
"""
import os

import numpy as np
import pytest
import torch

from caster_dta_torch.data.batching import BucketedLoader, synthetic_pair_dataset
from caster_dta_torch.data.device_cache import DeviceResidentLoader
from caster_dta_torch.models.joint import make_joint_gnn
from caster_dta_torch.train import checkpoints, driver
from caster_dta_torch.train.loop import Trainer, TrainConfig

pytestmark = pytest.mark.gpu

# 1,099 distinct pairs: a train bucket of 5 batches of 128 (its step captured
# in the first epoch of each run) and a val split of 2 batches
SYNTHETIC = ["--synthetic-pairs", "3000", "--synthetic-proteins", "40",
             "--synthetic-molecules", "30"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _history(res):
    return [(h["epoch"], h["lr"], h["train"], h["val"]) for h in res["history"]]


def test_cli_resume_equals_straight_run_under_graphs(cuda, tmp_path):
    base = ["--dataset", "synthetic", "--data-root", str(tmp_path / "data"), "--seed", "9",
            "--device", "cuda", *SYNTHETIC]
    straight = driver.main(base + ["--out-folder", str(tmp_path / "a"), "--n-epochs", "4"])
    out = str(tmp_path / "b")
    first = driver.main(base + ["--out-folder", out, "--n-epochs", "2"])
    for f in os.listdir(out):
        if f.startswith(("bestval", "besttrain", "final")):
            os.remove(os.path.join(out, f))
    resumed = driver.main(base + ["--out-folder", out, "--n-epochs", "4", "--resume"])
    for res in (straight, first, resumed):
        assert {key[0] for key in res["trainer"]._graphs.keys()} == {"train", "eval"}
    assert _history(resumed) == _history(straight)
    finals = []
    for d in (str(tmp_path / "a"), out):
        with open(checkpoints.get_best_model(d, "final"), "rb") as f:
            finals.append(f.read())
    assert finals[0] == finals[1]


def test_train_state_round_trip_on_the_card(cuda, tmp_path):
    """A capturable trainer's optimizer state, step counts and dropout
    generator written to train_state.msgpack and read into a fresh trainer:
    the same tensors, on the card, and the same next replayed steps."""
    pairs = synthetic_pair_dataset(40, 6, 5, [(10, 40)], (6, 14), seed=3)
    kw = dict(base_conv="lbamodel", in_channels=[17, 3], edge_dim=[32, 1], num_ntypes=21,
              num_etypes=1, ntype_emb_dim=None, etype_emb_dim=None, num_convs=2,
              hidden_channels=[8, 2], edge_hidden_channels=[8, 1], out_channels=16,
              dropout_rate=0.25, activation="leaky_relu", aggr="sum")
    mk = dict(base_conv="gine", in_channels=41, edge_dim=9, num_ntypes=10, num_etypes=5,
              ntype_emb_dim=None, etype_emb_dim=None, num_convs=2, hidden_channels=8,
              out_channels=16, dropout_rate=0.0, activation="leaky_relu", aggr="sum",
              gin_trainable_eps=True)
    jk = dict(residue_lin_depth=1, atom_lin_depth=1, n_attention_heads=4,
              attention_dropout=0.0, protein_lin_depth=1, molecule_lin_depth=1,
              pairwise_embedding_dim=32, out_lin_depth=1, out_lin_factor=0.5,
              out_lin_norm_type=None, activation="leaky_relu", dropout=0.1,
              element_pooling="mean", include_residual_stream=True, residual_dim_ff_scale=2,
              num_cross_attn_layers=1, include_post_pool_layernorm=False)

    def trainer():
        model = make_joint_gnn(kw, mk, generator=torch.Generator().manual_seed(0), **jk)
        return Trainer(model, TrainConfig(compute_dtype="bfloat16", seed=5), device=cuda)

    def epoch(tr, n):
        store = DeviceResidentLoader(BucketedLoader(pairs, None, max_batch_size=6, seed=0),
                                     device=cuda)
        store.loader.epoch = n
        return tr.train_epoch(store, 1e-3)[0]

    a = trainer()
    epoch(a, 0)
    checkpoints.save_train_state(str(tmp_path), params=a.params_tree(),
                                 opt_state=a.opt_state_tree(), rng=a.rng_state(), epoch=0,
                                 best_train=1.0, best_val=1.0, n_since_best_val=0, lr=1e-3,
                                 history=[])
    st = checkpoints.load_train_state(str(tmp_path))
    b = trainer()
    b.set_params(st["params"])
    b.load_opt_state_tree(st["opt_state"])
    b.load_rng_state(st["rng"])
    for p, q in zip(a.params, b.params):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert sb["step"].device.type == "cuda" and torch.equal(sa["step"], sb["step"])
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert epoch(a, 1) == epoch(b, 1)
    for p, q in zip(a.params, b.params):
        np.testing.assert_array_equal(p.detach().cpu().numpy(), q.detach().cpu().numpy())
