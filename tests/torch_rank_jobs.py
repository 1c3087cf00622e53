"""Jobs that tests/torch_ranks.py runs on every rank, and the builders that
the tests share with them (small models and seeded synthetic datasets), so
each rank and the single-rank reference build the same inputs.

Imports torch and the port only: the ranks never load JAX.
"""
from __future__ import annotations

import torch

from caster_dta_torch.data.batching import synthetic_pair_dataset
from caster_dta_torch.models.joint import make_joint_gnn
from caster_dta_torch.parallel import mesh as pmesh
from caster_dta_torch.parallel import partition
from caster_dta_torch.train.loop import TrainConfig, fit

_MESHES: dict = {}


def mesh_of(n_dp: int, gp: int) -> pmesh.Mesh:
    """This rank's mesh of that shape, made once (every rank makes its groups
    in the same order)."""
    if (n_dp, gp) not in _MESHES:
        _MESHES[(n_dp, gp)] = pmesh.make_2d_mesh(n_dp, gp, device="cpu")
    return _MESHES[(n_dp, gp)]


def dataset(spec: dict):
    return synthetic_pair_dataset(**spec)


def model_kwargs(md: dict, dropout: float = 0.2, aggr: str = "sum") -> tuple:
    """A small CASTER-DTA: one lbamodel conv, one GINE conv, one
    cross-attention layer (tests/test_gp_fit.py's widths)."""
    pk = dict(base_conv="lbamodel", in_channels=md["protein_node_features"],
              edge_dim=md["protein_edge_features"], num_ntypes=md["protein_node_types"],
              num_etypes=md["protein_edge_types"], ntype_emb_dim=None, etype_emb_dim=None,
              num_convs=1, hidden_channels=(8, 2), edge_hidden_channels=(16, 1),
              out_channels=16, dropout_rate=dropout, activation="leaky_relu", aggr=aggr)
    mk = dict(base_conv="gine", in_channels=md["molecule_node_features"],
              edge_dim=md["molecule_edge_features"], num_ntypes=md["molecule_node_types"],
              num_etypes=md["molecule_edge_types"], ntype_emb_dim=None, etype_emb_dim=None,
              num_convs=1, hidden_channels=8, out_channels=16, dropout_rate=dropout,
              activation="leaky_relu", aggr="sum")
    jk = dict(residue_lin_depth=1, atom_lin_depth=1, n_attention_heads=4,
              attention_dropout=0.0, protein_lin_depth=1, molecule_lin_depth=1,
              pairwise_embedding_dim=64, out_lin_depth=1, activation="leaky_relu",
              dropout=dropout / 2, num_cross_attn_layers=1)
    return pk, mk, jk


def model(md: dict, seed: int = 0, **kw):
    pk, mk, jk = model_kwargs(md, **kw)
    return make_joint_gnn(pk, mk, generator=torch.Generator().manual_seed(seed), **jk)


def summary(res: dict) -> dict:
    """What the tests compare of a fit result: the history's losses, the test
    metrics, the overflow counts and the final parameters."""
    return {"train": [h["train"] for h in res["history"]],
            "val": [h["val"] for h in res["history"]],
            "test_mse": res["test_metrics"].get("mse"),
            "overflow_pairs": res.get("overflow_pairs"),
            "params": res["params"]}


def fit_job(rank: int, n_dp: int, gp: int, spec: dict, model_kw: dict, cfg: dict,
            fit_kw: dict, out: str) -> dict:
    """``fit`` on this rank of an ``n_dp x gp`` mesh -> summary()."""
    ds = dataset(spec)
    res = fit(model(ds.metadata_dict, **model_kw), ds, "synthetic", out, TrainConfig(**cfg),
              verbose=False, device="cpu", mesh=mesh_of(n_dp, gp), **fit_kw)
    return summary(res)


def tower_job(rank: int, kw: dict, state: dict, sharded, train: bool = False,
              seed: int = 0) -> dict:
    """The partitioned lbamodel tower on one graph over gp (the whole world):
    the gathered output, and the gradients of sum(out^2) summed over the
    ranks (each rank's loss on its own rows)."""
    mesh = mesh_of(1, sharded.n_shards)
    tower = partition.PartitionedLBAProteinGNN(**kw)
    tower.load_state_dict(state)
    tower.train(train)
    gen = torch.Generator().manual_seed(seed)
    local = partition._batched(sharded).local(mesh.gp_rank)
    out_local = partition.PartitionedLBAProteinGNN.forward(tower, local, mesh, gen)
    (out_local ** 2).sum().backward()
    names = [n for n, p in tower.named_parameters()]
    grads = mesh.all_reduce_grads([p.grad if p.grad is not None else torch.zeros_like(p)
                                   for p in tower.parameters()])
    full = mesh.gather(out_local.detach(), "gp", dim=1)[0]
    return {"out": full, "grads": dict(zip(names, grads))}


def joint_job(rank: int, kw: tuple, state: dict, sharded, molecule, target,
              train: bool = False, seed: int = 0) -> dict:
    """run_partitioned_joint on stacked pairs over gp (the whole world), and
    the gradients of the pairs' squared error (scaled by 1/G on each rank,
    summed over the world: JAX's pmean over gp)."""
    mesh = mesh_of(1, sharded.n_shards)
    pk, mk, jk = kw
    m = make_joint_gnn(pk, mk, **jk)
    m.load_state_dict(state)
    m.train(train)
    gen = torch.Generator().manual_seed(seed)
    score = partition.run_partitioned_joint(m, sharded, molecule, mesh, generator=gen)
    loss = torch.sum((score[:, 0] - target) ** 2)
    grads = torch.autograd.grad(loss / mesh.gp, [p for p in m.parameters()], allow_unused=True)
    grads = mesh.all_reduce_grads([g if g is not None else torch.zeros_like(p)
                                   for g, p in zip(grads, m.parameters())])
    return {"score": score.detach(), "loss": loss.detach(),
            "grads": dict(zip([n for n, _ in m.named_parameters()], grads))}


def train_step_job(rank: int, kw: tuple, state: dict, sharded, molecule, target,
                   lr: float = 0.1) -> dict:
    """One SGD step of partition.partitioned_train_step over gp (the whole
    world) -> the loss and the parameters after it."""
    mesh = mesh_of(1, sharded.n_shards)
    pk, mk, jk = kw
    m = make_joint_gnn(pk, mk, **jk)
    m.load_state_dict(state)
    step = partition.partitioned_train_step(m, torch.optim.SGD(m.parameters(), lr=lr), mesh)
    loss = step(partition._batched(sharded), molecule, target)
    return {"loss": float(loss), "params": {k: v.detach().clone()
                                            for k, v in m.state_dict().items()}}
