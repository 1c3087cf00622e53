"""Port parity for the model zoo's towers: caster_dta_torch against
caster_dta_tpu with the same weights on the same seeded inputs, on the CPU.

* the attention and GVP towers (PocketMiner, CPD, scalar GATv2 and HEAT,
  molecule GATv2 and HEAT) at tests/test_model_zoo.py's kwargs, eval mode,
  JAX init carried over by interop.from_jax: 1e-5 (GIN, AttentiveFP, GPS
  and PNA: tests/test_torch_zoo_molecule.py);
* the registries refuse what JAX refuses; the scalar protein widths are
  data/build.py's; scalar graphs' zero-size vector fields go through the
  store and the packed row.

The JointGNNs on chip_smoke.py's zoo configurations are in
tests/test_torch_zoo_joint.py, their training in tests/test_torch_zoo_train.py
and tests/test_torch_zoo_molecule_train.py; they use this file's helpers.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from caster_dta_tpu.data import batching as jbatching
from caster_dta_tpu.data import graphs as jgraphs
from caster_dta_tpu.models.joint import make_joint_gnn as jax_make_joint_gnn
from caster_dta_tpu.models.molecule import make_molecule_gnn as jax_molecule
from caster_dta_tpu.models.protein import make_protein_gnn as jax_protein
from caster_dta_torch.data import build
from caster_dta_torch.data.batching import synthetic_pair_batch
from caster_dta_torch.data.graphs import GraphBatch
from caster_dta_torch.interop.from_jax import StateDictWriter, load_jax_params
from caster_dta_torch.models.joint import make_joint_gnn
from caster_dta_torch.models.molecule import make_molecule_gnn
from caster_dta_torch.models.protein import make_protein_gnn
from caster_dta_torch.train.loop import Trainer, TrainConfig
from tests.test_joint import _molecule_batch, _protein_batch
from tests.test_model_zoo import MOL_COMMON, PROT_COMMON

TOL = dict(rtol=1e-5, atol=1e-5)
BUCKET = (3, 24, 160, 12, 40)   # B, N_P, E_P, N_M, E_M

PROTEIN_ZOO = {
    "pocketminer": dict(in_channels=(17, 3), edge_dim=(32, 1), hidden_channels=(16, 4),
                        edge_hidden_channels=(32, 1), initial_node_project_channels=(16, 8),
                        initial_edge_project_channels=(32, 4)),
    "cpdmodel": dict(in_channels=(17, 3), edge_dim=(32, 1), hidden_channels=(16, 4),
                     edge_hidden_channels=(32, 1)),
    "gatv2": dict(in_channels=26, edge_dim=48, hidden_channels=16, heads=2),
    "heat": dict(in_channels=26, edge_dim=48, hidden_channels=16, eattr_emb_dim=8, heads=2),
}
MOLECULE_ZOO = {"gatv2": dict(heads=2, concat=False), "heat": dict(eattr_emb_dim=8, heads=2)}

JOINT = dict(residue_lin_depth=1, atom_lin_depth=1, n_attention_heads=4, attention_dropout=0.0,
             protein_lin_depth=1, molecule_lin_depth=1, pairwise_embedding_dim=32,
             out_lin_depth=1, out_lin_factor=0.5, out_lin_norm_type=None,
             activation="leaky_relu", dropout=0.0, element_pooling="mean",
             include_residual_stream=True, residual_dim_ff_scale=2, num_cross_attn_layers=1,
             include_post_pool_layernorm=False)


def _small(kwargs: dict) -> dict:
    """A zoo configuration of chip_smoke.py at test widths: hidden 8 (or
    (8, 2)), out 16, no dropout."""
    p, m, j = (dict(kwargs[k]) for k in ("protein_gnn_kwargs", "molecule_gnn_kwargs",
                                          "joint_gnn_kwargs"))
    vector = not isinstance(p["in_channels"], int)
    p.update(hidden_channels=[8, 2] if vector else 8, out_channels=16, dropout_rate=0.0)
    if vector:
        p["edge_hidden_channels"] = [8, 1]
    m.update(hidden_channels=8, out_channels=16, dropout_rate=0.0)
    return dict(protein_gnn_kwargs=p, molecule_gnn_kwargs=m,
                joint_gnn_kwargs={**JOINT, "out_lin_norm_type": j.get("out_lin_norm_type")})


ZOO = {name: _small(kw) for name, kw in chip_smoke.zoo_configs().items()}


def _t(x):
    return torch.from_numpy(np.array(x))


def _torch_graph(jb) -> GraphBatch:
    return GraphBatch(**{f.name: _t(getattr(jb, f.name)) for f in dataclasses.fields(GraphBatch)})


def _jax_pair(tb):
    """The port's PairBatch as the JAX package's, same arrays."""
    def graph(g):
        return jgraphs.GraphBatch(**{f.name: getattr(g, f.name).numpy()
                                     for f in dataclasses.fields(GraphBatch)})
    return jbatching.PairBatch(graph(tb.protein), graph(tb.molecule), tb.target.numpy(),
                               tb.weight.numpy(), tb.pair_idx.numpy())


def _pair(kwargs: dict, seed: int = 1):
    """A seeded batch at BUCKET in the protein layout the tower reads."""
    scalar = isinstance(kwargs["protein_gnn_kwargs"]["in_channels"], int)
    return synthetic_pair_batch(*BUCKET, seed=seed, scalar_protein=scalar)


def _scalarize(g):
    """tests/test_model_zoo.py's scalar protein batch."""
    ns = np.concatenate([np.asarray(g.node_s), np.asarray(g.node_v).reshape(2, 12, 9)], -1)
    es = np.concatenate([np.asarray(g.edge_s), np.asarray(g.edge_v).reshape(2, 40, 3)], -1)
    es = np.concatenate([es, np.zeros((2, 40, 48 - es.shape[-1]), np.float32)], -1)
    return g.replace(node_s=ns, node_v=np.zeros((2, 12, 0, 3), np.float32),
                     edge_s=es, edge_v=np.zeros((2, 40, 0, 3), np.float32))


@pytest.mark.parametrize("side,base_conv", [("protein", k) for k in PROTEIN_ZOO]
                         + [("molecule", k) for k in MOLECULE_ZOO])
def test_tower_matches_jax(side, base_conv):
    rng = np.random.default_rng(0)
    if side == "protein":
        kw = {**PROT_COMMON, **PROTEIN_ZOO[base_conv]}
        g = _protein_batch(rng)
        g = _scalarize(g) if isinstance(kw["in_channels"], int) else g
        jm, tm = jax_protein(base_conv, **kw), make_protein_gnn(base_conv, **kw)
    else:
        kw = {**MOL_COMMON, **MOLECULE_ZOO[base_conv]}
        g = _molecule_batch(rng)
        jm, tm = jax_molecule(base_conv, **kw), make_molecule_gnn(base_conv, **kw)
    params = jm.init(jax.random.PRNGKey(0), g)["params"]
    writer = StateDictWriter()
    writer.tower("m", params, tm)
    tm.load_state_dict(writer.tensors(strip="m."), strict=True)
    want = np.asarray(jm.apply({"params": params}, g))
    got = tm.eval()(_torch_graph(g))
    # HEAT concatenates its heads: heads x out_channels, as flax infers
    assert got.shape == want.shape and got.shape[-1] == tm.out_dim
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("base_conv,kwargs,error", [
    ("lbamodel", dict(in_channels=26, edge_dim=35), "vector model"),
    ("gatv2", dict(in_channels=(17, 3), edge_dim=(32, 1)), "scalar model"),
    ("heat", dict(in_channels=26, edge_dim=(32, 1)), "same type"),
    ("gin", dict(in_channels=26, edge_dim=35), "unknown protein base_conv"),
])
def test_make_protein_gnn_refuses_what_jax_refuses(base_conv, kwargs, error):
    kw = {**PROT_COMMON, **kwargs}
    for make in (jax_protein, make_protein_gnn):
        with pytest.raises(ValueError, match=error):
            make(base_conv, **kw)


def test_make_molecule_gnn_dispatch():
    """Every molecule tower of the JAX package builds, keys a tower does not
    take ignored; an unknown name raises in both packages."""
    kw = {**MOL_COMMON, "not_a_field": 1, "heads": 2, "degree_hist": [0, 5, 9, 4, 2]}
    assert make_molecule_gnn("GATv2", **kw).out_dim == 12
    for name in ("gin", "attentivefp", "gps", "pna"):
        tower = make_molecule_gnn(name, **kw)
        assert tower.out_dim == 12 and type(tower).__name__.lower().endswith(name)
    for make in (jax_molecule, make_molecule_gnn):
        with pytest.raises(ValueError, match="unknown molecule base_conv"):
            make("schnet", **kw)


def test_scalar_protein_widths_are_the_builds():
    """The scalar towers' in_channels and edge_dim in chip_smoke.py's zoo are
    data/build.py's feature dims with vectorize_features=False."""
    pdb = os.path.join(os.path.dirname(__file__), "..", "data", "structures_davis", "AAK1.pdb")
    g = build.protein_file_to_graph(pdb, "angstroms", 4, "dist", True, False, False, False, True,
                                    native=False)
    kw = chip_smoke.zoo_configs()["zoo-gatv2-gine"]["protein_gnn_kwargs"]
    assert build.graph_feature_shapes(g) == ((kw["in_channels"], 0), (kw["edge_dim"], 0))
    pair = synthetic_pair_batch(2, 16, 64, 8, 16, scalar_protein=True)
    assert pair.protein.node_s.shape[-1] == kw["in_channels"]
    assert pair.protein.edge_s.shape[-1] == kw["edge_dim"]
    assert pair.protein.node_v.shape[-2] == 0 == pair.protein.edge_v.shape[-2]


def _both_models(kwargs: dict):
    """(JAX model, its variables from the JAX init, the port's model with
    those weights, a torch batch, the same batch for JAX)."""
    tb = _pair(kwargs)
    jb = _jax_pair(tb)
    jm = jax_make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                            **kwargs["joint_gnn_kwargs"])
    variables = jm.init(jax.random.PRNGKey(3), jb.protein, jb.molecule)
    tm = make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                        generator=torch.Generator().manual_seed(0), **kwargs["joint_gnn_kwargs"])
    load_jax_params(tm, jax.device_get(variables["params"]))
    return jm, variables, tm.eval(), tb, jb


def test_scalar_protein_graphs_go_through_the_store_and_the_packed_row():
    """Scalar protein graphs carry zero-size vector fields ([B, N, 0, 3],
    [B, E, 0, 3]): the device-resident store trains an epoch on them bucket
    by bucket, and inference/replay.py's packed row holds them."""
    from caster_dta_torch.data.batching import BucketedLoader, synthetic_pair_dataset
    from caster_dta_torch.data.device_cache import DeviceResidentLoader
    from caster_dta_torch.inference.replay import BatchLayout

    kwargs = ZOO["zoo-heat-gine"]
    pairs = synthetic_pair_dataset(10, 3, 3, [(10, 20)], (6, 10), seed=0, scalar_protein=True)
    store = DeviceResidentLoader(BucketedLoader(pairs, None, max_batch_size=4, seed=0),
                                 device="cpu")
    model = make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                           generator=torch.Generator().manual_seed(0), **kwargs["joint_gnn_kwargs"])
    trainer = Trainer(model, TrainConfig(), device="cpu")
    assert trainer._use_scan(store)
    loss, _ = trainer.train_epoch(store, 1e-4)
    assert np.isfinite(loss)
    batch = synthetic_pair_batch(2, 16, 64, 8, 16, seed=0, scalar_protein=True)
    layout = BatchLayout(batch.protein, batch.molecule)
    row = torch.zeros(layout.width, dtype=torch.int32)
    layout.pack(row, batch.protein, batch.molecule)
    for got, want in zip(layout.views(row), (batch.protein, batch.molecule)):
        for f in dataclasses.fields(GraphBatch):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), f.name
