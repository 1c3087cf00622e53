"""Port parity for the whole served model: caster_dta_torch's JointGNN
against caster_dta_tpu's with the same weights, its msgpack reader against
flax's, and the trained runs/davis_seed9 checkpoint served by both packages
on the same batch.

Tolerances: 1e-5 (rtol/atol) on embeddings and attention maps of a small
random model; 1e-4 absolute on the unscaled affinities (pKd units) of the
trained model. Both are f32 on the CPU with sums taken in different orders.
"""
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from caster_dta_tpu.inference.checkpoint import load_model_from_checkpoint
from caster_dta_tpu.interop.torch_import import import_joint_gnn
from caster_dta_tpu.models.joint import make_joint_gnn as jax_make_joint_gnn
from caster_dta_torch.data.batching import synthetic_pair_batch
from caster_dta_torch.inference import serve
from caster_dta_torch.interop.from_jax import load_jax_params
from caster_dta_torch.models.joint import make_joint_gnn
from caster_dta_torch.train import checkpoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "runs", "davis_seed9")

SMALL = dict(
    protein_gnn_kwargs=dict(
        base_conv="lbamodel", in_channels=[17, 3], edge_dim=[32, 1], num_ntypes=21,
        num_etypes=1, ntype_emb_dim=None, etype_emb_dim=None, num_convs=2,
        hidden_channels=[8, 2], edge_hidden_channels=[8, 1], out_channels=16,
        dropout_rate=0.2, activation="leaky_relu", aggr="sum"),
    molecule_gnn_kwargs=dict(
        base_conv="gine", in_channels=41, edge_dim=9, num_ntypes=10, num_etypes=5,
        ntype_emb_dim=None, etype_emb_dim=None, num_convs=2, hidden_channels=8,
        out_channels=16, dropout_rate=0.2, activation="leaky_relu", aggr="sum",
        gin_trainable_eps=True),
    joint_gnn_kwargs=dict(
        residue_lin_depth=1, atom_lin_depth=1, n_attention_heads=4, attention_dropout=0.0,
        protein_lin_depth=1, molecule_lin_depth=1, pairwise_embedding_dim=32,
        out_lin_depth=1, out_lin_factor=0.5, out_lin_norm_type=None,
        activation="leaky_relu", dropout=0.1, element_pooling="mean",
        include_residual_stream=True, residual_dim_ff_scale=2, num_cross_attn_layers=1,
        include_post_pool_layernorm=False))


def _jax_model(kwargs):
    return jax_make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                              **kwargs["joint_gnn_kwargs"])


def _port_model(kwargs, seed=0):
    return make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                          generator=torch.Generator().manual_seed(seed),
                          **kwargs["joint_gnn_kwargs"]).eval()


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("pooling,norm", [("mean", None), ("max", "layer")])
def test_joint_gnn_matches_jax(pooling, norm):
    """JAX init carried into the port: same score, tower embeddings and
    attention maps on the same batch."""
    kwargs = json.loads(json.dumps(SMALL))
    kwargs["joint_gnn_kwargs"].update(element_pooling=pooling, out_lin_norm_type=norm,
                                      include_post_pool_layernorm=norm is not None)
    jb = graft._synthetic_batch(3, 24, 160, 12, 40, seed=1)
    tb = synthetic_pair_batch(3, 24, 160, 12, 40, seed=1)
    jm = _jax_model(kwargs)
    variables = jm.init(jax.random.PRNGKey(0), jb.protein, jb.molecule)
    if pooling == "max":   # flax inits LayerNorm to (1, 0): move off it
        variables = jax.tree_util.tree_map(lambda a: a + 0.05, variables)
    (score, attn), inter = jm.apply(variables, jb.protein, jb.molecule, deterministic=True,
                                    capture_intermediates=True, mutable=["intermediates"])
    inter = inter["intermediates"]
    tm = load_jax_params(_port_model(kwargs), jax.device_get(variables["params"]))
    with torch.no_grad():
        residue = tm.protein_gnn.gnn_model(tb.protein)
        atom = tm.molecule_gnn.gnn_model(tb.molecule)
        t_score, t_attn = tm(tb.protein, tb.molecule)
    _close(residue, inter["protein_gnn"]["__call__"][0])
    _close(atom, inter["molecule_gnn"]["__call__"][0])
    _close(t_score, score)
    assert len(t_attn) == len(attn) == 1
    _close(t_attn[0][0], attn[0][0])
    _close(t_attn[0][1], attn[0][1])


def test_port_state_dict_imports_into_jax():
    """The other direction: the port's random init, through the JAX package's
    own torch importer, gives the JAX model the same outputs."""
    tm = _port_model(SMALL, seed=3)
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    variables = import_joint_gnn(sd, SMALL)
    jb = graft._synthetic_batch(2, 20, 120, 10, 30, seed=2)
    tb = synthetic_pair_batch(2, 20, 120, 10, 30, seed=2)
    score, attn = _jax_model(SMALL).apply(variables, jb.protein, jb.molecule, deterministic=True)
    with torch.no_grad():
        t_score, t_attn = tm(tb.protein, tb.molecule)
    _close(t_score, score)
    _close(t_attn[0][0], attn[0][0])


def test_training_mode_dropout_follows_the_generator():
    """Dropout (GVP, GINE tower, cross-attention, head) draws only from the
    generator it is given, and is off in eval mode."""
    tm = _port_model(SMALL, seed=4)
    tb = synthetic_pair_batch(2, 20, 120, 10, 30, seed=3)
    with torch.no_grad():
        ref, _ = tm(tb.protein, tb.molecule)
        tm.train()
        a, _ = tm(tb.protein, tb.molecule, generator=torch.Generator().manual_seed(1))
        b, _ = tm(tb.protein, tb.molecule, generator=torch.Generator().manual_seed(1))
        c, _ = tm(tb.protein, tb.molecule, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, ref)


def test_unported_options_raise():
    """No molecule tower is left to port: GIN, AttentiveFP, GPS and PNA build
    in the served model and answer (tests/test_torch_zoo_molecule.py and
    tests/test_torch_zoo_joint.py hold them against JAX); a PNA tower
    without its degree histogram raises, as JAX's cannot compute its delta;
    batch norm and the GATv2 and HEAT towers build."""
    batch = synthetic_pair_batch(2, 16, 64, 8, 16, seed=0)
    for base_conv in ("gin", "attentivefp", "gps", "pna"):
        kwargs = json.loads(json.dumps(SMALL))
        kwargs["molecule_gnn_kwargs"].update(base_conv=base_conv, degree_hist=[1, 4, 6, 2])
        with torch.no_grad():
            score, _ = _port_model(kwargs).eval()(batch.protein, batch.molecule)
        assert score.shape == (2, 1) and bool(torch.isfinite(score).all())
    kwargs = json.loads(json.dumps(SMALL))
    kwargs["molecule_gnn_kwargs"]["base_conv"] = "pna"
    with pytest.raises(ValueError, match="degree_hist"):
        _port_model(kwargs)
    kwargs = json.loads(json.dumps(SMALL))
    kwargs["joint_gnn_kwargs"]["out_lin_norm_type"] = "batch"
    kwargs["molecule_gnn_kwargs"]["base_conv"] = "gatv2"
    _port_model(kwargs)


def test_msgpack_reader_matches_flax_on_trained_checkpoint():
    path = checkpoints.get_best_model(RUN, "val")
    assert os.path.basename(path) == "bestvalmodel_davis_val0.2364_epoch01390.msgpack"
    got = checkpoints.load_params(path)
    with open(path, "rb") as f:
        want = flax.serialization.msgpack_restore(f.read())
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(got_leaves) == len(want_leaves) == 149
    assert {"atom_lin0", "cross_attn_0", "protein_gnn", "molecule_gnn"} <= set(got)
    for (gp, g), (wp, w) in zip(got_leaves, want_leaves):
        assert gp == wp
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_msgpack_reader_types():
    """Every msgpack type a flax checkpoint can hold, and the widths of each:
    fix/16/32 maps, arrays and strings, bin, ints of every size, floats, nil,
    bool, the ndarray ext (f32, i64, bf16) and the numpy-scalar ext."""
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129,
                 -32768, -32769, -2 ** 31 - 1],
        "floats": [0.5, -1.25e300],
        "text": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000],
        "bin": b"\x00\x01" * 200,
        "flags": [None, True, False],
        "big_map": {f"k{i}": i for i in range(20)},
        "long_list": list(range(20)),
        "arrays": {"f32": np.arange(12, dtype=np.float32).reshape(3, 4),
                   "i64": np.array([-5, 7], dtype=np.int64),
                   "bf16": jnp.asarray([1.5, -2.0, 3.25], dtype=jnp.bfloat16),
                   "empty": np.zeros((0, 3), np.float32)},
        "scalar": np.float32(2.5),
    }
    blob = flax.serialization.msgpack_serialize(tree)
    got = checkpoints.unpackb(blob)
    assert got["ints"] == tree["ints"]
    assert got["floats"] == tree["floats"]
    assert got["text"] == tree["text"]
    assert got["bin"] == tree["bin"]
    assert got["flags"] == tree["flags"]
    assert got["big_map"] == tree["big_map"]
    assert got["long_list"] == tree["long_list"]
    np.testing.assert_array_equal(got["arrays"]["f32"], tree["arrays"]["f32"])
    np.testing.assert_array_equal(got["arrays"]["i64"], tree["arrays"]["i64"])
    assert got["arrays"]["bf16"].dtype == np.float32
    np.testing.assert_array_equal(got["arrays"]["bf16"], [1.5, -2.0, 3.25])
    assert got["arrays"]["empty"].shape == (0, 3)
    assert got["scalar"] == np.float32(2.5)
    with pytest.raises(ValueError, match="truncated"):
        checkpoints.unpackb(blob[:-3])
    with pytest.raises(ValueError, match="ext type"):
        checkpoints.unpackb(msgpack.packb(msgpack.ExtType(9, b"xy")))


def test_trained_run_matches_jax():
    """runs/davis_seed9 read by the port's own reader gives the same
    unscaled affinities and attention maps as the JAX package's loader."""
    model, variables, kwargs = load_model_from_checkpoint(RUN)
    jb = graft._synthetic_batch(4, 64, 640, 32, 128, seed=7)
    score, attn = model.apply(variables, jb.protein, jb.molecule, deterministic=True)
    with open(os.path.join(RUN, "dataset_rescale_params.json")) as f:
        std = json.load(f)["standardize"]
    want = np.asarray(score)[:, 0] * std["scale_std_factor"] + std["scale_mean_factor"]

    run = serve.load_run(RUN, device="cpu")
    assert run.model_kwargs == kwargs
    aff, (w_rd, w_da) = serve.predict(run, synthetic_pair_batch(4, 64, 640, 32, 128, seed=7))
    np.testing.assert_allclose(aff.numpy(), want, rtol=0, atol=1e-4)
    _close(w_rd, attn[0][0])
    _close(w_da, attn[0][1])


def test_unscale_target():
    v = torch.tensor([-1.0, 0.0, 2.0])
    std = {"scale_output": ["standardize"],
           "standardize": {"scale_mean_factor": 5.0, "scale_std_factor": 0.5}}
    assert torch.allclose(serve.unscale_target(v, std), torch.tensor([4.5, 5.0, 6.0]))
    both = {"scale_output": ["log", "minmax"],
            "minmax": {"scale_min_factor": 0.0, "scale_max_factor": 2.0}, "log": {}}
    # minmax undone first, then log
    assert torch.allclose(serve.unscale_target(v, both), torch.expm1(v + 1))


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.load_run(RUN)


def test_get_best_model(tmp_path):
    for name in ("bestvalmodel_a_val0.5.msgpack", "bestvalmodel_a_val0.3.msgpack",
                 "finalmodel_x.msgpack", "bestvalmodel_b.pt"):
        (tmp_path / name).write_bytes(b"")
    assert checkpoints.get_best_model(str(tmp_path)).endswith("val0.3.msgpack")
    assert checkpoints.get_best_model(str(tmp_path), "final").endswith("finalmodel_x.msgpack")
    with pytest.raises(FileNotFoundError):
        checkpoints.get_best_model(str(tmp_path), "train")
