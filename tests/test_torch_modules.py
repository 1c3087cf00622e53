"""Port parity, module by module: each caster_dta_torch module against its
caster_dta_tpu counterpart with the same weights (the JAX init, carried over
by caster_dta_torch.interop.from_jax) on the same numpy inputs, f32 on the
CPU. Tolerance rtol/atol 1e-5: the two sides sum matmuls and norms in
different orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caster_dta_tpu.models import common as jcommon
from caster_dta_tpu.nn import attention as jattn
from caster_dta_tpu.nn import common as jnn
from caster_dta_tpu.nn import conv as jconv
from caster_dta_tpu.nn import gvp as jgvp
from caster_dta_torch.interop.from_jax import StateDictWriter
from caster_dta_torch.models import common as tcommon
from caster_dta_torch.nn import attention as tattn
from caster_dta_torch.nn import common as tnn
from caster_dta_torch.nn import conv as tconv
from caster_dta_torch.nn import gvp as tgvp

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _load(module, build):
    """Fill ``module`` from the entries ``build(StateDictWriter)`` puts
    under the prefix "m."."""
    sd = StateDictWriter()
    build(sd)
    module.load_state_dict(sd.tensors(strip="m."), strict=True)
    return module.eval()


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


@pytest.mark.parametrize("name", ["relu", "leaky_relu", "gelu", "sigmoid", "silu", "elu", "tanh"])
def test_activations_match_jax(rng, name):
    x = rng.normal(size=(64,)).astype(np.float32) * 3
    _close(tnn.select_activation(name)(_t(x)), jnn.select_activation(name)(jnp.asarray(x)))


def test_dense_and_mlp_match_jax(rng):
    x = rng.normal(size=(4, 7)).astype(np.float32)
    jm = jnn.MLP((7, 9, 5), act="leaky_relu")
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = _load(tnn.MLP((7, 9, 5), act="leaky_relu"),
               lambda sd: [sd.linear(f"m.lins.{i}", p[f"lin{i}"]) for i in range(2)])
    _close(tm(_t(x)), jm.apply({"params": p}, jnp.asarray(x)))
    # torch-style init bound 1/sqrt(fan_in) for weight and bias
    d = tnn.Dense(16, 8, generator=torch.Generator().manual_seed(0))
    assert d.weight.abs().max() <= 0.25 and d.bias.abs().max() <= 0.25


@pytest.mark.parametrize("in_dims,out_dims,gate,acts", [
    ((6, 3), (5, 2), True, ("relu", None)),
    ((6, 3), (5, 2), False, ("relu", "sigmoid")),
    ((6, 3), (4, 0), True, ("relu", None)),
    ((6, 0), (4, 2), False, (None, None)),
])
def test_gvp_matches_jax(rng, in_dims, out_dims, gate, acts):
    s = rng.normal(size=(2, 9, in_dims[0])).astype(np.float32)
    v = rng.normal(size=(2, 9, in_dims[1], 3)).astype(np.float32)
    jm = jgvp.GVP(out_dims, activations=acts, vector_gate=gate)
    p = jm.init(jax.random.PRNGKey(1), (jnp.asarray(s), jnp.asarray(v)))["params"]
    tm = _load(tgvp.GVP(in_dims, out_dims, activations=acts, vector_gate=gate),
               lambda sd: sd.gvp("m", p))
    ws, wv = jm.apply({"params": p}, (jnp.asarray(s), jnp.asarray(v)))
    gs, gv = tm((_t(s), _t(v)))
    assert gv.shape == wv.shape
    _close(gs, ws)
    _close(gv, wv)


def test_gvp_layernorm_matches_jax(rng):
    s = rng.normal(size=(3, 5, 8)).astype(np.float32) * 2 + 1
    v = rng.normal(size=(3, 5, 4, 3)).astype(np.float32)
    jm = jgvp.GVPLayerNorm()
    p = jm.init(jax.random.PRNGKey(0), (jnp.asarray(s), jnp.asarray(v)))["params"]
    p = jax.tree_util.tree_map(lambda a: a + 0.1 * jnp.arange(a.size).reshape(a.shape), p)
    tm = _load(tgvp.GVPLayerNorm((8, 4)), lambda sd: sd.gvp_layernorm("m", p))
    ws, wv = jm.apply({"params": p}, (jnp.asarray(s), jnp.asarray(v)))
    gs, gv = tm((_t(s), _t(v)))
    _close(gs, ws)
    _close(gv, wv)
    # the 1e-8 clamp keeps an all-zero vector channel finite
    _, gz = tm((_t(s), torch.zeros(3, 5, 4, 3)))
    assert torch.isfinite(gz).all()


def test_gvp_dropout_identity_in_eval_and_drops_whole_vectors():
    d = tgvp.GVPDropout(0.5)
    s, v = torch.ones(4, 6, 8), torch.ones(4, 6, 5, 3)
    assert d.eval()((s, v))[1] is v
    gs, gv = d.train()((s, v), torch.Generator().manual_seed(0))
    assert set(gs.unique().tolist()) <= {0.0, 2.0}
    per_vector = gv.reshape(-1, 3)
    assert torch.all((per_vector == 0).all(-1) | (per_vector == 2).all(-1))


def _conv_inputs(rng, b=2, n=12, e=40, e_pad=48, ns=6, nv=3, es=5, ev=2):
    dst = np.sort(rng.integers(0, n - 2, (b, e)), axis=1)
    dst = np.concatenate([dst, np.full((b, e_pad - e), n - 1)], 1).astype(np.int32)
    src = rng.integers(0, n, (b, e_pad)).astype(np.int32)
    mask = np.zeros((b, e_pad), bool)
    mask[:, :e] = True
    return dict(
        s=rng.normal(size=(b, n, ns)).astype(np.float32),
        v=rng.normal(size=(b, n, nv, 3)).astype(np.float32),
        src=src, dst=dst, mask=mask,
        es=rng.normal(size=(b, e_pad, es)).astype(np.float32),
        ev=rng.normal(size=(b, e_pad, ev, 3)).astype(np.float32))


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_gvp_conv_layer_matches_jax(rng, aggr):
    x = _conv_inputs(rng)
    jm = jgvp.GVPConvLayer(activations=("relu", None), vector_gate=True, aggr=aggr)
    j_args = ((jnp.asarray(x["s"]), jnp.asarray(x["v"])), jnp.asarray(x["src"]),
              jnp.asarray(x["dst"]), jnp.asarray(x["mask"]),
              (jnp.asarray(x["es"]), jnp.asarray(x["ev"])))
    p = jm.init(jax.random.PRNGKey(2), *j_args)["params"]
    tm = _load(tgvp.GVPConvLayer((6, 3), (5, 2), activations=("relu", None), vector_gate=True,
                                 aggr=aggr), lambda sd: sd.gvp_conv_layer("m", p))
    ws, wv = jm.apply({"params": p}, *j_args, deterministic=True)
    t_args = ((_t(x["s"]), _t(x["v"])), _t(x["src"]), _t(x["dst"]), _t(x["mask"]),
              (_t(x["es"]), _t(x["ev"])))
    gs, gv = tm(*t_args)
    _close(gs, ws)
    _close(gv, wv)


def test_gvp_conv_layer_equivariance(rng):
    """Rotating every input vector rotates the output vectors by the same
    rotation and leaves the scalars unchanged."""
    x = _conv_inputs(rng)
    tm = tgvp.GVPConvLayer((6, 3), (5, 2), activations=("relu", None), vector_gate=True,
                           aggr="sum", generator=torch.Generator().manual_seed(3)).eval()
    rot = torch.from_numpy(_rotation(rng))
    edges = (_t(x["src"]), _t(x["dst"]), _t(x["mask"]))
    s1, v1 = tm((_t(x["s"]), _t(x["v"])), *edges, (_t(x["es"]), _t(x["ev"])))
    s2, v2 = tm((_t(x["s"]), _t(x["v"]) @ rot), *edges, (_t(x["es"]), _t(x["ev"]) @ rot))
    torch.testing.assert_close(s2, s1, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v2, v1 @ rot, rtol=1e-4, atol=1e-5)


def test_gvp_conv_layer_node_mask_keeps_masked_rows(rng):
    x = _conv_inputs(rng)
    tm = tgvp.GVPConvLayer((6, 3), (5, 2), generator=torch.Generator().manual_seed(0)).eval()
    node_mask = torch.zeros(2, 12, dtype=torch.bool)
    node_mask[:, :5] = True
    s, v = tm((_t(x["s"]), _t(x["v"])), _t(x["src"]), _t(x["dst"]), _t(x["mask"]),
              (_t(x["es"]), _t(x["ev"])), node_mask=node_mask)
    assert torch.equal(s[:, 5:], _t(x["s"])[:, 5:]) and torch.equal(v[:, 5:], _t(x["v"])[:, 5:])


@pytest.mark.parametrize("train_eps", [True, False])
def test_gine_conv_matches_jax(rng, train_eps):
    b, n, e, f, fe = 2, 10, 24, 7, 4
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    src = rng.integers(0, n, (b, e)).astype(np.int32)
    dst = np.sort(rng.integers(0, n, (b, e)), axis=1).astype(np.int32)
    mask = rng.random((b, e)) < 0.8
    ea = rng.normal(size=(b, e, fe)).astype(np.float32)
    jm = jconv.GINEConv(9, act="leaky_relu", train_eps=train_eps)
    j_args = tuple(map(jnp.asarray, (x, src, dst, mask, ea)))
    p = jm.init(jax.random.PRNGKey(4), *j_args)["params"]
    if train_eps:
        p = {**p, "eps": jnp.asarray([0.3], jnp.float32)}
    tm = tconv.GINEConv(f, 9, fe, act="leaky_relu", train_eps=train_eps)

    def build(sd):
        sd.linear("m.lin", p["edge_lin"])
        sd.linear("m.nn.lins.0", p["mlp"]["lin0"])
        sd.linear("m.nn.lins.1", p["mlp"]["lin1"])
        sd.put("m.eps", np.asarray(p["eps"]) if train_eps else np.zeros(1))

    _load(tm, build)
    _close(tm(*map(_t, (x, src, dst, mask, ea))), jm.apply({"params": p}, *j_args))


@pytest.mark.parametrize("kdim", [16, 12])
def test_multihead_attention_matches_jax(rng, kdim):
    b, lq, lk, e, h = 2, 7, 9, 16, 4
    q = rng.normal(size=(b, lq, e)).astype(np.float32)
    kv = rng.normal(size=(b, lk, kdim)).astype(np.float32)
    pad = rng.random((b, lk)) < 0.3
    pad[0, :] = True          # a fully masked row: uniform weights over the keys
    jm = jattn.MultiheadAttention(e, h)
    j_args = (jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    p = jm.init(jax.random.PRNGKey(5), *j_args, key_padding_mask=jnp.asarray(pad))["params"]
    p = jax.tree_util.tree_map(lambda a: a + 0.01, p)   # nonzero biases
    tm = tattn.MultiheadAttention(e, h, kdim=kdim, vdim=kdim)
    _load(tm, lambda sd: sd.mha("m", p, tm.packed))
    assert tm.packed == (kdim == e)
    w_out, w_w = jm.apply({"params": p}, *j_args, key_padding_mask=jnp.asarray(pad))
    g_out, g_w = tm(_t(q), _t(kv), _t(kv), key_padding_mask=_t(pad))
    assert g_w.shape == (b, lq, lk)
    _close(g_out, w_out)
    _close(g_w, w_w)


@pytest.mark.parametrize("emb_dim", [None, 3])
def test_type_embedding_matches_jax(rng, emb_dim):
    types = rng.integers(0, 6, (2, 8)).astype(np.int32)
    types[0, 0] = 6           # outside [0, num_types): a zero row, as jax.nn.one_hot
    jm = jcommon.TypeEmbedding(6, emb_dim)
    p = jm.init(jax.random.PRNGKey(6), jnp.asarray(types)).get("params", {})
    tm = tcommon.TypeEmbedding(6, emb_dim)
    if emb_dim is not None:
        tm.weight.data = _t(p["embedding"]["embedding"]).clone()
        types[0, 0] = 5
    got = tm(_t(types))
    want = jm.apply({"params": p}, jnp.asarray(types))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert tm.out_dim == (6 if emb_dim is None else emb_dim)


@pytest.mark.parametrize("mode", ["mean", "max", "sum"])
def test_masked_pool_matches_jax(rng, mode):
    x = rng.normal(size=(3, 6, 4)).astype(np.float32)
    mask = rng.random((3, 6)) < 0.6
    mask[:, 0] = True
    _close(tcommon.masked_pool(_t(x), _t(mask), mode),
           jcommon.masked_pool(jnp.asarray(x), jnp.asarray(mask), mode))
