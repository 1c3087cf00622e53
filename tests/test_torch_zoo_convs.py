"""Port parity for the model zoo's convolutions: caster_dta_torch's
GATv2Conv, HEATConv, GVPConv with a message mask and the autoregressive
GVPConvLayer against caster_dta_tpu's with the same weights (the JAX init,
carried over by caster_dta_torch.interop.from_jax) on the same seeded numpy
inputs, f32 on the CPU, within 1e-5 (sums in other orders). Remat of the GVP
message (``remat_message``) is held against the same steps without it, bit
for bit."""
import jax
import numpy as np
import pytest
import torch

from caster_dta_tpu.nn import conv as jconv
from caster_dta_tpu.nn import gvp as jgvp
from caster_dta_torch.interop.from_jax import StateDictWriter
from caster_dta_torch.nn import conv as tconv
from caster_dta_torch.nn import gvp as tgvp

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _load(module, build):
    sd = StateDictWriter()
    build(sd)
    module.load_state_dict(sd.tensors(strip="m."), strict=True)
    return module.eval()


def _graph(rng, b=2, n=12, e=44, e_pad=52, f=7, fe=5, types=4, etypes=3):
    """Edges sorted by dst over the rows below n - 2, padding edges at n-1
    masked, a few real edges masked too; node and edge types."""
    dst = np.sort(rng.integers(0, n - 2, (b, e)), axis=1)
    dst = np.concatenate([dst, np.full((b, e_pad - e), n - 1)], 1).astype(np.int32)
    mask = np.zeros((b, e_pad), bool)
    mask[:, :e] = rng.random((b, e)) < 0.9
    return dict(x=rng.normal(size=(b, n, f)).astype(np.float32),
                src=rng.integers(0, n, (b, e_pad)).astype(np.int32), dst=dst, mask=mask,
                e=rng.normal(size=(b, e_pad, fe)).astype(np.float32),
                ntype=rng.integers(0, types, (b, n)).astype(np.int32),
                etype=rng.integers(0, etypes, (b, e_pad)).astype(np.int32))


@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
@pytest.mark.parametrize("edge_dim", [None, 5])
@pytest.mark.parametrize("concat", [True, False])
def test_gatv2_conv_matches_jax(rng, concat, edge_dim, aggr):
    g = _graph(rng)
    jm = jconv.GATv2Conv(6, heads=3, concat=concat, aggr=aggr, edge_dim=edge_dim)
    args = (g["x"], g["src"], g["dst"], g["mask"], g["e"])
    p = jm.init(jax.random.PRNGKey(1), *args)["params"]
    p = jax.tree_util.tree_map(lambda a: a + 0.1, p)    # a non-zero bias
    tm = tconv.GATv2Conv(7, 6, heads=3, concat=concat, aggr=aggr, edge_dim=edge_dim)
    _load(tm, lambda sd: sd.gatv2_conv("m", p, tm))
    got = tm(*(_t(a) for a in args))
    assert got.shape[-1] == tm.out_dim == (18 if concat else 6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.apply({"params": p}, *args)),
                               **TOL)


@pytest.mark.parametrize("concat", [True, False])
def test_heat_conv_matches_jax(rng, concat):
    g = _graph(rng)
    jm = jconv.HEATConv(6, num_node_types=4, num_edge_types=3, edge_type_emb_dim=3, edge_dim=5,
                        edge_attr_emb_dim=4, heads=2, concat=concat)
    args = (g["x"], g["src"], g["dst"], g["mask"], g["ntype"], g["etype"], g["e"])
    p = jm.init(jax.random.PRNGKey(2), *args)["params"]
    p = jax.tree_util.tree_map(lambda a: a + 0.05, p)
    tm = _load(tconv.HEATConv(7, 6, num_node_types=4, num_edge_types=3, edge_type_emb_dim=3,
                              edge_dim=5, edge_attr_emb_dim=4, heads=2, concat=concat),
               lambda sd: sd.heat_conv("m", p))
    got = tm(*(_t(a) for a in args))
    assert got.shape[-1] == tm.out_dim == (12 if concat else 6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.apply({"params": p}, *args)),
                               **TOL)


def _gvp_inputs(rng, b=2, n=12, e=40, e_pad=48, ns=6, nv=3, es=5, ev=2):
    dst = np.sort(rng.integers(0, n - 2, (b, e)), axis=1)
    dst = np.concatenate([dst, np.full((b, e_pad - e), n - 1)], 1).astype(np.int32)
    mask = np.zeros((b, e_pad), bool)
    mask[:, :e] = True
    return dict(s=rng.normal(size=(b, n, ns)).astype(np.float32),
                v=rng.normal(size=(b, n, nv, 3)).astype(np.float32),
                s2=rng.normal(size=(b, n, ns)).astype(np.float32),
                v2=rng.normal(size=(b, n, nv, 3)).astype(np.float32),
                src=rng.integers(0, n, (b, e_pad)).astype(np.int32), dst=dst, mask=mask,
                es=rng.normal(size=(b, e_pad, es)).astype(np.float32),
                ev=rng.normal(size=(b, e_pad, ev, 3)).astype(np.float32),
                msg_mask=rng.random((b, e_pad)) < 0.5)


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_gvp_conv_message_mask_matches_jax(rng, aggr):
    x = _gvp_inputs(rng)
    jm = jgvp.GVPConv((5, 2), aggr=aggr)
    j_args = ((x["s"], x["v"]), x["src"], x["dst"], x["mask"], (x["es"], x["ev"]))
    p = jm.init(jax.random.PRNGKey(3), *j_args)["params"]
    tm = _load(tgvp.GVPConv((6, 3), (5, 2), (5, 2), aggr=aggr),
               lambda sd: [sd.gvp(f"m.message_func.{j}", p[f"message_{j}"]) for j in range(3)])
    want = jm.apply({"params": p}, *j_args, message_mask=x["msg_mask"])
    got = tm((_t(x["s"]), _t(x["v"])), _t(x["src"]), _t(x["dst"]), _t(x["mask"]),
             (_t(x["es"]), _t(x["ev"])), message_mask=_t(x["msg_mask"]))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    # the mask is ANDed in: a conv whose messages are all masked aggregates 0
    none = tm((_t(x["s"]), _t(x["v"])), _t(x["src"]), _t(x["dst"]), _t(x["mask"]),
              (_t(x["es"]), _t(x["ev"])), message_mask=torch.zeros(2, 48, dtype=torch.bool))
    assert all(torch.all(t == 0) for t in none)


def test_autoregressive_gvp_conv_layer_matches_jax(rng):
    x = _gvp_inputs(rng)
    jm = jgvp.GVPConvLayer(autoregressive=True)
    j_args = ((x["s"], x["v"]), x["src"], x["dst"], x["mask"], (x["es"], x["ev"]))
    p = jm.init(jax.random.PRNGKey(4), *j_args, autoregressive_x=(x["s2"], x["v2"]))["params"]
    tm = _load(tgvp.GVPConvLayer((6, 3), (5, 2), autoregressive=True),
               lambda sd: sd.gvp_conv_layer("m", p))
    assert tm.conv.aggr == "add"
    want = jm.apply({"params": p}, *j_args, autoregressive_x=(x["s2"], x["v2"]))
    got = tm((_t(x["s"]), _t(x["v"])), _t(x["src"]), _t(x["dst"]), _t(x["mask"]),
             (_t(x["es"]), _t(x["ev"])), autoregressive_x=(_t(x["s2"]), _t(x["v2"])))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("aggr", ["mean", "sum"])
def test_autoregressive_gvp_conv_layer_refuses_other_aggregations(rng, aggr):
    with pytest.raises(ValueError, match="aggr='add'"):
        tgvp.GVPConvLayer((6, 3), (5, 2), autoregressive=True, aggr=aggr)
    with pytest.raises(ValueError, match="aggr='add'"):
        x = _gvp_inputs(rng)
        jgvp.GVPConvLayer(autoregressive=True, aggr=aggr).init(
            jax.random.PRNGKey(0), (x["s"], x["v"]), x["src"], x["dst"], x["mask"],
            (x["es"], x["ev"]), autoregressive_x=(x["s2"], x["v2"]))


@pytest.mark.parametrize("autoregressive", [False, True])
def test_remat_message_is_bit_for_bit(rng, autoregressive):
    """Loss and every gradient of GVPConvLayer steps under remat_message()
    are the bits of the same steps without it (dropout on, the same
    generator seed); under it the message MLP runs again in the backward
    pass; the switch is scoped to its block."""
    x = _gvp_inputs(rng)
    calls = []

    def step(remat: bool):
        torch.manual_seed(0)
        layer = tgvp.GVPConvLayer((6, 3), (5, 2), drop_rate=0.2, autoregressive=autoregressive,
                                  generator=torch.Generator().manual_seed(5)).train()
        layer.conv.message_func[0].register_forward_hook(lambda *_: calls.append(remat))
        s = _t(x["s"]).requires_grad_()
        args = ((s, _t(x["v"])), _t(x["src"]), _t(x["dst"]), _t(x["mask"]),
                (_t(x["es"]), _t(x["ev"])))
        extra = {"autoregressive_x": (_t(x["s2"]), _t(x["v2"]))} if autoregressive else {}
        with tgvp.remat_message(remat):
            out = layer(*args, **extra, generator=torch.Generator().manual_seed(6))
        loss = (out[0] ** 2).sum() + (out[1] ** 3).sum()
        grads = torch.autograd.grad(loss, [s] + list(layer.parameters()))
        return loss, grads

    loss_a, grads_a = step(False)
    loss_b, grads_b = step(True)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))
    convs = 2 if autoregressive else 1
    assert calls.count(False) == convs and calls.count(True) == 2 * convs
    assert tgvp.switches() == (False, False)
