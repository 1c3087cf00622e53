"""Port parity for the rest of the molecule zoo: caster_dta_torch's GINConv,
GATConv, GATEConv, GRUCell, PNAConv, random_walk_pe and the GIN,
AttentiveFP, GPS and PNA towers against caster_dta_tpu's, with the same
weights (the JAX init, shifted so that no bias is 0, carried over by
caster_dta_torch.interop.from_jax) on the same seeded numpy inputs, f32 on
the CPU. Tolerance 1e-5 (rtol and atol) on outputs and on the gradients of
sum(out * w) for a seeded w, with respect to the inputs and to every
parameter (the JAX gradient tree mapped through the same bridge): sums in
other orders. PNA's std under its amplifying scalers is ill-conditioned in
f32 in either package: its gradients are held against JAX's f64 ones within
chip_smoke.py's STEP_GRAD_RTOL of each tensor's largest entry
(test_pna_conv_matches_jax says why).

Also: PNA's std at a node with one in-edge, where mean(m^2) - mean(m)^2 is
exactly 0 in both packages and jnp.maximum and torch.maximum both give the
tie half the gradient; PNA's delta in float64, as JAX's; the registry has
all seven towers; a GPS model cannot train in either package.

The JointGNNs on chip_smoke.py's zoo-lba-* configurations are served
against JAX by tests/test_torch_zoo_joint.py (its ``ZOO`` holds every
configuration of chip_smoke.zoo_configs()); their training is in
tests/test_torch_zoo_molecule_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from caster_dta_tpu.models import molecule as jmol
from caster_dta_tpu.nn import conv as jconv
from caster_dta_tpu.ops import segment as jseg
from caster_dta_tpu.train.loop import Trainer as JaxTrainer, TrainConfig as JaxTrainConfig
from caster_dta_torch.interop.from_jax import StateDictWriter
from caster_dta_torch.models import molecule as tmol
from caster_dta_torch.nn import conv as tconv
from caster_dta_torch.ops import segment as tseg
from caster_dta_torch.train.loop import Trainer, TrainConfig
from tests.test_joint import _molecule_batch
from tests.test_model_zoo import MOL_COMMON
from tests.test_torch_zoo_convs import _graph
from tests.test_torch_zoo_models import ZOO, _both_models, _torch_graph

TOL = dict(rtol=1e-5, atol=1e-5)
HIST = (0, 5, 9, 4, 2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _shift(params, by=0.1):
    return jax.tree_util.tree_map(lambda a: a + by, params)


def _check_conv(rng, jm, tm, j_args, t_args, grad_at, build, step_bound=False):
    """Forward, then the gradients of sum(out * w) with respect to the inputs
    at ``grad_at`` and to every parameter, JAX against the port; ``build(sd,
    tree)`` maps a JAX tree (the params, then their gradients) onto the
    port's names. With ``step_bound`` each gradient is held instead against
    JAX's f64 gradient (``jax.enable_x64``) within STEP_GRAD_RTOL of its
    largest entry (see test_pna_conv_matches_jax)."""
    params = _shift(jm.init(jax.random.PRNGKey(1), *j_args)["params"])
    sd = StateDictWriter()
    build(sd, params)
    tm.load_state_dict(sd.tensors(strip="m."), strict=True)
    tm.eval()
    want = np.asarray(jm.apply({"params": params}, *j_args))
    w = rng.normal(size=want.shape).astype(np.float32)

    def jax_grads(dtype):
        def cast(a):
            a = np.asarray(a)
            return a.astype(dtype) if np.issubdtype(a.dtype, np.floating) else a

        args = [cast(a) for a in j_args]

        def loss(p, *inputs):
            for i, x in zip(grad_at, inputs):
                args[i] = x
            return (jm.apply({"params": p}, *args) * cast(w)).sum()

        grads = jax.grad(loss, argnums=tuple(range(len(grad_at) + 1)))(
            jax.tree_util.tree_map(cast, params), *(args[i] for i in grad_at))
        sd = StateDictWriter()
        build(sd, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), grads[0]))
        named = {f"input {i}": np.asarray(g, np.float64) for i, g in zip(grad_at, grads[1:])}
        return {**named, **{k: v.numpy() for k, v in sd.tensors(strip="m.").items()}}

    t_in = list(t_args)
    for i in grad_at:
        t_in[i] = t_in[i].clone().requires_grad_()
    got = tm(*t_in)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    (got * _t(w)).sum().backward()
    got_grads = {**{f"input {i}": t_in[i].grad.numpy() for i in grad_at},
                 **{k: prm.grad.numpy() for k, prm in tm.named_parameters()}}
    if step_bound:
        with jax.enable_x64(True):
            want_grads = jax_grads(np.float64)
    else:
        want_grads = jax_grads(np.float32)
    assert set(got_grads) <= set(want_grads)
    for name, g in got_grads.items():
        if step_bound:
            atol = chip_smoke.STEP_GRAD_RTOL * float(np.abs(want_grads[name]).max())
            np.testing.assert_allclose(g, want_grads[name], rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_allclose(g, want_grads[name], **TOL, err_msg=name)


@pytest.mark.parametrize("aggr", ["sum", "mean"])
@pytest.mark.parametrize("train_eps", [True, False])
def test_gin_conv_matches_jax(rng, train_eps, aggr):
    g = _graph(rng)
    jm = jconv.GINConv(6, act="leaky_relu", train_eps=train_eps, aggr=aggr)
    tm = tconv.GINConv(7, 6, act="leaky_relu", train_eps=train_eps, aggr=aggr)
    args = (g["x"], g["src"], g["dst"], g["mask"])
    _check_conv(rng, jm, tm, args, tuple(map(_t, args)), (0,),
                lambda sd, p: sd.gin_conv("m", p, tm))


@pytest.mark.parametrize("conv", ["gin", "gine"])
def test_fixed_eps_keeps_a_bf16_input_in_bf16(rng, conv):
    """JAX's fixed eps is zeros in x's dtype (caster_dta_tpu/nn/conv.py:37-38,
    61-62): GIN keeps a bf16 x in bf16 through (1 + eps) x and the MLP (an
    f32 eps would promote it); GINE's f32 edge projection promotes the sum
    to f32 in both packages."""
    g = _graph(rng)
    x = g["x"].astype(jnp.bfloat16)
    if conv == "gin":
        jm, tm = jconv.GINConv(6, train_eps=False), tconv.GINConv(7, 6, train_eps=False)
        args = (g["src"], g["dst"], g["mask"])
    else:
        jm, tm = jconv.GINEConv(6, train_eps=False), tconv.GINEConv(7, 6, 5, train_eps=False)
        args = (g["src"], g["dst"], g["mask"], g["e"])
    params = _shift(jm.init(jax.random.PRNGKey(1), x, *args)["params"])
    sd = StateDictWriter()
    getattr(sd, f"{conv}_conv")("m", params, tm)
    tm.load_state_dict(sd.tensors(strip="m."), strict=True)
    want = jm.apply({"params": params}, x, *args)
    got = tm(_t(np.asarray(x, np.float32)).to(torch.bfloat16), *map(_t, args))
    assert str(got.dtype) == "torch." + str(want.dtype)
    assert got.dtype == (torch.bfloat16 if conv == "gin" else torch.float32)
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("heads,concat", [(1, True), (3, True), (3, False)])
def test_gat_conv_matches_jax(rng, heads, concat):
    g = _graph(rng)
    jm = jconv.GATConv(6, heads=heads, concat=concat, negative_slope=0.01)
    tm = tconv.GATConv(7, 6, heads=heads, concat=concat, negative_slope=0.01)
    assert tm.out_dim == (heads * 6 if concat else 6)
    args = (g["x"], g["src"], g["dst"], g["mask"])
    _check_conv(rng, jm, tm, args, tuple(map(_t, args)), (0,),
                lambda sd, p: sd.gat_conv("m", p))


def test_gate_conv_matches_jax(rng):
    g = _graph(rng)
    jm = jconv.GATEConv(6, edge_dim=5)
    tm = tconv.GATEConv(7, 6, edge_dim=5)
    args = (g["x"], g["src"], g["dst"], g["mask"], g["e"])
    _check_conv(rng, jm, tm, args, tuple(map(_t, args)), (0, 4),
                lambda sd, p: sd.gate_conv("m", p))


def test_gru_cell_matches_jax(rng):
    """torch's gate layout with the two biases apart: r multiplies h_n with
    b_hn inside it, so merging the biases would move every entry where
    r != 1."""
    inp = rng.normal(size=(2, 9, 7)).astype(np.float32)
    h = rng.normal(size=(2, 9, 6)).astype(np.float32)
    jm, tm = jconv.GRUCell(6), tconv.GRUCell(7, 6)
    _check_conv(rng, jm, tm, (inp, h), (_t(inp), _t(h)), (0, 1),
                lambda sd, p: sd.gru_cell("m", p))
    # and it is torch's GRUCell with the same weights
    ref = torch.nn.GRUCell(7, 6)
    ref.load_state_dict(tm.state_dict())
    torch.testing.assert_close(tm(_t(inp), _t(h)), ref(_t(inp).reshape(-1, 7),
                                                       _t(h).reshape(-1, 6)).reshape(2, 9, 6))


def _pna_conv(f_in, out, edge_dim, delta, aggregators=("mean", "min", "max", "std"),
              scalers=("identity", "amplification", "attenuation"), towers=2):
    kw = dict(aggregators=aggregators, scalers=scalers, towers=towers, delta=delta)
    return (jmol._PNAConv(out, edge_dim=edge_dim, **kw),
            tconv.PNAConv(f_in, out, edge_dim, **kw))


@pytest.mark.parametrize("aggregators,scalers", [
    (("mean", "min", "max", "std"), ("identity", "amplification", "attenuation")),
    (("sum", "std"), ("attenuation",)),
    (("mean", "min", "max", "sum"), ("identity", "amplification", "attenuation"))])
def test_pna_conv_matches_jax(rng, aggregators, scalers):
    """Outputs within TOL of JAX's; gradients within chip_smoke.py's
    STEP_GRAD_RTOL (1e-4) of each tensor's largest entry, against JAX's f64
    gradient. std's gradient is ill-conditioned in f32: the cotangent of
    mean(m^2) - mean(m)^2 is std's times up to 1/(2 sqrt(1e-5)) = 158 and
    the scalers' delta / log(deg + 1), so an f32 rounding of m or of the
    mean moves m's gradient by ~1e-5 of its scale, and the weight
    gradients, sums over edges, by up to 1.5e-5 (pre_nns) in the port and
    3.4e-6-6.3e-6 in JAX against f64; JAX's own f32 gradient moves by as
    much with XLA's compile flags. Without std, and with std under the
    identity scaler (test_pna_std_at_a_single_in_edge), the gradients are
    held to TOL against JAX's f32 ones."""
    g = _graph(rng)
    jm, tm = _pna_conv(7, 6, 5, tmol.pna_delta(HIST), aggregators, scalers)
    args = (g["x"], g["src"], g["dst"], g["mask"], g["e"])
    _check_conv(rng, jm, tm, args, tuple(map(_t, args)), (0, 4),
                lambda sd, p: sd.pna_conv("m", p, tm), step_bound="std" in aggregators)


def test_pna_std_at_a_single_in_edge(rng):
    """Nodes with one real in-edge (and nodes with none): there mean(m^2) -
    mean(m)^2 is exactly 0 in JAX as in the port (the same products and
    sums, no fused multiply-add), the sqrt's derivative is 1/(2 sqrt(1e-5))
    and the max's tie takes half of it in both; values, input and parameter
    gradients as _check_conv holds them."""
    b, n, f = 2, 8, 5
    # nodes 0-2 take one edge each, node 3 takes three, the rest none; the
    # padding edges at n-1 are masked
    dst = np.array([[0, 1, 2, 3, 3, 3, 7, 7]] * b, np.int32)
    src = rng.integers(0, n, (b, 8)).astype(np.int32)
    mask = np.array([[True] * 6 + [False] * 2] * b)
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    e = rng.normal(size=(b, 8, 3)).astype(np.float32)
    m = rng.normal(size=(b, 8, f)).astype(np.float32)
    for seg, t in ((jseg, np.asarray), (tseg, _t)):
        sq = np.asarray(seg.segment_mean(t(m * m), t(dst), t(mask), n))
        mean = np.asarray(seg.segment_mean(t(m), t(dst), t(mask), n))
        assert np.all((sq - mean * mean)[:, :3] == 0.0)
    jm, tm = _pna_conv(f, 4, 3, tmol.pna_delta(HIST), aggregators=("std",),
                       scalers=("identity",))
    args = (x, src, dst, mask, e)
    _check_conv(rng, jm, tm, args, tuple(map(_t, args)), (0, 4),
                lambda sd, p: sd.pna_conv("m", p, tm))
    # the tie's gradient is JAX's 0.5, not clamp's 1 or 0
    v = torch.zeros(3, requires_grad=True)
    torch.maximum(v, v.new_zeros(())).sum().backward()
    assert v.grad.tolist() == [0.5] * 3
    assert np.asarray(jax.grad(lambda a: jnp.maximum(a, 0.0).sum())(jnp.zeros(3))).tolist() \
        == [0.5] * 3


def test_pna_delta_is_float64_as_jax():
    """delta is the float64 mean of log(deg + 1) under the histogram, a
    Python float (an f32 computation gives other bits)."""
    hist = (3, 17, 29, 11, 5, 1)
    delta = tmol.pna_delta(hist)
    degs = np.arange(len(hist))
    assert isinstance(delta, float)
    assert delta == float((np.log(degs + 1) * np.asarray(hist, np.float64)).sum() / sum(hist))
    f32 = (torch.log(torch.arange(len(hist), dtype=torch.float32) + 1)
           * torch.tensor(hist, dtype=torch.float32)).sum() / sum(hist)
    assert float(f32) != delta
    tower = tmol.make_molecule_gnn("pna", **{**MOL_COMMON, "degree_hist": list(hist)})
    assert tower.delta == delta and all(c.delta == delta for c in tower.conv_list)


def test_random_walk_pe_matches_jax(rng):
    """A multi-edge (counted twice), self-loops, masked edges, a graph's
    padding rows and an isolated node: the diagonals of the first 20 powers
    of the row-normalized adjacency."""
    g = _molecule_batch(rng)
    src, dst = np.array(g.edge_src), np.array(g.edge_dst)
    src[0, 1], dst[0, 1] = src[0, 0], dst[0, 0]        # a multi-edge
    src[1, 2] = dst[1, 2]                              # a self-loop
    g = g.replace(edge_src=src, edge_dst=dst)
    want = np.asarray(jmol.random_walk_pe(g, 20))
    got = tmol.random_walk_pe(_torch_graph(g), 20)
    assert got.shape == want.shape == (2, 9, 20) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("base_conv,extra", [
    ("gin", dict(gin_trainable_eps=True)),
    ("gin", dict(gin_trainable_eps=False, aggr="mean")),
    ("attentivefp", dict()),
    ("attentivefp", dict(num_convs=3)),
    ("gps", dict(pe_dim=8)),
    ("pna", dict(degree_hist=HIST, towers=4, out_channels=12, hidden_channels=16)),
])
def test_tower_matches_jax(base_conv, extra):
    """Each new tower at tests/test_model_zoo.py's kwargs, eval mode (GPS's
    batch norm on the init's running statistics)."""
    g = _molecule_batch(np.random.default_rng(0))
    kw = {**MOL_COMMON, **extra}
    jm, tm = jmol.make_molecule_gnn(base_conv, **kw), tmol.make_molecule_gnn(base_conv, **kw)
    variables = jm.init(jax.random.PRNGKey(0), g)
    params = _shift(variables["params"], 0.05)
    writer = StateDictWriter()
    writer.tower("m", params, tm)
    tm.load_state_dict(writer.tensors(strip="m."), strict=True)
    want = np.asarray(jm.apply({**variables, "params": params}, g))
    got = tm.eval()(_torch_graph(g))
    assert got.shape == want.shape and got.shape[-1] == tm.out_dim == kw["out_channels"]
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_make_molecule_gnn_builds_all_seven():
    assert set(tmol.MOLECULE_MODELS) == set(jmol.MOLECULE_MODELS)


def test_gps_model_cannot_train_in_either_package():
    """The JAX Trainer applies GPS's pe_norm in training mode without
    batch_stats among the mutable collections, so its first step raises; the
    port's Trainer refuses the model before any step and names the module."""
    jm, variables, tm, tb, jb = _both_models(ZOO["zoo-lba-gps"])
    jt = JaxTrainer(jm, JaxTrainConfig(device_data_budget=None), jb)
    assert "batch_stats" in jt.extra_vars
    with pytest.raises(Exception, match="batch_stats"):
        jt._train_step(jt.params, jt.opt_state, jb, jt.rng, np.float32(jt.config.lr))
    with pytest.raises(NotImplementedError, match=r"molecule_gnn\.gnn_model\.pe_norm"):
        Trainer(tm, TrainConfig(), device="cpu")
