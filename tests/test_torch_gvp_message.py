"""Port parity for the fused GVP message path: caster_dta_torch's
``fused_message_mlp`` (K5) and ``layout_pin`` (K6), the fused GVPConv, the
trained model served with the switch on and 3 Adam steps with it on, against
caster_dta_tpu's fused path on the same seeded numpy inputs and the same
weights, on the CPU. On the JAX side ``caster_dta_tpu.nn.gvp.USE_FUSED_MESSAGE``
is monkeypatched on, so its Pallas kernels run in interpret mode, as
tests/test_pallas_gvp_message.py runs them. JAX reads the switch at trace
time, so it is set before the function under test is first traced, and a
recorder shows that the trace went through the fused kernel. The JAX side's
model initializations (the checkpoint's template, the Trainer's parameters)
run with the switch off or only as a shape: the fused path reads the same
parameter tree, and an initialization compiled or run eagerly here costs
12-25 s each. On
the port's side the switch is the scoped ``caster_dta_torch.nn.gvp.
fused_message`` and the CPU runs the kernels' plain versions.

Tolerances, each with its reason:
- f32 outputs and input gradients: 1e-5 (rtol and atol). The same math; the
  JAX kernel sums the kron-expanded products in another order.
- f32 weight gradients: 2e-4 (rtol and atol), as the JAX package's own
  fused-vs-module test (tests/test_pallas_gvp_message.py): sums over every
  edge, in another order.
- bf16 (a bf16 compute dtype or a bf16 tensor): 2e-2 of each tensor's
  largest entry. A sum that lands on the other side of a bf16 rounding
  boundary moves by one bf16 ulp, and later layers carry it on.
- The served trained model: 1e-4 pKd and 1e-5 on attention, as
  tests/test_torch_serve.py. Adam steps: f32 losses 1e-5 relative and
  parameters 1e-5, bf16 losses 2e-2 relative, as tests/test_torch_train.py.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from caster_dta_tpu.inference.checkpoint import template_batch
from caster_dta_tpu.interop.torch_import import _Mapper, import_joint_gnn
from caster_dta_tpu.models.joint import make_joint_gnn as jax_make_joint_gnn
from caster_dta_tpu.nn import common as jnn
from caster_dta_tpu.nn import gvp as jgvp
from caster_dta_tpu.ops import pallas_gvp_message as jpm
from caster_dta_tpu.ops import segment as jseg
from caster_dta_tpu.train import checkpoints as jax_checkpoints
from caster_dta_tpu.train.loop import Trainer as JaxTrainer, TrainConfig as JaxTrainConfig
from caster_dta_torch.data import batching
from caster_dta_torch.inference import serve
from caster_dta_torch.models.joint import make_joint_gnn
from caster_dta_torch.nn import gvp as tgvp
from caster_dta_torch.nn.common import compute_dtype
from caster_dta_torch.ops import gvp_message
from caster_dta_torch.train import checkpoints
from caster_dta_torch.train.loop import Trainer, TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "runs", "davis_seed9")
F32_TOL = 1e-5
WEIGHT_TOL = 2e-4
BF16_TOL = 2e-2
BF16_LOSS_RTOL = 2e-2
NS, NV, SE, VE = 16, 4, 32, 1       # the trained protein tower's conv widths

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


@pytest.fixture
def fused(monkeypatch):
    """The switch on in both packages for the test."""
    monkeypatch.setattr(jgvp, "USE_FUSED_MESSAGE", True)
    with tgvp.fused_message():
        yield


def _jax_fused(monkeypatch) -> list:
    """Turn the JAX switch on; the returned list gets one entry each time a
    trace calls the JAX fused_message_mlp."""
    monkeypatch.setattr(jgvp, "USE_FUSED_MESSAGE", True)
    calls = []
    real = jpm.fused_message_mlp
    monkeypatch.setattr(jpm, "fused_message_mlp",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, bf16=False, weight=False, what=""):
    """got (torch), want (jax or numpy) under the tolerance of the module
    docstring."""
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if bf16:
        scale = float(np.abs(want).max()) if want.size else 0.0
        err = float(np.abs(got - want).max()) if want.size else 0.0
        assert err <= BF16_TOL * scale, f"{what}: max|d| {err:.3e} > {BF16_TOL} x {scale:.3e}"
    else:
        tol = WEIGHT_TOL if weight else F32_TOL
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _flax_layers(sd: dict, n_layers: int, prefix: str) -> list:
    """The port's state-dict entries of message layers -> the flax GVP param
    subtrees, through the JAX package's own importer (import_joint_gnn's
    mapper)."""
    mapper = _Mapper(sd)
    return [mapper.gvp(f"{prefix}{k}") for k in range(n_layers)]


def _message_case(rng, b, e, n_layers, acts):
    conv = tgvp.GVPConv((NS, NV), (NS, NV), (SE, VE), n_layers=n_layers, activations=acts,
                        vector_gate=True, generator=torch.Generator().manual_seed(n_layers))
    inputs = dict(both=rng.normal(size=(b, 2 * e, NS + 3 * NV)),
                  es=rng.normal(size=(b, e, SE)), ev=rng.normal(size=(b, e, VE, 3)),
                  dout=rng.normal(size=(b, e, NS + 3 * NV)))
    return conv.message_func, {k: v.astype(np.float32) for k, v in inputs.items()}


_DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("n_layers,acts,dtypes,cdt", [
    (1, ("relu", None), ("f32", "f32", "f32"), None),
    (2, ("sigmoid", "sigmoid"), ("f32", "f32", "f32"), None),
    (3, ("relu", None), ("f32", "f32", "f32"), "bf16"),
    (3, ("relu", "sigmoid"), ("f32", "f32", "bf16"), "bf16"),   # what the bf16 model feeds
    (2, ("relu", None), ("bf16", "bf16", "bf16"), None),        # computes in both's bf16
])
def test_fused_message_mlp_matches_jax(rng, n_layers, acts, dtypes, cdt):
    """(a) K5's plain forward and backward against the JAX fused_message_mlp
    and its VJP, weight gradients mapped to the flax names."""
    layers, x = _message_case(rng, 2, 64, n_layers, acts)
    dt = [_DT[d] for d in dtypes]
    t_in = [torch.from_numpy(x[k]).to(d[0]).requires_grad_()
            for k, d in zip(("both", "es", "ev"), dt)]
    j_in = [jnp.asarray(x[k]).astype(d[1]) for k, d in zip(("both", "es", "ev"), dt)]
    t_dout = torch.from_numpy(x["dout"]).to(dt[0][0])
    j_dout = jnp.asarray(x["dout"]).astype(dt[0][1])
    sd = {f"m.{k}": v.detach().numpy() for k, v in layers.state_dict().items()}
    j_params = _flax_layers(sd, n_layers, "m.")

    def jax_fn(both, es, ev, params):
        return jpm.fused_message_mlp(both, es, ev, params, NS, NV, (NV, VE, NV), acts,
                                     compute_dtype=None if cdt is None else jnp.bfloat16)

    j_out, vjp = jax.vjp(jax_fn, *j_in, j_params)
    j_grads = vjp(j_dout)
    with compute_dtype(None if cdt is None else torch.bfloat16):
        t_out = gvp_message.fused_message_mlp(*t_in, layers, NS, NV, acts)
    params = dict(layers.named_parameters())
    t_grads = torch.autograd.grad(t_out, t_in + list(params.values()), t_dout)
    bf16 = cdt == "bf16" or "bf16" in dtypes
    assert t_out.dtype == t_in[0].dtype
    _close(t_out, j_out, bf16, what="out")
    for what, got, want, x_in in zip(("d both", "d es", "d ev"), t_grads[:3], j_grads[:3], t_in):
        assert got.dtype == x_in.dtype
        _close(got, want, bf16, what=what)
    g_sd = {f"m.{k}": g.numpy() for k, g in zip(params, t_grads[3:])}
    for k, (got_layer, want_layer) in enumerate(zip(_flax_layers(g_sd, n_layers, "m."),
                                                    j_grads[3])):
        for name in ("wh", "ws", "wv", "wsv"):
            for leaf in want_layer[name]:
                _close(torch.from_numpy(got_layer[name][leaf]), want_layer[name][leaf], bf16,
                       weight=True, what=f"message_{k}/{name}/{leaf}")


@pytest.mark.parametrize("src,dst", [("f32", None), ("f32", "bf16"), ("bf16", "f32")])
def test_layout_pin_matches_jax(rng, src, dst):
    """(a) K6's plain version and its VJP against the JAX layout_pin."""
    x = rng.normal(size=(3, 8, 28)).astype(np.float32)
    g = rng.normal(size=(3, 8, 28)).astype(np.float32)
    t_dst = None if dst is None else _DT[dst][0]
    j_dst = None if dst is None else _DT[dst][1]
    tx = torch.from_numpy(x).to(_DT[src][0]).requires_grad_()
    jx = jnp.asarray(x).astype(_DT[src][1])
    j_out, vjp = jax.vjp(lambda a: jpm.layout_pin(a, j_dst), jx)
    t_out = gvp_message.layout_pin(tx, t_dst)
    assert t_out.dtype == (t_dst or tx.dtype) and t_out.data_ptr() != tx.data_ptr()
    np.testing.assert_array_equal(_np(t_out), np.asarray(j_out, np.float32))
    t_g = torch.from_numpy(g).to(t_out.dtype)
    (got,) = torch.autograd.grad(t_out, tx, t_g)
    (want,) = vjp(jnp.asarray(g).astype(j_out.dtype))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def _conv_graph(rng, b=2, n=16, e=64):
    return dict(s=rng.normal(size=(b, n, NS)).astype(np.float32),
                v=rng.normal(size=(b, n, NV, 3)).astype(np.float32),
                src=rng.integers(0, n, (b, e)).astype(np.int32),
                dst=np.sort(rng.integers(0, n, (b, e)), axis=1).astype(np.int32),
                mask=rng.random((b, e)) < 0.8,
                es=rng.normal(size=(b, e, SE)).astype(np.float32),
                ev=rng.normal(size=(b, e, VE, 3)).astype(np.float32))


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_conv_matches_jax(rng, fused, bf16):
    """(b) The port's fused GVPConv against the JAX fused GVPConv: outputs
    and every parameter's gradient (f32; and under the bf16 policy with the
    dtypes the bf16 model feeds the conv: s and es f32, v and ev bf16)."""
    g = _conv_graph(rng)
    conv = tgvp.GVPConv((NS, NV), (NS, NV), (SE, VE), n_layers=3, aggr="sum",
                        activations=("relu", None), vector_gate=True,
                        generator=torch.Generator().manual_seed(5))
    sd = {k: v.detach().numpy() for k, v in conv.state_dict().items()}
    j_params = {f"message_{k}": p
                for k, p in enumerate(_flax_layers(sd, 3, "message_func."))}
    jconv = jgvp.GVPConv((NS, NV), n_layers=3, aggr="sum", activations=("relu", None),
                         vector_gate=True)
    vdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    jx = (jnp.asarray(g["s"]), jnp.asarray(g["v"]).astype(vdt[1]))
    j_edges = tuple(jnp.asarray(g[k]) for k in ("src", "dst", "mask"))
    j_eattr = (jnp.asarray(g["es"]), jnp.asarray(g["ev"]).astype(vdt[1]))

    def jax_loss(params):
        os_, ov = jconv.apply({"params": params}, jx, *j_edges, j_eattr)
        return jnp.sum(jnp.sin(os_.astype(jnp.float32))) + jnp.sum(
            jnp.cos(ov.astype(jnp.float32))), (os_, ov)

    jnn.set_compute_dtype(jnp.bfloat16 if bf16 else None)
    try:
        (_, (j_s, j_v)), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(j_params)
    finally:
        jnn.set_compute_dtype(None)
    tx = (torch.from_numpy(g["s"]), torch.from_numpy(g["v"]).to(vdt[0]))
    t_edges = tuple(torch.from_numpy(g[k]) for k in ("src", "dst", "mask"))
    t_eattr = (torch.from_numpy(g["es"]), torch.from_numpy(g["ev"]).to(vdt[0]))
    assert conv.fused_ok(tx, t_edges[0], t_eattr)
    with compute_dtype(torch.bfloat16 if bf16 else None):
        t_s, t_v = conv(tx, *t_edges, t_eattr)
    loss = torch.sin(t_s.float()).sum() + torch.cos(t_v.float()).sum()
    params = dict(conv.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert str(t_s.dtype)[6:] == str(j_s.dtype) and str(t_v.dtype)[6:] == str(j_v.dtype)
    _close(t_s, j_s, bf16, what="s")
    _close(t_v, j_v, bf16, what="v")
    g_sd = {k: gr.numpy() for k, gr in zip(params, grads)}
    for k, got_layer in enumerate(_flax_layers(g_sd, 3, "message_func.")):
        want_layer = j_grads[f"message_{k}"]
        for name in ("wh", "ws", "wv", "wsv"):
            for leaf in want_layer[name]:
                _close(torch.from_numpy(got_layer[name][leaf]), want_layer[name][leaf], bf16,
                       weight=True, what=f"message_{k}/{name}/{leaf}")


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return torch.from_numpy(q.astype(np.float32))


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_fused_conv_matches_the_unfused_conv_and_is_equivariant(rng, aggr):
    """(c) The port's fused conv against its own unfused conv in f32
    (outputs, input and parameter gradients), and SO(3) equivariance of the
    fused conv: rotating every input vector rotates the output vectors."""
    g = _conv_graph(rng)
    conv = tgvp.GVPConv((NS, NV), (NS, NV), (SE, VE), n_layers=3, aggr=aggr,
                        activations=("relu", None), vector_gate=True,
                        generator=torch.Generator().manual_seed(6))
    edges = tuple(torch.from_numpy(g[k]) for k in ("src", "dst", "mask"))

    def run(switch, rot=None):
        x = [torch.from_numpy(g[k]).clone().requires_grad_() for k in ("s", "v", "es", "ev")]
        v, ev = (x[1], x[3]) if rot is None else (x[1] @ rot, x[3] @ rot)
        with tgvp.fused_message(switch):
            s_out, v_out = conv((x[0], v), *edges, (x[2], ev))
        loss = torch.sin(s_out).sum() + torch.cos(v_out).sum()
        return s_out, v_out, torch.autograd.grad(loss, x + list(conv.parameters()))

    s0, v0, g0 = run(False)
    s1, v1, g1 = run(True)
    _close(s1, s0.detach().numpy(), what="s")
    _close(v1, v0.detach().numpy(), what="v")
    for i, (a, b) in enumerate(zip(g1, g0)):
        _close(a, b.numpy(), weight=i >= 4, what=f"gradient {i}")
    rot = _rotation(rng)
    s2, v2, _ = run(True, rot)
    torch.testing.assert_close(s2, s1, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v2, v1 @ rot, rtol=1e-4, atol=1e-5)


def test_trained_run_served_fused_matches_jax(monkeypatch):
    """(d) runs/davis_seed9 served with the switch on: the port on the CPU
    against the JAX JointGNN with the switch on, and against the port's
    unfused answer."""
    # the JAX package's checkpoint loader, with a template from eval_shape
    # in place of its eager init
    with open(os.path.join(RUN, "model_kwargs.json")) as f:
        kwargs = json.load(f)
    model = jax_make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                               **kwargs["joint_gnn_kwargs"])
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0), *template_batch(kwargs))
    variables = {"params": jax_checkpoints.load_params(
        template["params"], jax_checkpoints.get_best_model(RUN, "val"))}
    calls = _jax_fused(monkeypatch)
    jb = graft._synthetic_batch(3, 48, 384, 24, 96, seed=11)
    score, attn = jax.jit(lambda v, p, m: model.apply(v, p, m, deterministic=True))(
        variables, jb.protein, jb.molecule)
    assert len(calls) == kwargs["protein_gnn_kwargs"]["num_convs"]    # one per GVP conv
    with open(os.path.join(RUN, "dataset_rescale_params.json")) as f:
        std = json.load(f)["standardize"]
    want = np.asarray(score)[:, 0] * std["scale_std_factor"] + std["scale_mean_factor"]
    run = serve.load_run(RUN, device="cpu")
    convs = run.model.protein_gnn.gnn_model.conv_list
    batch = batching.synthetic_pair_batch(3, 48, 384, 24, 96, seed=11)
    g = batch.protein
    x = (torch.zeros(3, g.n_pad, NS), torch.zeros(3, g.n_pad, NV, 3))
    with tgvp.fused_message():
        assert all(c.conv.fused_ok(x, g.edge_src, (g.edge_s, g.edge_v)) for c in convs)
        aff, (w_rd, w_da) = serve.predict(run, batch)
    np.testing.assert_allclose(aff.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(w_rd.numpy(), np.asarray(attn[0][0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w_da.numpy(), np.asarray(attn[0][1]), rtol=1e-5, atol=1e-5)
    unfused, _ = serve.predict(run, batch)
    np.testing.assert_allclose(aff.numpy(), unfused.numpy(), rtol=0, atol=1e-4)


def _port_model(seed=0):
    return make_joint_gnn(KWARGS["protein_gnn_kwargs"], KWARGS["molecule_gnn_kwargs"],
                          generator=torch.Generator().manual_seed(seed),
                          **KWARGS["joint_gnn_kwargs"])


@pytest.fixture(scope="module")
def jax_trainer():
    """One JAX Trainer, holding _port_model()'s weights, for both dtypes of
    the Adam-step case: its constructor's jitted model.init is built once,
    with the switch off. Each case traces a step of its own."""
    jb = graft._synthetic_batch(*BUCKET, seed=1)
    jm = jax_make_joint_gnn(KWARGS["protein_gnn_kwargs"], KWARGS["molecule_gnn_kwargs"],
                            **KWARGS["joint_gnn_kwargs"])
    jt = JaxTrainer(jm, JaxTrainConfig(device_data_budget=None), jb)
    sd = {k: v.detach().numpy() for k, v in _port_model().state_dict().items()}
    jt.set_params(import_joint_gnn(sd, KWARGS)["params"])
    return jt, jb


@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_adam_steps_fused_match_jax(monkeypatch, jax_trainer, compute):
    """(e) 3 Adam steps with the switch on: the port's Trainer against the
    JAX Trainer from the same weights on the same batch. In bf16 the JAX
    side's segment ops run their Pallas VJPs (f32 accumulation), as the
    port's kernels accumulate in f32."""
    if compute == "bfloat16":
        monkeypatch.setattr(jseg, "USE_PALLAS", True)
    jt, jb = jax_trainer
    # the trace-time policy a JAX Trainer of this compute dtype sets (the
    # conftest resets it after the test), then a step traced afresh under it
    # and under the switch; the step donates its carry, so it gets copies
    jnn.set_compute_dtype(jnp.bfloat16 if compute == "bfloat16" else None)
    calls = _jax_fused(monkeypatch)
    step = jt._build_train_step()
    tb = batching.synthetic_pair_batch(*BUCKET, seed=1)
    tt = Trainer(_port_model(), TrainConfig(compute_dtype=compute), device="cpu")
    p, o = jax.tree_util.tree_map(jnp.array, (jt.params, jt.opt_state))
    key = jax.random.clone(jt.rng)
    j_losses, t_losses = [], []
    for _ in range(3):
        p, o, loss, _, key = step(p, o, jb, key, np.float32(jt.config.lr))
        j_losses.append(float(loss))
        with tgvp.fused_message():
            t_losses.append(float(tt.train_step(tb)[0]))
    assert len(calls) == KWARGS["protein_gnn_kwargs"]["num_convs"]    # one trace, fused
    if compute is None:
        np.testing.assert_allclose(t_losses, j_losses, rtol=F32_TOL)
        diffs = jax.tree_util.tree_map(lambda a, b: float(np.abs(np.asarray(a) - b).max()),
                                       jax.device_get(p), tt.params_tree())
        assert max(jax.tree_util.tree_leaves(diffs)) <= F32_TOL
    else:
        np.testing.assert_allclose(t_losses, j_losses, rtol=BF16_LOSS_RTOL)
    assert t_losses[-1] < t_losses[0]


def test_checkpoints_cross_between_the_paths(tmp_path, fused):
    """A checkpoint written after a fused training step loads into a model
    that serves unfused (the parameter names are the same), and the two
    paths give the same answer on it."""
    trainer = Trainer(_port_model(), TrainConfig(), device="cpu")
    tb = batching.synthetic_pair_batch(*BUCKET, seed=2)
    trainer.train_step(tb)
    path = os.path.join(tmp_path, "bestvalmodel_x.msgpack")
    checkpoints.save_params(trainer.params_tree(), path)
    trainer.model.eval()
    fused_pred = trainer.eval_step(tb)
    other = Trainer(_port_model(seed=1), TrainConfig(), device="cpu")
    other.set_params(checkpoints.load_params(path))
    with tgvp.fused_message(False):
        unfused_pred = other.eval_step(tb)
    np.testing.assert_allclose(_np(unfused_pred), _np(fused_pred), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["fused", "bytes at the bound", "bytes over the bound",
                                  "no vector gate", "leaky_relu", "no edge vectors",
                                  "switch None", "switch False"])
def test_gate_falls_back_where_jax_does(rng, monkeypatch, case):
    """(f) The port's gate admits exactly what the JAX gate admits. The JAX
    side's decision is read from its trace (jax.eval_shape), with
    fused_message_mlp replaced by a recorder."""
    switch = {"switch None": None, "switch False": False}.get(case, True)
    e = {"bytes at the bound": 17857, "bytes over the bound": 17858}.get(case, 32)
    ve = 0 if case == "no edge vectors" else VE
    gate = case != "no vector gate"
    acts = ("leaky_relu", None) if case == "leaky_relu" else ("relu", None)
    b, n = 1, 8
    s = rng.normal(size=(b, n, NS)).astype(np.float32)
    v = rng.normal(size=(b, n, NV, 3)).astype(np.float32)
    src = np.zeros((b, e), np.int32)
    mask = np.ones((b, e), bool)
    es = np.zeros((b, e, SE), np.float32)
    ev = np.zeros((b, e, ve, 3), np.float32)
    monkeypatch.setattr(jgvp, "USE_FUSED_MESSAGE", switch)
    calls = []
    real = jpm.fused_message_mlp
    monkeypatch.setattr(jpm, "fused_message_mlp",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jconv = jgvp.GVPConv((NS, NV), n_layers=3, aggr="sum", activations=acts,
                         vector_gate=gate)
    j_args = ((jnp.asarray(s), jnp.asarray(v)), jnp.asarray(src), jnp.asarray(src),
              jnp.asarray(mask), (jnp.asarray(es), jnp.asarray(ev)))
    variables = jax.eval_shape(jconv.init, jax.random.PRNGKey(0), *j_args)
    jax.eval_shape(jconv.apply, variables, *j_args)
    conv = tgvp.GVPConv((NS, NV), (NS, NV), (SE, ve), n_layers=3, aggr="sum", activations=acts,
                        vector_gate=gate)
    with tgvp.fused_message(bool(switch)):
        port = conv.fused_ok((torch.from_numpy(s), torch.from_numpy(v)), torch.from_numpy(src),
                             (torch.from_numpy(es), torch.from_numpy(ev)))
    assert port == bool(calls)
    assert port == (case in ("fused", "bytes at the bound"))
