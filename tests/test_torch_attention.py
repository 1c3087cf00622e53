"""Port parity: the blockwise masked attention path (K4) of caster_dta_torch
against caster_dta_tpu on the same numpy inputs.

On the CPU the port's K4 wrapper takes its plain PyTorch version; it is held
here against the JAX package's ``masked_mha`` (its Pallas kernel in interpret
mode, as tests/test_pallas_attention.py runs it), then the port's
``MultiheadAttention(use_pallas=True)`` against JAX's with the same weights,
and the trained runs/davis_seed9 model served with the field on against the
JAX JointGNN (which never sets it: the dense path). The CUDA kernel itself is
held against the plain version on the card (tests/test_torch_kernels.py and
chip_smoke.py).

Tolerances: 2e-5 (rtol/atol) on attention outputs, the JAX tests' own (f32
sums in another order, one exp per key against a blockwise softmax); 1e-4
absolute on the trained model's unscaled affinities (pKd units), as
tests/test_torch_serve.py.
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
from caster_dta_tpu.models.joint import make_joint_gnn as jax_make_joint_gnn
from caster_dta_tpu.nn import attention as jattn
from caster_dta_tpu.ops import pallas_attention
from caster_dta_tpu.train import checkpoints as jax_checkpoints
from caster_dta_torch.data.batching import synthetic_pair_batch
from caster_dta_torch.inference import serve
from caster_dta_torch.interop.from_jax import StateDictWriter
from caster_dta_torch.nn import attention as tattn
from caster_dta_torch.ops import attention as tops
from caster_dta_torch.ops import cuda_attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "runs", "davis_seed9")
TOL = dict(rtol=2e-5, atol=2e-5)

# the five cases of tests/test_pallas_attention.py: (B, H, Lq, Lk, hd, share
# of padding keys); None: no mask, 1.0: every key masked
MHA_CASES = {
    "unmasked 200x300": (2, 4, 200, 300, 16, None),
    "key padding 130x150": (2, 2, 130, 150, 8, 0.4),
    "fully masked": (1, 1, 8, 16, 8, 1.0),
    "long keys 64x700": (1, 2, 64, 700, 16, 0.2),
    "off the blocks 130x33": (1, 2, 130, 33, 16, None),
}


def _inputs(rng, b, h, lq, lk, hd, padding):
    q, k, v = (rng.normal(size=(b, h, n, hd)).astype(np.float32) for n in (lq, lk, lk))
    if padding is None:
        return q, k, v, None
    return q, k, v, rng.random((b, lk)) < padding


def _set_use_pallas(model, on=True):
    for m in model.modules():
        if isinstance(m, tattn.MultiheadAttention):
            m.use_pallas = on


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MHA_CASES))
def test_masked_mha_matches_jax(rng, case, dtype):
    """ops.attention.masked_mha against the JAX masked_mha on the same
    inputs; bf16 inputs are cast to f32 on both sides."""
    q, k, v, pad = _inputs(rng, *MHA_CASES[case])
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = pallas_attention.masked_mha(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                                       None if pad is None else jnp.asarray(pad))
    got = tops.masked_mha(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                          None if pad is None else torch.from_numpy(pad))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case == "fully masked":
        # uniform weights over every key: the mean of v
        mean = torch.from_numpy(v).to(tdt).float().mean(dim=2, keepdim=True)
        np.testing.assert_allclose(got.numpy(), mean.expand_as(got).numpy(), **TOL)


def _mha_pair(rng, e, h, kdim, **port_kwargs):
    """The JAX module's init with nonzero biases, carried into the port's."""
    b, lq, lk = 2, 70, 40
    q = rng.normal(size=(b, lq, e)).astype(np.float32)
    kv = rng.normal(size=(b, lk, kdim)).astype(np.float32)
    pad = rng.random((b, lk)) < 0.3
    pad[1, :] = True                       # a fully masked row
    j_args = (jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    params = jattn.MultiheadAttention(e, h).init(jax.random.PRNGKey(0), *j_args,
                                                 key_padding_mask=jnp.asarray(pad))["params"]
    params = jax.tree_util.tree_map(lambda a: a + 0.01, params)
    tm = tattn.MultiheadAttention(e, h, kdim=kdim, vdim=kdim, **port_kwargs)
    sd = StateDictWriter()
    sd.mha("m", params, tm.packed)
    tm.load_state_dict(sd.tensors(strip="m."), strict=True)
    t_args = (torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv))
    return params, j_args, t_args, pad, tm.eval()


@pytest.mark.parametrize("kdim", [32, 24], ids=["packed", "kdim"])
def test_mha_module_use_pallas_matches_jax(rng, kdim):
    """MultiheadAttention(use_pallas=True) against JAX's with the same
    weights; the weights come out None on both sides."""
    e, h = 32, 4
    params, j_args, t_args, pad, tm = _mha_pair(rng, e, h, kdim, use_pallas=True)
    want, w_want = jattn.MultiheadAttention(e, h, use_pallas=True).apply(
        {"params": params}, *j_args, key_padding_mask=jnp.asarray(pad))
    with torch.no_grad():
        got, w_got = tm(*t_args, key_padding_mask=torch.from_numpy(pad))
    assert w_want is None and w_got is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the same module on the dense path gives the same output, and weights
    tm.use_pallas = False
    with torch.no_grad():
        dense, w_dense = tm(*t_args, key_padding_mask=torch.from_numpy(pad))
    assert w_dense is not None
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)


def test_use_pallas_gate_follows_jax(rng):
    """The JAX condition: use_pallas and (dropout == 0 or deterministic).
    With dropout on, training mode takes the dense path (weights come out),
    eval mode the blockwise one."""
    _, _, t_args, pad, tm = _mha_pair(rng, 32, 4, 32, use_pallas=True, dropout=0.1)
    mask = torch.from_numpy(pad)
    tm.train()
    with torch.no_grad():
        _, w_train = tm(*t_args, key_padding_mask=mask, generator=torch.Generator().manual_seed(0))
    tm.eval()
    with torch.no_grad():
        _, w_eval = tm(*t_args, key_padding_mask=mask)
    assert w_train is not None and w_eval is None


def test_masked_mha_is_forward_only(rng):
    """Under autograd the blockwise path raises instead of returning an
    output that no gradient flows through; under no_grad it runs."""
    q, k, v, pad = (torch.from_numpy(x) for x in _inputs(rng, 1, 2, 9, 7, 16, 0.3))
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        tops.masked_mha(q, k, v, pad)
    with torch.no_grad():
        assert tops.masked_mha(q, k, v, pad).shape == (1, 2, 9, 16)
    _, _, t_args, mask, tm = _mha_pair(rng, 32, 4, 32, use_pallas=True)
    tm.train()                              # dropout 0: the blockwise branch, also training
    with pytest.raises(RuntimeError, match="forward only"):
        tm(*t_args, key_padding_mask=torch.from_numpy(mask))


def test_k4_refuses_other_devices_and_counts_nothing_on_cpu(rng):
    cuda_attention.reset_launches()
    q, k, v, pad = (torch.from_numpy(x) for x in _inputs(rng, 2, 2, 5, 6, 8, 0.5))
    cuda_attention.masked_mha(q, k, v, pad)
    assert cuda_attention.LAUNCHES == {cuda_attention.K4: 0}
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_attention.masked_mha(*meta)


def test_trained_run_served_with_use_pallas_matches_jax():
    """runs/davis_seed9 served with use_pallas on both MultiheadAttention
    modules against the JAX JointGNN (dense; it cannot set the field), and
    against the port's dense answer. The attention comes back (None, None)."""
    with open(os.path.join(RUN, "model_kwargs.json")) as f:
        kwargs = json.load(f)
    model = jax_make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                               **kwargs["joint_gnn_kwargs"])
    # the JAX package's checkpoint loader, with a template from eval_shape
    # in place of its eager init
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0), *template_batch(kwargs))
    variables = {"params": jax_checkpoints.load_params(
        template["params"], jax_checkpoints.get_best_model(RUN, "val"))}
    jb = graft._synthetic_batch(3, 48, 384, 24, 96, seed=12)
    score, _ = jax.jit(lambda v, p, m: model.apply(v, p, m, deterministic=True))(
        variables, jb.protein, jb.molecule)
    with open(os.path.join(RUN, "dataset_rescale_params.json")) as f:
        std = json.load(f)["standardize"]
    want = np.asarray(score)[:, 0] * std["scale_std_factor"] + std["scale_mean_factor"]

    run = serve.load_run(RUN, device="cpu")
    batch = synthetic_pair_batch(3, 48, 384, 24, 96, seed=12)
    dense, _ = serve.predict(run, batch)
    _set_use_pallas(run.model)
    aff, attn = serve.predict(run, batch)
    assert attn == (None, None)
    np.testing.assert_allclose(aff.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(aff.numpy(), dense.numpy(), rtol=0, atol=1e-4)
