"""Port parity for the segment ops and the norm of the model zoo:
caster_dta_torch's segment_max, segment_softmax, aggregate('max') and
MaskedBatchNorm against caster_dta_tpu's on the same seeded numpy inputs, on
the CPU. Tolerances: 1e-5 in f32 (values and gradients; sums in other
orders); bf16 segment_max values exactly JAX's (a max rounds nothing) and
its gradients within 1e-2 (bf16 sums of the split cotangents)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caster_dta_tpu.nn.norm import MaskedBatchNorm as JaxMaskedBatchNorm
from caster_dta_tpu.ops import segment as jseg
from caster_dta_torch.nn.norm import MaskedBatchNorm
from caster_dta_torch.ops import segment as tseg

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(rng, b=3, n=11, e=40, f=4, ties=False):
    """Edges sorted by dst over the rows below n - 3 (rows n-3..n-2 stay
    empty; the padding edges at n-1 are masked), some real edges masked too;
    with ``ties`` the messages are small integers, so rows hold tied maxima."""
    dst = np.sort(rng.integers(0, n - 3, (b, e)), axis=1)
    dst[:, -6:] = n - 1
    mask = rng.random((b, e)) < 0.85
    mask[:, -6:] = False
    msgs = (rng.integers(-2, 3, (b, e, f)) if ties else rng.normal(size=(b, e, f)))
    return msgs.astype(np.float32), dst.astype(np.int32), mask, n


def _t(x):
    return torch.from_numpy(np.array(x))


def _grads_both(jfn, tfn, msgs, weight, dtype):
    """(JAX value, JAX grad, port value, port grad) of sum(op(msgs) * weight)."""
    jm = jnp.asarray(msgs, dtype)
    j_out = jfn(jm)
    j_grad = jax.grad(lambda m: (jfn(m).astype(jnp.float32) * weight).sum())(jm)
    tm = _t(msgs).to(getattr(torch, jnp.dtype(dtype).name)).requires_grad_()
    t_out = tfn(tm)
    (t_out.float() * _t(weight)).sum().backward()
    return (np.asarray(j_out, np.float32), np.asarray(j_grad, np.float32),
            t_out.detach().float().numpy(), tm.grad.float().numpy())


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("fill", [0.0, -3.5])
def test_segment_max_matches_jax(rng, ties, fill):
    msgs, dst, mask, n = _case(rng, ties=ties)
    weight = rng.normal(size=(3, n, 4)).astype(np.float32)
    jv, jg, tv, tg = _grads_both(
        lambda m: jseg.segment_max(m, dst, mask, n, fill=fill),
        lambda m: tseg.segment_max(m, _t(dst), _t(mask), n, fill=fill), msgs, weight,
        jnp.float32)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    # rows with no real edge get the fill, and masked edges no gradient
    empty = np.ones((3, n), bool)
    for b in range(3):
        empty[b, dst[b][mask[b]]] = False
    assert np.all(tv[empty] == fill) and np.all(tg[~mask] == 0)


def test_segment_max_bf16_matches_jax(rng):
    msgs, dst, mask, n = _case(rng, ties=True)
    weight = rng.normal(size=(3, n, 4)).astype(np.float32)
    jv, jg, tv, tg = _grads_both(
        lambda m: jseg.segment_max(m, dst, mask, n),
        lambda m: tseg.segment_max(m, _t(dst), _t(mask), n), msgs, weight, jnp.bfloat16)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tg, jg, rtol=1e-2, atol=1e-2)


def test_aggregate_max_is_segment_max(rng):
    msgs, dst, mask, n = _case(rng)
    got = tseg.aggregate(_t(msgs), _t(dst), _t(mask), n, "max")
    np.testing.assert_allclose(got.numpy(), np.asarray(jseg.aggregate(msgs, dst, mask, n, "max")),
                               **TOL)
    with pytest.raises(ValueError):
        tseg.aggregate(_t(msgs), _t(dst), _t(mask), n, "min")


@pytest.mark.parametrize("heads", [1, 2])
def test_segment_softmax_matches_jax(rng, heads):
    msgs, dst, mask, n = _case(rng, f=heads)
    msgs = msgs * 4.0
    weight = rng.normal(size=msgs.shape).astype(np.float32)
    jv, jg, tv, tg = _grads_both(
        lambda m: jseg.segment_softmax(m, dst, mask, n),
        lambda m: tseg.segment_softmax(m, _t(dst), _t(mask), n), msgs, weight, jnp.float32)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    assert np.all(tv[~mask] == 0) and np.all(tg[~mask] == 0)
    # the weights of each destination with a real edge sum to 1
    sums = np.zeros((3, n, heads))
    for b in range(3):
        np.add.at(sums[b], dst[b][mask[b]], tv[b][mask[b]])
    real = sums.sum(-1) > 0
    np.testing.assert_allclose(sums[real], 1.0, rtol=1e-5)


@pytest.mark.parametrize("with_mask", [False, True])
def test_masked_batch_norm_train_matches_jax(rng, with_mask):
    """Train mode against JAX's apply(..., mutable=['batch_stats']): outputs,
    gradients and the updated running statistics, over two batches."""
    x1, x2 = (rng.normal(size=(4, 7, 5)).astype(np.float32) * 2 + 1 for _ in range(2))
    mask = rng.random((4, 7)) < 0.6 if with_mask else None
    jm = JaxMaskedBatchNorm(5)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x1), mask=mask,
                        use_running_average=False)
    params = {"scale": rng.normal(size=5).astype(np.float32),
              "bias": rng.normal(size=5).astype(np.float32)}
    tm = MaskedBatchNorm(5)
    tm.load_state_dict({"weight": _t(params["scale"]), "bias": _t(params["bias"])}, strict=True)
    tm.train()
    stats = variables["batch_stats"]
    for x in (x1, x2):
        def apply(xx, stats=stats):
            return jm.apply({"params": params, "batch_stats": stats}, xx, mask=mask,
                            use_running_average=False, mutable=["batch_stats"])

        out, new = apply(jnp.asarray(x))
        want_x = jax.grad(lambda xx: (apply(xx)[0] * np.arange(5)).sum())(jnp.asarray(x))
        stats = new["batch_stats"]
        xt = _t(x).requires_grad_()
        got = tm(xt, None if mask is None else _t(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
        (got * torch.arange(5)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **TOL)
        np.testing.assert_allclose(tm.running_mean.numpy(), np.asarray(stats["mean"]), **TOL)
        np.testing.assert_allclose(tm.running_var.numpy(), np.asarray(stats["var"]), **TOL)
    # eval mode normalizes with the running statistics
    tm.eval()
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x1),
                    use_running_average=True)
    np.testing.assert_allclose(tm(_t(x1)).detach().numpy(), np.asarray(want), **TOL)


def test_masked_batch_norm_init_serves_mean_0_var_1(rng):
    """A fresh module in eval mode serves JAX's init batch_stats, and its
    running statistics stay out of the state dict."""
    x = rng.normal(size=(6, 3)).astype(np.float32)
    jm = JaxMaskedBatchNorm(3)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = MaskedBatchNorm(3).eval()
    assert set(tm.state_dict()) == {"weight", "bias"}
    np.testing.assert_allclose(tm(_t(x)).detach().numpy(),
                               np.asarray(jm.apply(variables, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("name", ["relu", "leaky_relu", "gelu", "sigmoid", "silu", "elu", "tanh"])
def test_activation_gradients_match_jax_at_zero(name):
    """A node with no incoming message and a zero bias sits exactly at 0,
    where jax.nn.leaky_relu's gradient is 1 and torch's own is the slope."""
    from caster_dta_tpu.nn import common as jnn
    from caster_dta_torch.nn import common as tnn

    x = np.array([-2.0, -0.5, 0.0, -0.0, 0.5, 2.0], np.float32)
    want = jax.grad(lambda v: jnn.select_activation(name)(v).sum())(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    tnn.select_activation(name)(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)
