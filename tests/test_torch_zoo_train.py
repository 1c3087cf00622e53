"""Port parity for training the model zoo: the port's Trainer against the
JAX package's on chip_smoke.py's zoo-cpd-gatv2 and zoo-heat-gine
configurations at small widths (tests/test_torch_zoo_models.py ``ZOO``),
same weights, same batch, dropout 0, on the CPU: 3 f32 Adam steps (losses
1e-5 relative, parameters 1e-5) and one bf16 step (loss 2e-2 relative), as
tests/test_torch_train.py holds the trained configuration; on the JAX side
in bf16 ``segment.USE_PALLAS`` is on, so its backward accumulates in f32 as
the port's kernels do. JAX's Trainer cannot step a model with batch norm,
and the port's refuses it.
"""
import jax
import numpy as np
import pytest
import torch

from caster_dta_tpu.models.joint import make_joint_gnn as jax_make_joint_gnn
from caster_dta_tpu.ops import segment as jseg
from caster_dta_tpu.train.loop import Trainer as JaxTrainer, TrainConfig as JaxTrainConfig
from caster_dta_torch.interop.from_jax import to_jax_params
from caster_dta_torch.models.joint import make_joint_gnn
from caster_dta_torch.train.loop import Trainer, TrainConfig
from tests.test_torch_zoo_models import ZOO, _both_models, _jax_pair, _pair


def _train_both(monkeypatch, kwargs, n_steps, compute):
    """n_steps train steps of both packages from the same weights on the same
    batch -> (jax losses, port losses, jax params, port params)."""
    if compute == "bfloat16":
        monkeypatch.setattr(jseg, "USE_PALLAS", True)
    tb = _pair(kwargs)
    jb = _jax_pair(tb)
    model = make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                           generator=torch.Generator().manual_seed(0), **kwargs["joint_gnn_kwargs"])
    jm = jax_make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                            **kwargs["joint_gnn_kwargs"])
    jt = JaxTrainer(jm, JaxTrainConfig(compute_dtype=compute, device_data_budget=None), jb)
    jt.set_params(to_jax_params(model))
    tt = Trainer(model, TrainConfig(compute_dtype=compute), device="cpu")
    p, o, rng = jt.params, jt.opt_state, jt.rng
    j_losses, t_losses = [], []
    for _ in range(n_steps):
        p, o, loss, _, rng = jt._train_step(p, o, jb, rng, np.float32(jt.config.lr))
        j_losses.append(float(loss))
        t_losses.append(float(tt.train_step(tb)[0]))
    return np.array(j_losses), np.array(t_losses), jax.device_get(p), tt.params_tree()


def _max_leaf_diff(a, b):
    diffs = jax.tree_util.tree_map(lambda x, y: float(np.abs(np.asarray(x) - y).max()), a, b)
    return max(jax.tree_util.tree_leaves(diffs))


@pytest.mark.parametrize("name", ["zoo-cpd-gatv2", "zoo-heat-gine"])
def test_adam_steps_match_jax(monkeypatch, name):
    j_losses, t_losses, jp, tp = _train_both(monkeypatch, ZOO[name], 3, None)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert _max_leaf_diff(jp, tp) < 1e-5
    j_losses, t_losses, _, _ = _train_both(monkeypatch, ZOO[name], 1, "bfloat16")
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-2)


def test_batch_norm_model_cannot_train_in_either_package():
    kwargs = ZOO["zoo-gatv2-gine"]
    kwargs = {**kwargs, "joint_gnn_kwargs": {**kwargs["joint_gnn_kwargs"],
                                             "out_lin_norm_type": "batch"}}
    jm, variables, tm, tb, jb = _both_models(kwargs)
    jt = JaxTrainer(jm, JaxTrainConfig(device_data_budget=None), jb)
    assert "batch_stats" in jt.extra_vars
    with pytest.raises(Exception, match="batch_stats"):
        jt._train_step(jt.params, jt.opt_state, jb, jt.rng, np.float32(jt.config.lr))
    with pytest.raises(NotImplementedError, match="MaskedBatchNorm"):
        Trainer(tm, TrainConfig(), device="cpu")
