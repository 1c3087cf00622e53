"""Port parity for JointGNN on chip_smoke.py's eight model-zoo configurations
(small widths; tests/test_torch_zoo_models.py ``ZOO``), against
caster_dta_tpu with the same weights (the JAX init) on the same seeded
batch, on the CPU:

* scores within 1e-4, attention maps within 1e-5, also with
  ``out_lin_norm_type='batch'`` (the init's running statistics);
* ``to_jax_params`` after ``load_jax_params`` gives the JAX tree exactly;
* ``load_model_from_checkpoint`` on a run folder that JAX's ``save_params``
  writes serves JAX's answer within 1e-4.
"""
import json

import jax
import numpy as np
import pytest
import torch

from caster_dta_tpu.train import checkpoints as jcheckpoints
from caster_dta_torch.inference.checkpoint import load_model_from_checkpoint
from caster_dta_torch.interop.from_jax import to_jax_params
from tests.test_torch_zoo_models import ZOO, _both_models


@pytest.mark.parametrize("name", list(ZOO) + ["zoo-gatv2-gine batch norm"])
def test_joint_gnn_matches_jax(name):
    kwargs = ZOO[name.replace(" batch norm", "")]
    if name.endswith("batch norm"):
        kwargs = {**kwargs, "joint_gnn_kwargs": {**kwargs["joint_gnn_kwargs"],
                                                 "out_lin_norm_type": "batch"}}
    jm, variables, tm, tb, jb = _both_models(kwargs)
    j_score, j_attn = jm.apply(variables, jb.protein, jb.molecule)
    with torch.no_grad():
        t_score, t_attn = tm(tb.protein, tb.molecule)
    np.testing.assert_allclose(t_score.numpy(), np.asarray(j_score), rtol=0, atol=1e-4)
    for t, j in zip(t_attn[0], j_attn[0]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    # the bridge both ways: the JAX tree back, exactly
    tree = to_jax_params(tm)
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    flat_j = jax.tree_util.tree_leaves_with_path(jax.device_get(variables["params"]))
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    assert all(np.array_equal(a, np.asarray(b)) for (_, a), (_, b) in zip(flat_t, flat_j))


def test_load_model_from_checkpoint_reads_a_jax_zoo_run(tmp_path):
    """A run folder of the zoo-pocketminer-heat configuration with the
    params JAX's save_params writes: the port loads it strictly and serves
    JAX's answer."""
    kwargs = ZOO["zoo-pocketminer-heat"]
    jm, variables, _, tb, jb = _both_models(kwargs)
    with open(tmp_path / "model_kwargs.json", "w") as f:
        json.dump(kwargs, f)
    jcheckpoints.save_params(variables["params"], str(tmp_path / "bestvalmodel_e1.msgpack"))
    model, params, model_kwargs = load_model_from_checkpoint(str(tmp_path), device="cpu")
    assert model_kwargs == json.loads(json.dumps(kwargs)) and not model.training
    with torch.no_grad():
        score, _ = model(tb.protein, tb.molecule)
    j_score, _ = jm.apply(variables, jb.protein, jb.molecule)
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score), rtol=0, atol=1e-4)
