"""Port parity for training the rest of the molecule zoo: the port's Trainer
against the JAX package's on chip_smoke.py's zoo-lba-gin, zoo-lba-attentivefp
and zoo-lba-pna configurations at small widths (tests/test_torch_zoo_models.py
``ZOO``), same weights, same batch, dropout 0, on the CPU: 3 f32 Adam steps
(losses 1e-5 relative, parameters 1e-5) and 3 bf16 steps (losses 2e-2
relative), with tests/test_torch_zoo_train.py's helper (in bf16 the JAX
side's ``segment.USE_PALLAS`` is on, so its backward accumulates in f32 as
the port's kernels do). zoo-lba-gps cannot train in either package
(tests/test_torch_zoo_molecule.py).
"""
import numpy as np
import pytest

from tests.test_torch_zoo_models import ZOO
from tests.test_torch_zoo_train import _max_leaf_diff, _train_both


@pytest.mark.parametrize("name", ["zoo-lba-gin", "zoo-lba-attentivefp", "zoo-lba-pna"])
def test_adam_steps_match_jax(monkeypatch, name):
    j_losses, t_losses, jp, tp = _train_both(monkeypatch, ZOO[name], 3, None)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert _max_leaf_diff(jp, tp) < 1e-5
    j_losses, t_losses, _, _ = _train_both(monkeypatch, ZOO[name], 3, "bfloat16")
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-2)
