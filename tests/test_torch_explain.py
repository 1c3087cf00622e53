"""The port's DTAModelExplainer (caster_dta_torch/inference/explain.py)
against the JAX package's (caster_dta_tpu/inference/explain.py) with the
same weights and batch, on the CPU: both towers, 10 Adam steps, the dense
path and the fused message path (K5, K6), and the blockwise attention path,
where both refuse.

Tolerance: EXPLAIN_TOL = 1e-5 absolute on every mask (f32; the initial
logits are the port's threefry draws, within 4 ulps of jax.random's, and the
steps differ only in sum orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from caster_dta_tpu.inference.explain import DTAModelExplainer as JaxExplainer
from caster_dta_tpu.interop.torch_import import import_joint_gnn
from caster_dta_tpu.models.joint import make_joint_gnn as jax_make_joint_gnn
from caster_dta_tpu.nn import attention as jattn
from caster_dta_tpu.nn import gvp as jgvp
from caster_dta_tpu.ops import pallas_gvp_message as jpm
from caster_dta_torch.data.batching import synthetic_pair_batch
from caster_dta_torch.inference.explain import DTAModelExplainer
from caster_dta_torch.models.joint import make_joint_gnn
from caster_dta_torch.nn import gvp as tgvp
from caster_dta_torch.ops import gvp_message
from tests.test_inference import _small_model_kwargs
from tests.test_torch_gvp_message import KWARGS as FUSED_KWARGS

EXPLAIN_TOL = 1e-5
MASKS = ("protein", "molecule", "protein_edges", "molecule_edges")
# the metadata of the port's synthetic batches (data/batching.synthetic_pair_batch)
METADATA = dict(protein_node_features=[17, 3], protein_edge_features=[32, 1],
                protein_node_types=21, protein_edge_types=1, molecule_node_features=41,
                molecule_edge_features=9, molecule_node_types=11, molecule_edge_types=5)
BATCH = (3, 24, 160, 12, 40)


def _small_kwargs():
    pk, mk, jk = _small_model_kwargs(METADATA)
    return dict(protein_gnn_kwargs=pk, molecule_gnn_kwargs=mk, joint_gnn_kwargs=jk)


def _pair(kwargs, seed=0):
    """The port's model in eval mode and the JAX model with its weights."""
    model = make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                           generator=torch.Generator().manual_seed(seed),
                           **kwargs["joint_gnn_kwargs"]).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    jm = jax_make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                            **kwargs["joint_gnn_kwargs"])
    return model, jm, import_joint_gnn(sd, kwargs)


def _check(got, want):
    assert set(got) == set(want) == set(MASKS)
    for k in MASKS:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=EXPLAIN_TOL, err_msg=k)


def test_dense_masks_match_jax():
    model, jm, variables = _pair(_small_kwargs())
    batch = synthetic_pair_batch(*BATCH, seed=4)
    jb = graft._synthetic_batch(*BATCH, seed=4)
    want = JaxExplainer(jm, n_epochs=10).explain_model(variables, jb.protein, jb.molecule)
    got = DTAModelExplainer(model).explain_model(batch.protein, batch.molecule)
    _check(got, want)
    # the masks moved away from sigmoid(initial logits), and one side alone
    # is that side of "both"
    assert float((got["protein"] - 0.5).abs().max()) > 1e-3
    only = DTAModelExplainer(model).explain_model(batch.protein, batch.molecule,
                                                  side="molecule")
    assert set(only) == {"molecule", "molecule_edges"}
    assert torch.equal(only["molecule"], got["molecule"])
    assert model.training is False


def test_explainer_defaults_are_jaxs():
    import inspect
    mine = inspect.signature(DTAModelExplainer.__init__).parameters
    theirs = inspect.signature(JaxExplainer.__init__).parameters
    assert {k: p.default for k, p in mine.items()} == {k: p.default for k, p in theirs.items()}


def test_fused_masks_match_jax(monkeypatch):
    """A model that meets the fused gate, the switch on in both packages:
    both take the fused branch (recorders on the two fused_message_mlp)."""
    model, jm, variables = _pair(FUSED_KWARGS, seed=3)
    batch = synthetic_pair_batch(*BATCH, seed=5)
    jb = graft._synthetic_batch(*BATCH, seed=5)
    monkeypatch.setattr(jgvp, "USE_FUSED_MESSAGE", True)
    jax_calls, port_calls = [], []
    jreal, treal = jpm.fused_message_mlp, gvp_message.fused_message_mlp
    monkeypatch.setattr(jpm, "fused_message_mlp",
                        lambda *a, **k: jax_calls.append(1) or jreal(*a, **k))
    monkeypatch.setattr(gvp_message, "fused_message_mlp",
                        lambda *a, **k: port_calls.append(1) or treal(*a, **k))
    want = JaxExplainer(jm, n_epochs=10).explain_model(variables, jb.protein, jb.molecule)
    assert jax_calls
    with tgvp.fused_message():
        got = DTAModelExplainer(model).explain_model(batch.protein, batch.molecule)
    n_convs = FUSED_KWARGS["protein_gnn_kwargs"]["num_convs"]
    # per side: the full forward and 10 masked forwards, each through every conv
    assert len(port_calls) == 2 * 11 * n_convs
    _check(got, want)


def test_blockwise_path_refused_as_jax_fails():
    """JAX's gradient through the blockwise attention (masked_mha, forward
    only) fails, so JAX's explainer cannot run on that path; the port's
    refuses it with NotImplementedError before any forward."""
    m = jattn.MultiheadAttention(16, 4, use_pallas=True)
    q, k = jnp.ones((2, 8, 16)), jnp.ones((2, 12, 16))
    pad = jnp.zeros((2, 12), bool).at[:, 10:].set(True)
    v = m.init(jax.random.PRNGKey(0), q, k, k, pad)
    with pytest.raises(Exception, match="differentiate|autodiff|Linearization"):
        jax.grad(lambda x: m.apply(v, x, k, k, pad)[0].sum())(q)

    model, _, _ = _pair(_small_kwargs())
    for mod in model.modules():
        if hasattr(mod, "use_pallas"):
            mod.use_pallas = True
    calls = []
    model.register_forward_hook(lambda *a: calls.append(1))
    batch = synthetic_pair_batch(*BATCH, seed=4)
    with pytest.raises(NotImplementedError, match="use_pallas"):
        DTAModelExplainer(model).explain_model(batch.protein, batch.molecule)
    assert calls == []
