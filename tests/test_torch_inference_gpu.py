"""The inference entry on the card: the served forward and the explainer's
loop as CUDA-graph replays against the same calls run eagerly on the card,
bit for bit, on the dense, fused and blockwise paths, with the launches per
request equal; and run_model_on_dataset's records replayed against eager.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one. No JAX here, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_inference_gpu.py
"""
import os

import numpy as np
import pytest
import torch

from caster_dta_torch.data.batching import synthetic_pair_batch, synthetic_pair_dataset
from caster_dta_torch.inference import serve
from caster_dta_torch.inference.evaluation import run_model_on_dataset
from caster_dta_torch.inference.explain import DTAModelExplainer
from caster_dta_torch.inference.replay import replayed_forward
from caster_dta_torch.nn import gvp
from caster_dta_torch.nn.attention import MultiheadAttention
from caster_dta_torch.ops import cuda_gvp_message as cgm
from caster_dta_torch.ops import cuda_segment as cs
from caster_dta_torch.ops import launches

pytestmark = pytest.mark.gpu

RUN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "runs",
                   "davis_seed9")
BUCKETS = ((4, 64, 512, 48, 256), (2, 128, 1024, 48, 256))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _use_pallas(model, on):
    for m in model.modules():
        if isinstance(m, MultiheadAttention):
            m.use_pallas = on


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return torch.equal(a, b)


@pytest.mark.parametrize("path", ["dense", "fused", "blockwise"])
def test_predict_replays_equal_eager(cuda, path):
    run = serve.load_run(RUN, device="cuda")
    _use_pallas(run.model, path == "blockwise")
    replay = replayed_forward(run.model)
    with gvp.fused_message(path == "fused"):
        for seed, shape in enumerate(BUCKETS * 2):
            batch = synthetic_pair_batch(*shape, seed=seed)
            launches.reset()
            aff_e, attn_e = serve.predict(run, batch, eager=True)
            torch.cuda.synchronize()
            eager = launches.snapshot()
            launches.reset()
            before = replay.replays
            aff, attn = serve.predict(run, batch)
            torch.cuda.synchronize()
            assert launches.snapshot() == eager
            assert replay.replays == before + (seed >= len(BUCKETS))   # the first one captures
            assert torch.equal(aff, aff_e)
            assert all(_same(a, b) for a, b in zip(attn, attn_e))
            assert (attn[0] is None) == (path == "blockwise")
    # an answer already given survives the next replay
    batch = synthetic_pair_batch(*BUCKETS[0], seed=9)
    first, _ = serve.predict(run, batch)
    kept = first.clone()
    serve.predict(run, synthetic_pair_batch(*BUCKETS[0], seed=10))
    assert torch.equal(first, kept)


@pytest.mark.parametrize("fused", [False, True])
def test_explainer_replays_equal_eager(cuda, fused):
    run = serve.load_run(RUN, device="cuda")
    explainer = DTAModelExplainer(run.model)
    with gvp.fused_message(fused):
        for seed in range(3):
            batch = synthetic_pair_batch(*BUCKETS[0], seed=seed).to("cuda")
            launches.reset()
            eager = explainer.explain_model(batch.protein, batch.molecule, eager=True)
            torch.cuda.synchronize()
            eager_launches = launches.snapshot()
            launches.reset()
            got = explainer.explain_model(batch.protein, batch.molecule)
            torch.cuda.synchronize()
            assert launches.snapshot() == eager_launches
            assert eager_launches[cs.K3] > 0 and (eager_launches[cgm.K5B] > 0) == fused
            for k in eager:
                assert torch.equal(got[k], eager[k]), (seed, k)
    assert explainer.replays == 2 * 2


def test_run_model_on_dataset_replays_equal_eager(cuda):
    run = serve.load_run(RUN, device="cuda")
    dataset = synthetic_pair_dataset(20, 4, 4, [(40, 90)], (10, 30), seed=3)
    eager = run_model_on_dataset(run.model, dataset, max_batch_size=4, eager=True)
    for _ in range(2):      # the first captures, the second replays only
        got = run_model_on_dataset(run.model, dataset, max_batch_size=4)
        assert got.keys() == eager.keys()
        for k in got:
            for a, b in zip(got[k], eager[k]):
                assert (np.array_equal(a, b) if hasattr(a, "shape") else a == b), k
    _use_pallas(run.model, True)
    with pytest.raises(NotImplementedError, match="use_pallas"):
        run_model_on_dataset(run.model, dataset, max_batch_size=4)
    blockwise = run_model_on_dataset(run.model, dataset, max_batch_size=4, do_explainer=False)
    assert all(a is None for a in blockwise["prot_mol_attention"])
    assert np.allclose(blockwise["affinity_score"], eager["affinity_score"], rtol=0, atol=1e-4)
