"""The downstream analyses on the card: BioLIP and variation with
runs/davis_seed9's weights on chip_smoke.analysis_inputs' helices (test
size), their records on the card against the same analyses on the CPU
(chip_smoke.ANALYSIS_RECORD_ATOL: affinity 1e-4 pKd, attention 1e-5, node
explanations 2e-4, edge explanations wider; the CPU answer taken by
chip_smoke.cpu_reference, once two runs agree; the three runs' records kept
in ``$CHIP_SMOKE_OUT`` where the check fails), and the replayed run (CUDA
graphs, the default) against an eager run on the card bit for bit, with
equal launches. As chip_smoke.py does, the module drops the variables that
let cuBLAS (TF32) or oneDNN (BF16) round f32 matmul inputs before any
matmul, and the tests turn TF32 off.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one. No JAX here:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_analysis_gpu.py
"""
import functools
import os
import sys

for _v in ("TORCH_ALLOW_TF32_CUBLAS_OVERRIDE", "ONEDNN_DEFAULT_FPMATH_MODE",
           "DNNL_DEFAULT_FPMATH_MODE"):
    os.environ.pop(_v, None)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from caster_dta_torch.analysis import biolip, variation  # noqa: E402
from caster_dta_torch.inference import evaluation  # noqa: E402
from caster_dta_torch.ops import cuda_segment as cs  # noqa: E402
from caster_dta_torch.ops import launches  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return chip_smoke.analysis_inputs(str(tmp_path_factory.mktemp("inputs")),
                                      biolip_proteins=8, variant_pairs=2, variant_drugs=2,
                                      residues=(60, 200))


def _runs(fn, tmp, monkeypatch, **kw):
    """The analysis on the card replayed, on the card eagerly (its module's
    run_model_on_dataset called with ``eager=True``) and on the CPU;
    -> ({device: output}, {device: launches})."""
    out, counts = {}, {}
    module = sys.modules[fn.__module__]
    for tag, eager in (("replayed", False), ("eager", True)):
        monkeypatch.setattr(module, "run_model_on_dataset",
                            functools.partial(evaluation.run_model_on_dataset, eager=eager))
        launches.reset()
        out[tag] = fn(chip_smoke.RUN_DIR, results_dir=os.path.join(tmp, tag), device="cuda",
                      **kw)
        counts[tag] = launches.snapshot()
    monkeypatch.undo()
    out["cpu"] = chip_smoke.cpu_reference(torch, lambda: fn(
        chip_smoke.RUN_DIR, results_dir=os.path.join(tmp, "cpu"), device="cpu", **kw),
        f"{fn.__name__} on the CPU")
    return out, counts


def _kept(task, out):
    """Writes the three runs' records to ``$CHIP_SMOKE_OUT`` (as
    chip_smoke.cpu_reference keeps differing CPU answers), so a failed check
    shows which side moved; -> the file's path."""
    out_dir = os.environ.get("CHIP_SMOKE_OUT", os.path.join(chip_smoke.HERE, "chip_smoke_out"))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"analysis_gpu_{task}.pt")
    torch.save({k: _first(v) for k, v in out.items()}, path)
    return path


def _first(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("task", ["biolip", "variation"])
def test_analysis_on_the_card(cuda, inputs, tmp_path, monkeypatch, task):
    fn = {"biolip": biolip.run_biolip_binding, "variation": variation.run_dta_variation}[task]
    out, counts = _runs(fn, str(tmp_path), monkeypatch, **inputs[task])
    card, eager, cpu = (_first(out[k]) for k in ("replayed", "eager", "cpu"))
    assert chip_smoke.records_equal(card, eager), "replayed records are not the eager ones"
    assert counts["replayed"] == counts["eager"]
    assert all(counts["replayed"][k] > 0 for k in (cs.K1, cs.K2, cs.K3))
    assert card["pair_idx"] == cpu["pair_idx"] and card["protein_id"] == cpu["protein_id"]
    try:
        chip_smoke.check_records(f"{task} card", card, cpu, "every pair",
                                 chip_smoke.ANALYSIS_RECORD_ATOL)
    except AssertionError as e:
        raise AssertionError(f"{e}; the records are in {_kept(task, out)}") from e
    if task == "variation":
        d_card, d_cpu = out["replayed"][1], out["cpu"][1]
        assert d_card["alt_id"] == d_cpu["alt_id"] and d_card["match_drug"] == d_cpu["match_drug"]
        np.testing.assert_allclose(d_card["delta_affinity"], d_cpu["delta_affinity"], rtol=0,
                                   atol=2 * chip_smoke.AFFINITY_ATOL)
        for k, col in (("delta_prot_attention", "protein_attention"),
                       ("delta_prot_explanation", "protein_explanation")):
            for a, b in zip(d_card[k], d_cpu[k]):
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=2 * chip_smoke.ANALYSIS_RECORD_ATOL[col])
