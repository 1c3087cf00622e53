"""The port's run_model_on_dataset (caster_dta_torch/inference/evaluation.py)
against the JAX package's (caster_dta_tpu/inference/evaluation.py) on the
CPU, column by column: the records against the JAX DataFrame, their order,
lengths and None cells. Once with the trained runs/davis_seed9 weights and
the explainer off, once with a small random model and the explainer on; and
the checkpoint trio (load_model_from_checkpoint,
create_dataset_with_checkpoint_params, run_model_on_dataset) as
tests/test_inference.py runs the JAX one.

Tolerances: affinity AFFINITY_TOL = 1e-4 pKd, attention ATTN_TOL = 1e-5,
explanations EXPLAIN_TOL = 1e-5 (tests/test_torch_explain.py); ids, lengths
and pair indices exactly.
"""
import os

import jax
import numpy as np
import pytest
import torch

from caster_dta_tpu.data import synthetic as jsynthetic
from caster_dta_tpu.data.pairs import ProteinMoleculeDataset as JaxPMD
from caster_dta_tpu.inference.checkpoint import template_batch
from caster_dta_tpu.inference.evaluation import run_model_on_dataset as jax_run
from caster_dta_tpu.interop.torch_import import import_joint_gnn
from caster_dta_tpu.models.joint import make_joint_gnn as jax_make_joint_gnn
from caster_dta_tpu.train import checkpoints as jax_checkpoints
from caster_dta_torch.data import batching
from caster_dta_torch.inference import checkpoint as t_ckpt
from caster_dta_torch.inference.evaluation import run_model_on_dataset
from caster_dta_torch.models.joint import make_joint_gnn
from tests.test_inference import _small_model_kwargs
from tests.test_pipeline import DATASET_KWARGS
from tests.test_torch_explain import METADATA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "runs", "davis_seed9")
AFFINITY_TOL = 1e-4
ATTN_TOL = 1e-5
EXPLAIN_TOL = 1e-5
ARRAY_TOLS = {"protein_attention": ATTN_TOL, "molecule_attention": ATTN_TOL,
              "max_protein_attention": ATTN_TOL, "max_molecule_attention": ATTN_TOL,
              "prot_mol_attention": ATTN_TOL, "mol_prot_attention": ATTN_TOL,
              "protein_explanation": EXPLAIN_TOL, "molecule_explanation": EXPLAIN_TOL,
              "max_protein_explanation": EXPLAIN_TOL, "max_molecule_explanation": EXPLAIN_TOL,
              "protein_edge_explanation": EXPLAIN_TOL,
              "molecule_edge_explanation": EXPLAIN_TOL}


def _compare(records, df):
    assert set(records) == set(df.columns)
    n = len(df)
    for name in df.columns:
        got, want = records[name], list(df[name])
        assert len(got) == n, name
        for i, (g, w) in enumerate(zip(got, want)):
            if name in ARRAY_TOLS:
                if w is None:
                    assert g is None, (name, i)
                    continue
                w = np.asarray(w)
                assert g.shape == w.shape, (name, i)
                np.testing.assert_allclose(g, w, rtol=0, atol=ARRAY_TOLS[name],
                                           err_msg=f"{name}[{i}]")
            elif name == "affinity_score":
                assert abs(g - w) <= AFFINITY_TOL, (i, g, w)
            else:
                assert g == w, (name, i, g, w)
    assert records["pair_idx"] == sorted(records["pair_idx"])


def test_trained_run_records_match_jax_without_explainer():
    """runs/davis_seed9 on 14 seeded synthetic pairs, batches of up to 4
    (padding pairs included), the explainer off: None in its columns."""
    dataset = batching.synthetic_pair_dataset(14, 5, 4, protein_nodes=[(30, 60), (70, 120)],
                                              molecule_nodes=(10, 30), seed=21)
    model, _, kwargs = t_ckpt.load_model_from_checkpoint(RUN, device="cpu")
    jm = jax_make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                            **kwargs["joint_gnn_kwargs"])
    # the JAX package's checkpoint loader, with a template from eval_shape
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *template_batch(kwargs))
    variables = {"params": jax_checkpoints.load_params(
        template["params"], jax_checkpoints.get_best_model(RUN, "val"))}
    df = jax_run(jm, variables, dataset, max_batch_size=4, do_explainer=False)
    records = run_model_on_dataset(model, dataset, max_batch_size=4, do_explainer=False)
    assert len(df) == 14
    assert all(v is None for v in records["protein_explanation"])
    _compare(records, df)


def test_small_model_records_match_jax_with_explainer():
    pk, mk, jk = _small_model_kwargs(METADATA)
    kwargs = dict(protein_gnn_kwargs=pk, molecule_gnn_kwargs=mk, joint_gnn_kwargs=jk)
    model = make_joint_gnn(pk, mk, generator=torch.Generator().manual_seed(7), **jk).eval()
    variables = import_joint_gnn({k: v.detach().numpy() for k, v in model.state_dict().items()},
                                 kwargs)
    jm = jax_make_joint_gnn(pk, mk, **jk)
    dataset = batching.synthetic_pair_dataset(7, 3, 3, protein_nodes=[(10, 30)],
                                              molecule_nodes=(6, 14), seed=8)
    df = jax_run(jm, variables, dataset, max_batch_size=4)
    records = run_model_on_dataset(model, dataset, max_batch_size=4)
    assert len(df) == 7 and records["protein_explanation"][0] is not None
    for k in range(7):
        assert records["protein_explanation"][k].sum() == pytest.approx(1.0, abs=1e-5)
        assert len(records["protein_edge_explanation"][k]) > 0
    _compare(records, df)


def test_checkpoint_trio_runs_as_jaxs(tmp_path):
    """load_model_from_checkpoint -> create_dataset_with_checkpoint_params ->
    run_model_on_dataset with the explainer on, as tests/test_inference.py
    runs the JAX trio, against the JAX trio on the same folder."""
    from caster_dta_tpu.inference.checkpoint import (
        create_dataset_with_checkpoint_params as jax_dataset,
        load_model_from_checkpoint as jax_load)

    data_dir = tmp_path / "pdbs"
    df_in = jsynthetic.make_synthetic_dataframe(str(data_dir), n_proteins=3, n_molecules=4,
                                                n_pairs=10, seed=2)
    jds = JaxPMD(df_in, **DATASET_KWARGS)
    pk, mk, jk = _small_model_kwargs(jds.metadata_dict)
    model = make_joint_gnn(pk, mk, generator=torch.Generator().manual_seed(1), **jk)
    from caster_dta_torch.interop.from_jax import to_jax_params
    from caster_dta_torch.train import checkpoints
    folder = tmp_path / "ckpt"
    checkpoints.save_run_artifacts(str(folder), dict(DATASET_KWARGS), jds._report_scale_data(),
                                   pk, mk, jk)
    checkpoints.save_params(to_jax_params(model), os.path.join(
        folder, checkpoints.best_checkpoint_name("val", "synthetic", 0.5, 3)))

    t_model, _, t_kwargs = t_ckpt.load_model_from_checkpoint(str(folder), device="cpu")
    assert t_kwargs["protein_gnn_kwargs"]["base_conv"] == "lbamodel"
    records = {k: list(df_in[k]) for k in df_in.columns}
    t_ds = t_ckpt.create_dataset_with_checkpoint_params(records, str(folder))
    got = run_model_on_dataset(t_model, t_ds, max_batch_size=4, max_num=100_000,
                               explainer_epochs=2)

    j_model, j_vars, _ = jax_load(str(folder))
    want = jax_run(j_model, j_vars, jax_dataset(df_in, str(folder)), max_batch_size=4,
                   max_num=100_000, do_explainer=True, explainer_epochs=2)
    assert len(got["pair_idx"]) == len(df_in)
    assert len(got["protein_attention"][0]) == got["protein_len"][0]
    _compare(got, want)
