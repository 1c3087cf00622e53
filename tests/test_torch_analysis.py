"""The three downstream analyses of the port (caster_dta_torch/analysis/)
against the JAX package's (caster_dta_tpu/analysis/), on the CPU.

(a) ``run_biolip_binding``, ``run_dta_variation`` and
``run_protein_binders`` end to end in both packages on a small random model
(tests/test_inference.py's widths, its checkpoint written by the port and
read by both) and chip_smoke.analysis_inputs' tables and helices at test
size: the same rows, ids and order as JAX's DataFrames; affinity within
AFFINITY_TOL (1e-4 pKd), attention within ATTN_TOL (1e-5), explanations
within EXPLAIN_TOL (1e-5), each delta within twice its inputs' limit, the
top-k as JAX's (as sets where scores tie: the port sorts stably, pandas'
quicksort does not).

(b) ``compute_refalt_deltas``, ``top_k`` and the three ``visualize_*`` fed
the same records in both packages: deltas equal, t and p within 1e-12
relative, the same top-percentile CSV bytes, the same figure names.

tests/test_torch_analysis_trained.py runs (a) with runs/davis_seed9 on the
repository's kinase structures.
"""
import contextlib
import functools
import os
import pickle

import numpy as np
import pandas as pd
import pytest

import chip_smoke
from caster_dta_torch.analysis import binders as t_binders
from caster_dta_torch.analysis import biolip as t_biolip
from caster_dta_torch.analysis import variation as t_variation
from caster_dta_torch.analysis import visualize as t_visualize
from caster_dta_torch.data import tables
from caster_dta_tpu.analysis import binders as j_binders
from caster_dta_tpu.analysis import biolip as j_biolip
from caster_dta_tpu.analysis import variation as j_variation
from caster_dta_tpu.analysis import visualize as j_visualize

AFFINITY_TOL = 1e-4
ATTN_TOL = 1e-5
EXPLAIN_TOL = 1e-5
TTEST_RTOL = 1e-12


def column_tol(name: str, edge_explain_tol: float = EXPLAIN_TOL):
    """The tolerance of a results or deltas column: None for exact."""
    base = None
    if "affinity" in name:
        base = AFFINITY_TOL
    elif "attention" in name:
        base = ATTN_TOL
    elif "edge_explanation" in name:
        base = edge_explain_tol
    elif "explanation" in name:
        base = EXPLAIN_TOL
    if base is not None and name.startswith("delta_"):
        return 2 * base
    return base


def compare(records: dict, df: pd.DataFrame, path_map=None,
            edge_explain_tol: float = EXPLAIN_TOL) -> None:
    """The port's records against the JAX package's DataFrame: the same
    columns in the same order, the same rows; numbers at column_tol."""
    assert list(records) == list(df.columns)
    n = len(df)
    for name in df.columns:
        got, want = records[name], df[name].tolist()
        assert len(got) == n, name
        tol = column_tol(name, edge_explain_tol)
        for i, (g, w) in enumerate(zip(got, want)):
            if isinstance(w, str) and path_map:
                w = w.replace(*path_map)
            if w is None:
                assert g is None, (name, i)
            elif tol is not None:
                if isinstance(w, float) and np.isnan(w):
                    assert tables.is_na(g), (name, i)
                    continue
                w = np.asarray(w)
                g = np.asarray(g)
                assert g.shape == w.shape, (name, i)
                np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"{name}[{i}]")
            elif isinstance(w, np.ndarray):
                assert np.array_equal(g, w), (name, i)
            elif isinstance(w, float) and np.isnan(w):
                assert tables.is_na(g), (name, i)
            else:
                assert g == w, (name, i, g, w)


def compare_topk(topk: dict, jax_topk: pd.DataFrame) -> None:
    """Per protein, JAX's top-k scores within AFFINITY_TOL and its molecules
    in its order, as sets within a run of scores closer than 2 x
    AFFINITY_TOL (their order is the sort's choice); in the last run, which
    may go on past the cut at k, the scores alone."""
    assert sorted(set(topk["protein_id"])) == sorted(set(jax_topk["protein_id"]))
    for p in set(jax_topk["protein_id"]):
        sub = jax_topk[jax_topk["protein_id"] == p]
        want_ids, want_s = sub["molecule_id"].tolist(), sub["affinity_score"].tolist()
        rows = [i for i, q in enumerate(topk["protein_id"]) if q == p]
        got_ids = [topk["molecule_id"][i] for i in rows]
        np.testing.assert_allclose([topk["affinity_score"][i] for i in rows], want_s,
                                   rtol=0, atol=AFFINITY_TOL)
        cuts = [i for i in range(1, len(want_s)) if abs(want_s[i - 1] - want_s[i])
                > 2 * AFFINITY_TOL]
        for start, end in zip([0] + cuts, cuts):
            assert set(got_ids[start:end]) == set(want_ids[start:end]), (p, start, end)


def _run_both(fn_t, fn_j, tmp, kwargs, **extra):
    """One analysis in each package on the same inputs; each package's
    caches and results in its own directories."""
    out = {}
    for side, fn in (("torch", fn_t), ("jax", fn_j)):
        kw = dict(kwargs)
        kw["results_dir"] = os.path.join(tmp, side, "results")
        kw.update(extra.get(side, {}))
        out[side] = fn(**kw)
    return out["torch"], out["jax"]


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """A small random model's run folder, written by the port and read by
    both packages."""
    import torch

    from caster_dta_torch.data import synthetic
    from caster_dta_torch.data.pairs import ProteinMoleculeDataset
    from caster_dta_torch.interop.from_jax import to_jax_params
    from caster_dta_torch.models.joint import make_joint_gnn
    from caster_dta_torch.train import checkpoints
    from tests.test_inference import _small_model_kwargs
    from tests.test_pipeline import DATASET_KWARGS

    out = str(tmp_path_factory.mktemp("small_run"))
    rec = synthetic.make_synthetic_records(str(tmp_path_factory.mktemp("pdbs")), n_proteins=3,
                                           n_molecules=4, n_pairs=16, seed=4)
    ds = ProteinMoleculeDataset(rec, **DATASET_KWARGS)
    pk, mk, jk = _small_model_kwargs(ds.metadata_dict)
    model = make_joint_gnn(pk, mk, generator=torch.Generator().manual_seed(5), **jk)
    checkpoints.save_run_artifacts(out, dict(DATASET_KWARGS), ds._report_scale_data(),
                                   pk, mk, jk)
    checkpoints.save_params(to_jax_params(model), os.path.join(
        out, checkpoints.best_checkpoint_name("val", "synthetic", 0.5, 3)))
    return out


def jax_load_model(check_path: str):
    """The JAX package's ``load_model_from_checkpoint`` for a run of msgpack
    parameters, with the template's shapes from ``jax.eval_shape`` in place
    of an op-by-op ``model.init`` (20-30 s on the CPU at either width): the
    parameters are the file's either way, and the template holds no other
    collection."""
    import json

    import jax
    from caster_dta_tpu.inference.checkpoint import template_batch
    from caster_dta_tpu.models.joint import make_joint_gnn
    from caster_dta_tpu.train import checkpoints as j_checkpoints

    with open(os.path.join(check_path, "model_kwargs.json")) as f:
        kwargs = json.load(f)
    model = make_joint_gnn(kwargs["protein_gnn_kwargs"], kwargs["molecule_gnn_kwargs"],
                           **kwargs["joint_gnn_kwargs"])
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *template_batch(kwargs))
    assert list(shapes) == ["params"]
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
    params = j_checkpoints.load_params(template, j_checkpoints.get_best_model(check_path, "val"))
    return model, {"params": params}, kwargs


@contextlib.contextmanager
def jax_compiles_once():
    """The JAX package's analyses with each run folder loaded once
    (``jax_load_model``) and one explainer per model and epoch count, whose
    jitted program a batch shape then compiles once for every analysis that
    meets it (``run_model_on_dataset`` makes a new explainer, so a new
    compile, on each call)."""
    from caster_dta_tpu.inference import evaluation as j_evaluation
    from caster_dta_tpu.inference.explain import DTAModelExplainer

    explainers = {}

    def explainer(model, **kw):
        key = (id(model), tuple(sorted(kw.items())))
        if key not in explainers:
            explainers[key] = (model, DTAModelExplainer(model, **kw))
        return explainers[key][1]

    load = functools.cache(jax_load_model)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (j_biolip, j_variation, j_binders):
            mp.setattr(mod, "load_model_from_checkpoint", load)
        mp.setattr(j_evaluation, "DTAModelExplainer", explainer)
        yield


@contextlib.contextmanager
def one_torch_thread():
    """The port's CPU runs on one thread: beside other test workers, its
    OpenMP threads wait on each other's cores (the trained BioLIP case took
    224 s beside three workers on 8 threads, 29 s on one). The records are
    the same bits on any thread count."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def jax_loads_each_run_once():
    with jax_compiles_once(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return chip_smoke.analysis_inputs(str(tmp_path_factory.mktemp("inputs")),
                                      biolip_proteins=9, variant_pairs=2, variant_drugs=3,
                                      binder_proteins=3, binder_drugs=8, residues=(20, 32))


@pytest.fixture(scope="module")
def biolip(small_run, inputs, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("biolip"))
    kw = dict(model_folder=small_run, max_batch_size=4, **inputs["biolip"])
    return _run_both(t_biolip.run_biolip_binding, j_biolip.run_biolip_binding, tmp, kw,
                     torch={"device": "cpu"}), tmp


@pytest.fixture(scope="module")
def variation(small_run, inputs, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("variation"))
    kw = dict(model_folder=small_run, max_batch_size=4, **inputs["variation"])
    return _run_both(t_variation.run_dta_variation, j_variation.run_dta_variation, tmp, kw,
                     torch={"device": "cpu"}), tmp


@pytest.fixture(scope="module")
def binders(small_run, inputs, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("binders"))
    drugs = t_binders.drugs_from_drugbank(inputs["binders"]["drugbank_file"])
    kw = dict(model_folder=small_run, max_batch_size=8, k_drugs=3, test_drugs=drugs,
              protids_to_files=inputs["binders"]["protids_to_files"],
              base_data_dir=inputs["binders"]["base_data_dir"])
    return _run_both(t_binders.run_protein_binders, j_binders.run_protein_binders, tmp, kw,
                     torch={"device": "cpu"}), tmp


# ------------------------------------------------------------------------ (a)

def test_biolip_matches_jax(biolip):
    (t, j), tmp = biolip
    compare(t, j)
    assert len(j) == 9 and np.isfinite(j["affinity_score"]).all()
    assert all(not tables.is_na(x) for x in t["molecule_name"])
    assert len({p.split("__")[0] for p in t["protein_id"]}) == 9
    with open(os.path.join(tmp, "torch", "results", "biolip_raw_records.pkl"), "rb") as f:
        saved = pickle.load(f)
    assert list(saved) == list(t) and saved["pair_idx"] == t["pair_idx"]


def test_biolip_drops_both_copies_of_a_repeated_pair(small_run, inputs, tmp_path,
                                                     monkeypatch):
    """A protein listed twice with one ligand: drop_duplicates(keep=False)
    drops both rows in either package. JAX's pairs are taken where its
    function hands them to the dataset build, with only the run's kwargs
    loaded (no model is built or run); the port's ``biolip_pairs`` must give
    the same rows."""
    import json

    b = inputs["biolip"]
    lines = open(b["biolip_file"]).read().splitlines(keepends=True)
    path = str(tmp_path / "BioLiP_nr.txt")
    with open(path, "w") as f:
        f.writelines(lines + [lines[-1]])

    class Pairs(Exception):
        pass

    def capture(df, *args, **kwargs):
        raise Pairs(df)

    with open(os.path.join(small_run, "model_kwargs.json")) as f:
        kwargs = json.load(f)
    monkeypatch.setattr(j_biolip, "load_model_from_checkpoint", lambda folder: (None, None,
                                                                                kwargs))
    monkeypatch.setattr(j_biolip, "create_dataset_with_checkpoint_params", capture)
    with pytest.raises(Pairs) as got:
        j_biolip.run_biolip_binding(small_run, path, b["biolip_ligand_file"],
                                    str(tmp_path / "res"), b["base_data_dir"])
    want = got.value.args[0].reset_index(drop=True)
    pairs = t_biolip.biolip_pairs(path, b["biolip_ligand_file"], b["base_data_dir"], kwargs)
    compare(pairs, want)
    assert len(want) == 8


def test_variation_matches_jax(variation):
    ((t, td), (j, jd)), tmp = variation
    compare(t, j)
    compare(td, jd)
    assert len(j) == 6 * 3 and len(jd) == 3 * 3
    assert list(td)[-7:] == ["alt_mol_explanation", "alt_prot_explanation",
                             "delta_mol_explanation", "delta_prot_explanation",
                             "ref_mol_explanation", "ref_prot_explanation", "match_drug"]
    assert td["match_drug"].count(True) == 3        # each variant names one drug
    i = td["variant_code"].index("rs0000001")
    assert td["ref_id"][i] == "NP_000001.1" and td["ref_id"][i] in td["alt_id"][i]
    np.testing.assert_allclose(td["delta_affinity"],
                               np.subtract(td["alt_affinity"], td["ref_affinity"]), atol=0)
    for name in ("pgx_raw_records.pkl", "pgx_delta_records.pkl"):
        assert os.path.exists(os.path.join(tmp, "torch", "results", name))


def test_binders_match_jax(binders):
    ((t, tk), (j, jk)), _ = binders
    compare(t, j)
    assert len(j) == 3 * 8
    assert all(v is None for v in t["protein_explanation"])
    compare_topk(tk, jk)
    assert len(tk["protein_id"]) == 3 * 3


def test_deltas_nan_where_lengths_differ_and_smarter_matching():
    """delta_prot is NaN where ref and alt differ in length; an rsID
    variant keeps a pair only where the ref id is inside the alt id and the
    sequences differ; a manual one keeps every pair. Same records in."""
    f32 = np.float32
    res = {"protein_id": ["R", "R:p.X", "Q", "R:p.Y"], "molecule_id": ["m"] * 4,
           "protein_file": ["r.pdb", "a.pdb", "q.pdb", "y.pdb"],
           "affinity_score": [5.0, 5.5, 6.0, 4.0],
           "protein_attention": [np.ones(3, f32) / 3, np.ones(4, f32) / 4,
                                 np.ones(3, f32) / 3, np.array([0.5, 0.25, 0.25], f32)],
           "molecule_attention": [np.array([0.5, 0.5], f32), np.array([0.25, 0.75], f32),
                                  np.array([1.0, 0.0], f32), np.array([0.1, 0.9], f32)]}
    seqs = {"R": "ABC", "R:p.X": "ABCD", "Q": "ABC", "R:p.Y": "ABD"}
    vmap = {"v1": {"ref_id": ["R"], "alt_id": ["R:p.X", "Q", "R:p.Y"]},
            "v2": {"ref_id": ["R"], "alt_id": ["Q"]}}
    vd = {"variant_id": ["v1", "v2"], "variant_code": ["rs1", "manual"],
          "molecule_id": ["m", "m"], "molecule_smiles": ["CC", "CC"]}
    t = t_variation.compute_refalt_deltas(res, vmap, seqs, vd)
    j = j_variation.compute_refalt_deltas(pd.DataFrame(res), vmap, seqs, pd.DataFrame(vd))
    compare(t, j)
    assert t["alt_id"] == ["R:p.X", "R:p.Y", "Q"]
    assert tables.is_na(t["delta_prot_attention"][0])
    # v2 as an rsID variant: its only alt id does not hold the ref id, no row
    rs_only = dict(vd, variant_id=["v2"], variant_code=["rs1"], molecule_id=["m"],
                   molecule_smiles=["CC"])
    assert t_variation.compute_refalt_deltas(res, vmap, seqs, rs_only) == {}


# ------------------------------------------------------------------------ (b)

def _as_frame(records: dict) -> pd.DataFrame:
    return pd.DataFrame({k: pd.Series(v, dtype=object) if any(
        isinstance(x, np.ndarray) or x is None for x in v) else v for k, v in records.items()})


@pytest.mark.parametrize("base_score", ["attention", "explanation"])
def test_biolip_statistics_equal_jax_on_the_same_records(biolip, tmp_path, base_score):
    (t, _), _ = biolip
    got = t_visualize.visualize_biolip_results(t, str(tmp_path / "t"), base_score, draw=False)
    want = j_visualize.visualize_biolip_results(_as_frame(t), str(tmp_path / "j"), base_score)
    assert got.keys() == want.keys()
    for k in want:
        for s in ("t", "p"):
            assert got[k][s] == pytest.approx(want[k][s], rel=TTEST_RTOL, abs=0), (k, s)
    drawn = t_visualize.visualize_biolip_results(t, str(tmp_path / "t"), base_score)
    assert drawn == got
    assert sorted(os.listdir(tmp_path / "t" / base_score)) == \
        sorted(os.listdir(tmp_path / "j" / base_score))


def test_deltas_equal_jax_on_the_same_records(variation, inputs):
    ((t, td), _), _ = variation
    v = inputs["variation"]
    from caster_dta_torch.inference.variant_to_protein import variant_to_protein_seq
    vmap, seqs = variant_to_protein_seq(v["test_variants"],
                                        os.path.join(v["base_data_dir"], "other_data"))
    import hashlib
    for k, pair in v["test_sequence_pairs"].items():
        ids = [hashlib.sha256(pair[s].encode()).hexdigest() for s in ("ref_seq", "alt_seq")]
        seqs.update(zip(ids, (pair["ref_seq"], pair["alt_seq"])))
        vmap[k] = {"ref_id": ids[:1], "alt_id": ids[1:]}
    names = {**{k: "manual" for k in v["test_sequence_pairs"]}, **v["test_variants"]}
    vd = tables.merge({"variant_id": list(names), "variant_code": list(names.values())},
                      {"molecule_id": list(v["test_drugs"]),
                       "molecule_smiles": list(v["test_drugs"].values())}, how="cross")
    for kind in ("attention", "explanation"):
        got = t_variation.compute_refalt_deltas(t, vmap, seqs, vd, kind)
        want = j_variation.compute_refalt_deltas(_as_frame(t), vmap, seqs, pd.DataFrame(vd),
                                                 kind)
        assert list(got) == list(want.columns)
        for c in want.columns:
            for g, w in zip(got[c], want[c].tolist()):
                if isinstance(w, np.ndarray):
                    assert np.array_equal(g, w), c
                else:
                    assert g == w, c
        assert all(np.array_equal(a, b) for a, b in zip(got[f"ref_prot_{kind}"],
                                                         td[f"ref_prot_{kind}"]))


def test_variation_figures_named_as_jax(variation, tmp_path):
    ((_, td), _), _ = variation
    want = j_visualize.visualize_variation_results(_as_frame(td), str(tmp_path / "j"),
                                                   max_pairs=2)
    named = t_visualize.visualize_variation_results(td, str(tmp_path / "t"), max_pairs=2,
                                                    draw=False)
    assert not os.path.exists(tmp_path / "t")
    got = t_visualize.visualize_variation_results(td, str(tmp_path / "t"), max_pairs=2)
    strip = [(os.path.basename(a), os.path.basename(b)) for a, b in want]
    assert [(os.path.basename(a), os.path.basename(b)) for a, b in got] == strip
    assert [(os.path.basename(a), os.path.basename(b)) for a, b in named] == strip
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


@pytest.mark.parametrize("percentile", [50.0, 90.0, 99.0])
def test_binder_percentile_csv_equals_jax_on_the_same_records(binders, tmp_path, percentile):
    ((t, _), _), _ = binders
    got, drawn = t_visualize.visualize_binder_results(t, str(tmp_path / "t"), percentile,
                                                      draw=False)
    want, _ = j_visualize.visualize_binder_results(_as_frame(t), str(tmp_path / "j"),
                                                   percentile)
    assert drawn == []
    assert got["pair_idx"] == want["pair_idx"].tolist()
    name = "top_percentile_binders.csv"
    assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("higher_is_better", [True, False])
def test_top_k_equals_pandas_on_the_same_records(binders, higher_is_better):
    """The port's stable top-k against pandas' with a stable sort on the
    same records: the same rows in the same order."""
    ((t, _), _), _ = binders
    got = t_binders.top_k(t, 3, higher_is_better)
    df = _as_frame(t)
    want = df.sort_values("affinity_score", ascending=not higher_is_better,
                          kind="stable").groupby("protein_id").head(3)
    assert got["pair_idx"] == want["pair_idx"].tolist()
