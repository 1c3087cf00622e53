"""The downstream analyses with the trained runs/davis_seed9 model at full
width, port against JAX on the CPU, on the repository's inputs under
analysis_results/pretrained_bindingdb/ (six Davis kinases of 309-403
residues with their BioLiP rows and ligand table, their ref/alt variant
structures, four drugs), read in place: a package's caches go to its own
directory, whose ``pdb_files`` is a link to the repository's structures.

BioLIP (6 pairs with the explainer, in batches of 8 as the variation
task's, so each batch shape's JAX explainer compiles once), the variation
task (two kinases with the point variant whose structures are committed
under pgx, against the four drugs of the committed ligand table: 16 pairs
with the explainer, 8 deltas) and the binder screen (6 proteins x the 24 drugs of the committed
screen, no explainer). Rows, ids and order exact; affinity 1e-4 pKd,
attention and the node explanations 1e-5, each delta twice its inputs'
limit (tests/test_torch_analysis.py's compare); the raw edge explanations
TRAINED_EDGE_EXPLAIN_TOL. JAX's analyses load each run once and share one
explainer per model (test_torch_analysis.jax_compiles_once).

At the trained model's full width the explainer's 10 Adam steps carry f32
rounding into the raw masks at the 1e-5 level in any f32 run: Adam divides
each entry by its own running norm, so an entry whose gradient nearly
cancels moves by a step-size fraction whatever its gradient's rounding.
On the variation task's first batch under tests/conftest.py's XLA flags
(scripts/explainer_jax_floor.py with the same XLA_FLAGS) the port's raw
protein edge masks lie 1.138e-5 from JAX's jitted ones and 1.132e-5 from
JAX op by op (``jax.disable_jit``), JAX's two 6.4e-6 apart; its raw
protein node masks differ by 3.4e-5 between jitted and op by op. So the raw
edge masks are held at twice the port's distance, rounded up. JAX op by op
is no nearer reference, and too slow for a test here: 94-119 s a batch on 8
CPU cores. (Softmaxed over a graph's real nodes, the node masks in the
records lie within 1.7e-7.)
"""
import csv
import os

import pytest

from caster_dta_torch.analysis import binders as t_binders
from caster_dta_torch.analysis import biolip as t_biolip
from caster_dta_torch.analysis import variation as t_variation
from caster_dta_tpu.analysis import binders as j_binders
from caster_dta_tpu.analysis import biolip as j_biolip
from caster_dta_tpu.analysis import variation as j_variation
from tests.test_torch_analysis import (compare, compare_topk, jax_compiles_once,
                                       one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "runs", "davis_seed9")
INPUTS = os.path.join(REPO, "analysis_results", "pretrained_bindingdb")
TRAINED_EDGE_EXPLAIN_TOL = 2.5e-5


@pytest.fixture(scope="module", autouse=True)
def jax_loads_each_run_once():
    with jax_compiles_once(), one_torch_thread():
        yield


def kinases() -> dict:
    """{protein id: sequence} of the committed BioLiP table."""
    with open(os.path.join(INPUTS, "biolip", "data", "BioLiP_nr.txt"), newline="") as f:
        return {r[17]: r[20] for r in csv.reader(f, delimiter="\t")}


def ligands() -> dict:
    """{name: SMILES} of the committed ligand table."""
    with open(os.path.join(INPUTS, "biolip", "data", "ligand.tsv"), newline="") as f:
        return {r["name"]: r["SMILES"] for r in csv.DictReader(f, delimiter="\t")}


def linked(tmp, task: str) -> str:
    """A base data directory whose pdb_files is the committed one."""
    os.makedirs(tmp)
    os.symlink(os.path.join(INPUTS, task, "data", "pdb_files"), os.path.join(tmp, "pdb_files"))
    return tmp


def test_trained_biolip_matches_jax(tmp_path):
    out = {}
    for side, fn, kw in (("torch", t_biolip.run_biolip_binding, {"device": "cpu"}),
                         ("jax", j_biolip.run_biolip_binding, {})):
        base = linked(str(tmp_path / side), "biolip")
        out[side] = fn(RUN, os.path.join(INPUTS, "biolip", "data", "BioLiP_nr.txt"),
                       os.path.join(INPUTS, "biolip", "data", "ligand.tsv"),
                       str(tmp_path / side / "results"), base, max_batch_size=8, **kw)
    compare(out["torch"], out["jax"], (str(tmp_path / "jax"), str(tmp_path / "torch")),
            TRAINED_EDGE_EXPLAIN_TOL)
    assert [p.split("__")[0] for p in out["torch"]["protein_id"]] == sorted(kinases())
    assert all(len(a) == len(s) for a, s in zip(out["torch"]["protein_attention"],
                                                out["torch"]["protein_sequence"]))


def test_trained_variation_matches_jax(tmp_path):
    drugs = ligands()
    pairs = {}
    for (pid, seq), name in zip(list(kinases().items())[:2], list(drugs)[:2]):
        mid = len(seq) // 2
        pairs[f"rs_{pid}_{name}"] = {
            "ref_seq": seq, "alt_seq": seq[:mid] + ("W" if seq[mid] != "W" else "F") +
            seq[mid + 1:]}
    out = {}
    for side, fn, kw in (("torch", t_variation.run_dta_variation, {"device": "cpu"}),
                         ("jax", j_variation.run_dta_variation, {})):
        base = linked(str(tmp_path / side), "pgx")
        out[side] = fn(RUN, {}, drugs, str(tmp_path / side / "results"), base,
                       test_sequence_pairs=pairs, max_batch_size=8, **kw)
    (t, td), (j, jd) = out["torch"], out["jax"]
    paths = (str(tmp_path / "jax"), str(tmp_path / "torch"))
    compare(t, j, paths, TRAINED_EDGE_EXPLAIN_TOL)
    compare(td, jd, paths, TRAINED_EDGE_EXPLAIN_TOL)
    assert len(j) == 16 and len(jd) == 8
    assert td["match_drug"] == [m.lower() in v.lower() for m, v in
                                zip(td["molecule_id"], td["variant_id"])]
    assert sum(td["match_drug"]) == 2


def test_trained_binder_screen_matches_jax(tmp_path):
    import pandas as pd
    screen = pd.read_pickle(os.path.join(INPUTS, "binders", "ad_raw_results.pkl"))
    drugs = dict(zip(screen["molecule_id"], screen["molecule_smiles"]))
    assert len(drugs) == 24
    files = {p: os.path.join(INPUTS, "binders", "data", "pdb_files", f"{p}.pdb")
             for p in kinases()}
    out = {}
    for side, fn, kw in (("torch", t_binders.run_protein_binders, {"device": "cpu"}),
                         ("jax", j_binders.run_protein_binders, {})):
        out[side] = fn(RUN, files, drugs, str(tmp_path / side / "results"),
                       str(tmp_path / side / "data"), max_batch_size=16, k_drugs=5, **kw)
    (t, tk), (j, jk) = out["torch"], out["jax"]
    compare(t, j)
    assert len(j) == 6 * 24
    compare_topk(tk, jk)


@pytest.mark.parametrize("extra", [False, True])
def test_ligand_table_drugs_pass_the_trained_filters_as_in_jax(extra):
    """The committed ligands (and sodium and a two-fragment SMILES) through
    both packages' vocabulary filters with the trained model's kwargs: the
    filters drop sodium's atom, not fragments (the strict SMILES check
    does)."""
    import json

    import pandas as pd
    from caster_dta_torch.analysis import common as t_common
    from caster_dta_tpu.analysis import common as j_common
    with open(os.path.join(RUN, "model_kwargs.json")) as f:
        kwargs = json.load(f)
    lig = ligands()
    drug = {"id": list(lig), "smiles": list(lig.values())}
    if extra:
        drug = {"id": drug["id"] + ["na", "frag"], "smiles": drug["smiles"] + ["[Na+]", "CC.O"]}
    prot = {"id": list(kinases()), "seq": list(kinases().values())}
    tp, td = t_common.apply_vocab_sanity_filters(prot, drug, kwargs)
    jp, jd = j_common.apply_vocab_sanity_filters(pd.DataFrame(prot), pd.DataFrame(drug), kwargs)
    assert tp == {k: jp[k].tolist() for k in jp} and td == {k: jd[k].tolist() for k in jd}
    assert td["id"] == list(lig) + (["frag"] if extra else [])
