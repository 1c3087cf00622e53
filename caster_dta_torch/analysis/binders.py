"""Virtual binder-screen task: DrugBank x a fixed list of protein
structures (counterpart of caster_dta_tpu/analysis/binders.py).

Behavioral spec: reference test_protein_binders.py: sequences extracted from
local PDB files, a DrugBank (or explicit SMILES dict) drug list with
approved-only filtering, model-vocabulary sanity filters, cross-product
evaluation without the explainer, pickled raw results + top-k ranking. The
JAX package ranks with pandas' default quicksort, which does not keep tied
scores in order; the port sorts stably (ties keep the table's order), so
where scores tie its top-k may hold other members of the tie.
"""
from __future__ import annotations

import os
import pickle

from caster_dta_torch.analysis import common
from caster_dta_torch.data import tables
from caster_dta_torch.inference.checkpoint import (
    create_dataset_with_checkpoint_params, load_model_from_checkpoint)
from caster_dta_torch.inference.evaluation import run_model_on_dataset


def drugs_from_drugbank(drugbank_file: str, only_approved: bool = True) -> dict:
    """DrugBank XML (or a ZIP of it) -> {name: smiles} (reference
    test_protein_binders.py drug assembly with the approved-only filter)."""
    from caster_dta_torch.inference.load_drugbank import load_drugbank
    db = load_drugbank(drugbank_file)
    keep = [isinstance(s, str) and len(s) > 0 for s in db["smiles"]]
    if only_approved:
        keep = [k and "approved" in g and "withdrawn" not in g
                for k, g in zip(keep, db["groups"])]
    return {n: s for n, s, k in zip(db["name"], db["smiles"], keep) if k}


def top_k(results: dict, k_drugs: int = 10, higher_is_better: bool = True) -> dict:
    """The ``k_drugs`` best-scored rows of each protein, best first over all
    proteins (``sort_values`` then ``groupby("protein_id").head(k)``), with
    a stable sort."""
    ordered = tables.sort_by(results, "affinity_score", ascending=not higher_is_better)
    seen, rows = {}, []
    for i, p in enumerate(ordered["protein_id"]):
        seen[p] = seen.get(p, 0) + 1
        if seen[p] <= k_drugs:
            rows.append(i)
    return tables.take(ordered, rows)


def run_protein_binders(model_folder: str, protids_to_files: dict,
                        test_drugs: dict, results_dir: str,
                        base_data_dir: str, max_batch_size: int = 16,
                        k_drugs: int = 10, higher_is_better: bool = True,
                        n_workers=0, device="cuda"):
    """-> (records of every protein x drug pair, the top-k records), pickled
    as ``ad_raw_records.pkl`` and ``ad_topk_records.pkl`` in
    ``results_dir``. The model runs on ``device``."""
    os.makedirs(results_dir, exist_ok=True)
    other_dir = os.path.join(base_data_dir, "other_data")
    os.makedirs(other_dir, exist_ok=True)

    if not isinstance(protids_to_files, dict):
        protids_to_files = {os.path.basename(x): x for x in protids_to_files}

    protid_seq = {pid: common.sequence_from_pdb(path)
                  for pid, path in protids_to_files.items()}
    prot_df = {"id": list(protid_seq.keys()), "seq": list(protid_seq.values()),
               "file": [protids_to_files[p] for p in protid_seq]}
    drug_df = {"id": list(test_drugs.keys()), "smiles": list(test_drugs.values())}

    model, _, model_kwargs = load_model_from_checkpoint(model_folder, device=device)
    prot_df, drug_df = common.apply_vocab_sanity_filters(prot_df, drug_df, model_kwargs)

    combined = tables.merge(
        tables.rename(prot_df, {"id": "protein_id", "seq": "protein_sequence",
                                "file": "protein_file"}),
        tables.rename(drug_df, {"id": "molecule_id", "smiles": "molecule_smiles"}),
        how="cross")
    combined["affinity_score"] = [0.0] * tables.n_rows(combined)
    combined = tables.sort_by(combined, ["protein_id", "molecule_id"])

    dataset = create_dataset_with_checkpoint_params(combined, model_folder,
                                                    cache_dir=other_dir, n_workers=n_workers)
    parsed = run_model_on_dataset(model, dataset, max_batch_size=max_batch_size,
                                  do_explainer=False)
    results = tables.merge({k: v for k, v in combined.items() if k != "affinity_score"},
                           parsed, on=["protein_id", "molecule_id"], how="left")
    with open(os.path.join(results_dir, "ad_raw_records.pkl"), "wb") as f:
        pickle.dump(results, f)

    topk = top_k(results, k_drugs, higher_is_better)
    with open(os.path.join(results_dir, "ad_topk_records.pkl"), "wb") as f:
        pickle.dump(topk, f)
    return results, topk
