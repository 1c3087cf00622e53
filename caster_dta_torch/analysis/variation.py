"""PharmGKB variant-effect task: ref-vs-alt affinity and attention deltas
(counterpart of caster_dta_tpu/analysis/variation.py).

Behavioral spec: reference test_dta_variation.py: rsID -> ref/alt protein
sequences (Ensembl/Mutalyzer with caches), optional manually specified
sequence pairs (sha256-keyed), structure acquisition, protein x drug cross
product, batched evaluation, and per-variant ref/alt deltas with the
"smarter" ref-in-alt matching. The signs are the JAX package's:
``delta_prot = ref - alt`` but ``delta_mol = alt - ref`` and
``delta_affinity = alt - ref``. Tables and results are records.
"""
from __future__ import annotations

import hashlib
import os
import pickle

import numpy as np

from caster_dta_torch.data import tables
from caster_dta_torch.inference.checkpoint import (
    create_dataset_with_checkpoint_params, load_model_from_checkpoint)
from caster_dta_torch.inference.evaluation import run_model_on_dataset
from caster_dta_torch.inference.structures import acquire_pdbs
from caster_dta_torch.inference.variant_to_protein import variant_to_protein_seq


def compute_refalt_deltas(results_df: dict, var_protid_map: dict, protid_seq_map: dict,
                          variant_drug_df: dict, attn_type: str = "attention",
                          attempt_smarter_matching: bool = True) -> dict:
    """Ref-vs-alt statistics per variant-drug pair
    (reference test_dta_variation.py:226-319). ``delta_prot`` is NaN where
    the two proteins' lengths differ. No rows give records with no columns."""
    rows = []
    for var_id, mol_id, code, smiles in zip(
            variant_drug_df["variant_id"], variant_drug_df["molecule_id"],
            variant_drug_df["variant_code"], variant_drug_df["molecule_smiles"]):
        ref_ids = set(var_protid_map[var_id]["ref_id"])
        alt_ids = set(var_protid_map[var_id]["alt_id"])
        ref_rows = [i for i, (p, m) in enumerate(zip(results_df["protein_id"],
                                                     results_df["molecule_id"]))
                    if p in ref_ids and m == mol_id]
        alt_rows = [i for i, (p, m) in enumerate(zip(results_df["protein_id"],
                                                     results_df["molecule_id"]))
                    if p in alt_ids and m == mol_id]
        for r in ref_rows:
            for a in alt_rows:
                ref_id, alt_id = results_df["protein_id"][r], results_df["protein_id"][a]
                ref_seq, alt_seq = protid_seq_map[ref_id], protid_seq_map[alt_id]
                if attempt_smarter_matching and code != "manual":
                    if ref_id not in alt_id or ref_seq == alt_seq:
                        continue
                ref_pattn = results_df[f"protein_{attn_type}"][r]
                alt_pattn = results_df[f"protein_{attn_type}"][a]
                ref_mattn = results_df[f"molecule_{attn_type}"][r]
                alt_mattn = results_df[f"molecule_{attn_type}"][a]
                ref_aff = results_df["affinity_score"][r]
                alt_aff = results_df["affinity_score"][a]
                delta_p = (ref_pattn - alt_pattn
                           if len(ref_pattn) == len(alt_pattn) else np.nan)
                rows.append({
                    "variant_id": var_id, "molecule_id": mol_id,
                    "variant_code": code,
                    "molecule_smiles": smiles,
                    "ref_id": ref_id, "alt_id": alt_id,
                    "ref_affinity": ref_aff,
                    "alt_affinity": alt_aff,
                    "delta_affinity": alt_aff - ref_aff,
                    f"ref_prot_{attn_type}": ref_pattn,
                    f"alt_prot_{attn_type}": alt_pattn,
                    f"delta_prot_{attn_type}": delta_p,
                    f"ref_mol_{attn_type}": ref_mattn,
                    f"alt_mol_{attn_type}": alt_mattn,
                    f"delta_mol_{attn_type}": alt_mattn - ref_mattn,
                    "ref_file": results_df["protein_file"][r],
                    "alt_file": results_df["protein_file"][a],
                    "ref_len": len(ref_pattn), "alt_len": len(alt_pattn),
                    "ref_seq": ref_seq, "alt_seq": alt_seq,
                })
    return {k: [row[k] for row in rows] for k in rows[0]} if rows else {}


def run_dta_variation(model_folder: str, test_variants: dict,
                      test_drugs: dict, results_dir: str, base_data_dir: str,
                      test_sequence_pairs: dict | None = None,
                      max_batch_size: int = 8, n_workers=0, device="cuda"):
    """-> (records of every protein x drug pair, records of the ref/alt
    deltas), pickled as ``pgx_raw_records.pkl`` and ``pgx_delta_records.pkl``
    in ``results_dir``. The model runs on ``device``."""
    os.makedirs(results_dir, exist_ok=True)
    pdb_dir = os.path.join(base_data_dir, "pdb_files")
    other_dir = os.path.join(base_data_dir, "other_data")
    os.makedirs(pdb_dir, exist_ok=True)
    os.makedirs(other_dir, exist_ok=True)
    test_sequence_pairs = test_sequence_pairs or {}

    if not isinstance(test_variants, dict):
        test_variants = {x: x for x in test_variants}
    if not isinstance(test_drugs, dict):
        test_drugs = {x: x for x in test_drugs}

    var_protid_map, protid_seq_map = variant_to_protein_seq(
        test_variants, other_dir, force_requery=False)
    for k, v in test_sequence_pairs.items():
        ref_id = hashlib.sha256(v["ref_seq"].encode()).hexdigest()
        alt_id = hashlib.sha256(v["alt_seq"].encode()).hexdigest()
        protid_seq_map[ref_id] = v["ref_seq"]
        protid_seq_map[alt_id] = v["alt_seq"]
        var_protid_map[k] = {"ref_id": [ref_id], "alt_id": [alt_id]}

    prot_df = {"id": list(protid_seq_map.keys()), "seq": list(protid_seq_map.values()),
               "file": [os.path.join(pdb_dir, f"{x}.pdb") for x in protid_seq_map]}
    prot_df = acquire_pdbs(prot_df, pdb_dir, require_completeness=False)

    drug_df = {"molecule_id": list(test_drugs.keys()),
               "molecule_smiles": list(test_drugs.values())}
    combined = tables.merge(tables.rename(prot_df, {"id": "protein_id",
                                                    "seq": "protein_sequence",
                                                    "file": "protein_file"}),
                            drug_df, how="cross")
    combined["affinity_score"] = [0.0] * tables.n_rows(combined)
    combined = tables.sort_by(combined, ["protein_id", "molecule_id"])

    model, _, _ = load_model_from_checkpoint(model_folder, device=device)
    dataset = create_dataset_with_checkpoint_params(combined, model_folder,
                                                    cache_dir=other_dir, n_workers=n_workers)
    parsed = run_model_on_dataset(model, dataset, max_batch_size=max_batch_size)
    results = tables.merge({k: v for k, v in combined.items() if k != "affinity_score"},
                           parsed, on=["protein_id", "molecule_id"], how="left")
    with open(os.path.join(results_dir, "pgx_raw_records.pkl"), "wb") as f:
        pickle.dump(results, f)

    all_variants = {k: "manual" for k in test_sequence_pairs}
    all_variants.update(test_variants)
    vd_df = tables.merge({"variant_id": list(all_variants.keys()),
                          "variant_code": list(all_variants.values())},
                         {"molecule_id": list(test_drugs.keys()),
                          "molecule_smiles": list(test_drugs.values())}, how="cross")

    deltas = compute_refalt_deltas(results, var_protid_map, protid_seq_map, vd_df,
                                   "attention")
    deltas_expl = compute_refalt_deltas(results, var_protid_map, protid_seq_map, vd_df,
                                        "explanation")
    if deltas:
        # the explanation columns the attention rows lack, in sorted order
        # (pandas' Index.difference), then whether the variant names the drug
        for k in sorted(set(deltas_expl) - set(deltas)):
            deltas[k] = deltas_expl[k]
        deltas["match_drug"] = [m.lower() in v.lower() for m, v in
                                zip(deltas["molecule_id"], deltas["variant_id"])]
    with open(os.path.join(results_dir, "pgx_delta_records.pkl"), "wb") as f:
        pickle.dump(deltas, f)
    return results, deltas
