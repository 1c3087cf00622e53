"""BioLIP binding-site recovery task (counterpart of caster_dta_tpu/
analysis/biolip.py).

Behavioral spec: reference test_biolip_binding.py: load the BioLIP
non-redundant table + ligand table, SMILES validation (single fragment),
model-vocabulary sanity filters, AF2-by-UniProt structure lookup, cross-merge
to protein-ligand pairs, batched model evaluation with attention and
explanations, pickled raw results. Tables are records read as pandas reads
them (data/tables.py: its NA strings, so the CCD code ``NA``, sodium, is NaN
and dropped as in the JAX package), and the results are pickled records.
"""
from __future__ import annotations

import hashlib
import os
import pickle

from caster_dta_torch.analysis import common
from caster_dta_torch.data import tables
from caster_dta_torch.inference.checkpoint import (
    create_dataset_with_checkpoint_params, load_model_from_checkpoint)
from caster_dta_torch.inference.evaluation import run_model_on_dataset
from caster_dta_torch.inference.structures import get_af2_from_uniprot_accession


def load_biolip_tables(biolip_file: str, biolip_ligand_file: str):
    """BioLiP_nr.txt(.gz) + ligand.tsv(.gz) -> (protein rows: #CCD,
    binding_residues, protein_id, seq; ligand rows: id, smiles, name)
    (reference test_biolip_binding.py:39-120)."""
    biolip_df = tables.read_csv(biolip_file, sep="\t", header=False)
    lig_df = tables.read_csv(biolip_ligand_file, sep="\t", on_bad_lines="skip")

    # the first of "; "-separated SMILES; NaN and then empty ones dropped
    smiles = [s if tables.is_na(s) else s.split("; ")[0] for s in lig_df["SMILES"]]
    lig_df = {"id": lig_df["#CCD"], "smiles": smiles, "name": lig_df["name"]}
    lig_df = tables.where(lig_df, [not tables.is_na(s) and s != "" for s in smiles])
    lig_df = tables.where(lig_df, [common.validate_smiles_strict(s) for s in lig_df["smiles"]])

    # columns: 4=#CCD, 8=binding residues, 17=uniprot, 20=sequence
    prot_df = {"#CCD": biolip_df[4], "binding_residues": biolip_df[8],
               "protein_id": biolip_df[17], "seq": biolip_df[20]}
    prot_df = tables.dropna(prot_df, "protein_id")
    prot_df["protein_id"] = [p.split(",")[0] for p in prot_df["protein_id"]]
    return prot_df, lig_df


def biolip_pairs(biolip_file: str, biolip_ligand_file: str, base_data_dir: str,
                 model_kwargs: dict, do_api: bool = False) -> dict:
    """The protein-ligand pairs the task evaluates, as records: the tables
    (``load_biolip_tables``) through the model's vocabulary filters, merged
    on the CCD code, every row with a missing cell dropped, the AlphaFold
    structure of each UniProt id (``base_data_dir/pdb_files``), sorted by
    protein and ligand, the protein id suffixed with its sequence's md5, and
    every copy of a repeated pair dropped."""
    pdb_dir = os.path.join(base_data_dir, "pdb_files")
    prot_df, drug_df = load_biolip_tables(biolip_file, biolip_ligand_file)
    prot_df, drug_df = common.apply_vocab_sanity_filters(
        prot_df, drug_df, model_kwargs, seq_col="seq", smiles_col="smiles")

    prot_df = tables.rename(prot_df, {"seq": "protein_sequence", "#CCD": "molecule_id"})
    drug_df = tables.rename(drug_df, {"id": "molecule_id", "smiles": "molecule_smiles",
                                      "name": "molecule_name"})
    combined = tables.merge(prot_df, drug_df, on="molecule_id", how="inner")
    combined["affinity_score"] = [0.0] * tables.n_rows(combined)
    combined = tables.dropna(combined)

    # AF2-by-UniProt structure acquisition (predownloaded or API)
    base = tables.drop_duplicates(tables.select(combined, ["protein_id", "protein_sequence"]),
                                  "protein_id")
    base = tables.rename(base, {"protein_id": "id", "protein_sequence": "seq"})
    base["file"] = [os.path.join(pdb_dir, f"{x}.pdb") for x in base["id"]]
    base = tables.sort_by(tables.dropna(base), ["id", "seq"])
    success = get_af2_from_uniprot_accession(
        base, local_predownload=os.path.join(base_data_dir, "predownloaded_AF_preds"),
        do_api=do_api)

    combined = tables.merge(combined, success, left_on=["protein_id", "protein_sequence"],
                            right_on=["id", "seq"], how="inner")
    del combined["id"], combined["seq"]
    combined = tables.rename(combined, {"file": "protein_file"})
    combined = tables.sort_by(combined, ["protein_id", "molecule_id"])
    combined["protein_id"] = [f"{p}__{hashlib.md5(s.encode()).hexdigest()}" for p, s in
                              zip(combined["protein_id"], combined["protein_sequence"])]
    return tables.drop_duplicates(combined, ["protein_id", "molecule_id"], keep=False)


def run_biolip_binding(model_folder: str, biolip_file: str,
                       biolip_ligand_file: str, results_dir: str,
                       base_data_dir: str, max_batch_size: int = 16,
                       do_api: bool = False, n_workers=0, device="cuda") -> dict:
    """-> the pairs' records (``biolip_pairs``' columns but the affinity, then
    run_model_on_dataset's), also pickled as ``biolip_raw_records.pkl`` in
    ``results_dir``. The model runs on ``device``."""
    os.makedirs(results_dir, exist_ok=True)
    other_dir = os.path.join(base_data_dir, "other_data")
    os.makedirs(os.path.join(base_data_dir, "pdb_files"), exist_ok=True)
    os.makedirs(other_dir, exist_ok=True)

    # One load gives the vocabulary sizes for the filters and the model that
    # evaluates the pairs: the answers do not depend on how often it is read.
    model, _, model_kwargs = load_model_from_checkpoint(model_folder, device=device)
    combined = biolip_pairs(biolip_file, biolip_ligand_file, base_data_dir, model_kwargs,
                            do_api)
    dataset = create_dataset_with_checkpoint_params(combined, model_folder,
                                                    cache_dir=other_dir, n_workers=n_workers)
    parsed = run_model_on_dataset(model, dataset, max_batch_size=max_batch_size)
    results = tables.merge({k: v for k, v in combined.items() if k != "affinity_score"},
                           parsed, on=["protein_id", "molecule_id"], how="left")
    with open(os.path.join(results_dir, "biolip_raw_records.pkl"), "wb") as f:
        pickle.dump(results, f)
    return results
