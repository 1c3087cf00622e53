"""Inference-time structure acquisition (counterpart of caster_dta_tpu/
inference/structures.py).

Behavioral spec: reference inference/download_utils.py: ``acquire_pdbs``
(search + download + optional AF2 folding, subsetting the protein table to
structures that exist) and ``get_af2_from_uniprot_accession`` (AlphaFoldDB
API or local predownloaded AF-<acc>-F1 files, subset to the residues from
the requested sequence on; a failed lookup leaves a ``*_failed.txt`` flag so
that reruns skip it). Protein tables are records with the columns id, seq
and file. The AlphaFoldDB API goes through the ``_get`` seam on
``urllib.request``.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import urllib.error
import urllib.request

from caster_dta_torch.data import tables
from caster_dta_torch.data.acquire import create_comp_models, download_pdb_files
from caster_dta_torch.data.featurize import definitions as defs

AF2_API = "https://alphafold.ebi.ac.uk/api/prediction/"


def _get(url: str, timeout: int = 10):
    """-> (HTTP status, body bytes) of a GET; an error status is returned,
    not raised."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def acquire_pdbs(prot_df: dict, pdb_data_dir: str,
                 verbose_print: bool = False, do_comp_folds: bool = True,
                 require_completeness: bool = False) -> dict:
    """Download + optionally fold; subset to proteins with structure files
    (reference download_utils.py:14-60). A file counts as present when its
    path string is one that ``glob`` gives for ``pdb_data_dir``, so a path
    spelled another way counts as missing, as in the JAX package."""
    download_pdb_files(prot_df["id"], prot_df["seq"], prot_df["file"],
                       overwrite=False, verbose_pdb_dl=verbose_print)
    if do_comp_folds:
        have = glob.glob(os.path.join(pdb_data_dir, "*.pdb"))
        missing = tables.where(prot_df, [f not in have for f in prot_df["file"]])
        if tables.n_rows(missing):
            create_comp_models(missing["id"], missing["seq"], missing["file"],
                               verbose_comp_fold=verbose_print)
    have_ids = [os.path.basename(x).replace(".pdb", "")
                for x in glob.glob(os.path.join(pdb_data_dir, "*.pdb"))]
    keep = [i in have_ids for i in prot_df["id"]]
    if not all(keep):
        if require_completeness:
            raise ValueError("Some proteins are still missing structures and "
                             "require_completeness is set")
        prot_df = tables.where(prot_df, keep)
    return prot_df


def _pdb_sequence_and_residue_keys(pdb_text: str):
    """Per-residue (1-letter, residue key) in file order from ATOM records."""
    seq, keys, seen = [], [], set()
    for line in pdb_text.splitlines():
        if line[:6] not in ("ATOM  ", "HETATM"):
            continue
        if line[12:16].strip() != "CA":
            continue
        key = (line[21], line[22:26].strip(), line[26].strip())
        if key in seen:
            continue
        seen.add(key)
        seq.append(defs.PROTEIN_3LETTER_1LETTER_MAP[line[17:20].strip()])
        keys.append(key)
    return "".join(seq), keys


def _subset_pdb_from_residue(pdb_text: str, keep_keys: set) -> str:
    out = []
    for line in pdb_text.splitlines():
        if line[:6] in ("ATOM  ", "HETATM", "TER   "):
            key = (line[21], line[22:26].strip(), line[26].strip())
            if key not in keep_keys:
                continue
        out.append(line)
    return "\n".join(out) + "\n"


def get_af2_from_uniprot_accession(df: dict,
                                   local_predownload="./data/predownloaded_AF_preds",
                                   do_api: bool = True) -> dict:
    """AF2 structures by UniProt accession, subset to the requested sequence
    (reference download_utils.py:66-183). -> the rows with a structure, in
    their order."""
    successful_rows = []
    for idx, (accession, sequence, out_file) in enumerate(zip(df["id"], df["seq"],
                                                              df["file"])):
        split_dir, split_base = os.path.split(out_file)
        tmp_outfile = os.path.join(split_dir, f"tmp_{split_base}")
        failed_file = out_file.replace(".pdb", "_failed.txt")

        if os.path.exists(out_file):
            successful_rows.append(idx)
            continue
        if os.path.exists(failed_file):
            continue

        success = True
        predl = os.path.join(local_predownload, f"AF-{accession}-F1-model_v4.pdb.gz")
        if os.path.exists(predl):
            with gzip.open(predl, "rb") as f_in, open(tmp_outfile, "wb") as f_out:
                shutil.copyfileobj(f_in, f_out)
        elif do_api:
            try:
                status, body = _get(AF2_API + accession)
                result = json.loads(body) if status == 200 else []
                if not result:
                    success = False
                else:
                    _, content = _get(result[0]["pdbUrl"])
                    with open(tmp_outfile, "wb") as f:
                        f.write(content)
            except Exception:
                success = False
        else:
            continue  # no flag file when the API is off (reference :128-131)

        sub_text = None
        if success:
            with open(tmp_outfile) as f:
                pdb_text = f.read()
            md_seq, keys = _pdb_sequence_and_residue_keys(pdb_text)
            offset = md_seq.find(sequence)
            if offset == -1:
                success = False
            else:
                sub_text = _subset_pdb_from_residue(pdb_text, set(keys[offset:]))

        if success and sub_text is not None:
            with open(out_file, "w") as f:
                f.write(sub_text)
            successful_rows.append(idx)
        else:
            with open(failed_file, "w") as f:
                f.write("Failed to download and acquire sequence as requested "
                        "from AF2 API or from local copy")
        if os.path.isfile(tmp_outfile):
            os.remove(tmp_outfile)
    return tables.take(df, successful_rows)
