"""Structure acquisition: RCSB search/download, AlphaFold2/ESMFold folding
(counterpart of caster_dta_tpu/data/acquire.py).

Behavioral spec: reference dataset/process_data.py. RCSB sequence search
(identity >= 0.9, human organism, no-ligand/monomer attribute filters) with
100%-identity + length-match result checking, best-structure selection
(experimental by modeled-residue count then resolution; computational by AF2
pLDDT), download with mmCIF fallback (the port's PDB parser reads mmCIF
natively), per-protein search-record/accession sidecar files for
resumability, the ColabFold (AF2) container subprocess with retry + tmp wipe
and content-hash dedup, and the ESMFold API / local-ESMFold paths, each
gated as in the JAX package.

HTTP goes through two seams, ``_http_get`` and ``_http_post_json``, on
``urllib.request``: the port needs no HTTP package. ``process_data`` returns
records and writes its two CSVs with the ``csv`` module, byte for byte what
the JAX package's pandas writes (data/tables.py).
"""
from __future__ import annotations

import datetime
import glob
import hashlib
import json
import os
import re
import shlex
import shutil
import subprocess
import urllib.request

import numpy as np

from caster_dta_torch.data import tables

RCSB_SEARCH_URL = "https://search.rcsb.org/rcsbsearch/v2/query"
RCSB_DATA_URL = "https://data.rcsb.org/rest/v1/core/entry/{entry_id}"
RCSB_FILES_URL = "https://files.rcsb.org/download/{entry_id}.{ext}"
ESMFOLD_API = "https://api.esmatlas.com/foldSequence/v1/pdb/"

COLUMNS = ("protein_id", "protein_sequence", "protein_file", "molecule_id",
           "molecule_smiles", "affinity_score")


class HTTPResponse:
    """The body of an answered request: ``content`` (bytes) and ``json()``."""

    def __init__(self, content: bytes):
        self.content = content

    def json(self):
        return json.loads(self.content)


def _http_get(url, **kw):
    """GET ``url``; an HTTP error status raises (urllib's HTTPError)."""
    req = urllib.request.Request(url, headers=kw.pop("headers", {}))
    with urllib.request.urlopen(req, timeout=kw.pop("timeout", 60)) as r:
        return HTTPResponse(r.read())


def _http_post_json(url, payload, timeout=60):
    """POST ``payload`` as JSON; the decoded JSON answer ({} when empty)."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        content = r.read()
    return json.loads(content) if content else {}


def _now() -> str:
    """The sidecars' date stamp, as ``str(pandas.Timestamp.now())`` gives it."""
    return str(datetime.datetime.now())


# ---------------------------------------------------------------------------
# RCSB search (reference process_data.py:479-555)
# ---------------------------------------------------------------------------

def _attr_node(attribute, operator, value):
    return {"type": "terminal", "service": "text",
            "parameters": {"attribute": attribute, "operator": operator,
                           "value": value}}


def _seq_node(sequence, evalue=1.0, identity=0.9):
    return {"type": "terminal", "service": "sequence",
            "parameters": {"evalue_cutoff": evalue,
                           "identity_cutoff": identity,
                           "sequence_type": "protein", "value": sequence}}


def _group(op, nodes):
    return {"type": "group", "logical_operator": op, "nodes": nodes}


def get_rcsb_res(prot_seq: str, query_type: str = "experimental",
                 allow_complex: bool = False):
    """Search RCSB for structures of a sequence; verbose result rows
    (reference process_data.py:479-555 query structure). A failed request
    gives no rows."""
    seq_q = _seq_node(prot_seq)
    max_unmodeled = int(np.floor(0.2 * len(prot_seq)))
    unmodeled = _attr_node("rcsb_assembly_info.unmodeled_polymer_monomer_count",
                           "less_or_equal", max_unmodeled)
    human = _attr_node("rcsb_entity_source_organism.common_name",
                       "contains_words", "human")
    homosap = _attr_node("rcsb_entity_source_organism.taxonomy_lineage.name",
                         "exact_match", "Homo sapiens")
    no_ligand = _attr_node("rcsb_entry_info.deposited_nonpolymer_entity_instance_count",
                           "equals", 0)
    sole = _attr_node("rcsb_entry_info.deposited_polymer_entity_instance_count",
                      "equals", 1)
    monomer = _attr_node("rcsb_assembly_info.polymer_entity_instance_count",
                         "equals", 1)
    protein_only = _attr_node("rcsb_entry_info.selected_polymer_entity_types",
                              "exact_match", "Protein (only)")

    base = _group("and", [seq_q, _group("or", [human, homosap])])
    if query_type == "experimental":
        if allow_complex:
            query = _group("and", [base, sole, monomer, unmodeled])
        else:
            query = _group("and", [seq_q, no_ligand, protein_only])
        content = ["experimental"]
    else:
        query = seq_q
        content = ["computational"]

    payload = {
        "query": query,
        "return_type": "polymer_entity",
        "request_options": {
            "results_content_type": content,
            "results_verbosity": "verbose",
            "paginate": {"start": 0, "rows": 100},
        },
    }
    try:
        data = _http_post_json(RCSB_SEARCH_URL, payload)
    except Exception:
        return []
    return data.get("result_set", [])


def check_pdb_result(rcsb_res_list, res_type="experimental"):
    """100% identity + perfect length match + score 1.0
    (reference process_data.py:430-476)."""
    good = []
    for res in rcsb_res_list:
        seq_nodes = None
        for svc in res.get("services", []):
            if svc.get("service_type") == "sequence":
                seq_nodes = svc.get("nodes")
        if not seq_nodes:
            continue
        try:
            ctx = seq_nodes[0]["match_context"][0]
            if (ctx["sequence_identity"] == 1.0 and res.get("score") == 1.0
                    and ctx["query_length"] == ctx["subject_length"]):
                good.append(res["identifier"])
        except (KeyError, IndexError):
            continue
    return good


def _entry_json(entry_id):
    return _http_get(RCSB_DATA_URL.format(entry_id=entry_id)).json()


def _select_computational_pdb(pdb_list):
    """AlphaFoldDB entries ranked by pLDDT (reference :345-377)."""
    best_plddt, best = -float("inf"), None
    for pdb_id in pdb_list:
        entry_id, _ = pdb_id.rsplit("_", 1)
        try:
            j = _entry_json(entry_id)
            if j["rcsb_comp_model_provenance"]["source_db"] != "AlphaFoldDB":
                continue
            plddt = j["rcsb_ma_qa_metric_global"][0]["ma_qa_metric_global"][0]["value"]
        except Exception:
            continue
        if plddt > best_plddt:
            best_plddt, best = plddt, pdb_id
    return best


def _select_experimental_pdb(pdb_list):
    """Modeled-residue count desc, then resolution asc (reference :380-426)."""
    best, best_modeled, best_reso = None, -float("inf"), float("inf")
    for pdb_id in pdb_list:
        entry_id, _ = pdb_id.rsplit("_", 1)
        try:
            j = _entry_json(entry_id)
            modeled = j["rcsb_entry_info"]["deposited_modeled_polymer_monomer_count"]
        except Exception:
            continue
        try:
            reso = max(j["rcsb_entry_info"]["resolution_combined"])
        except Exception:
            reso = float("inf")
        if modeled > best_modeled or (modeled == best_modeled and reso < best_reso):
            best, best_modeled, best_reso = pdb_id, modeled, reso
    return best


def _select_and_download_pdb(pdb_list, out_path, result_ver="experimental",
                             also_save_accession=True):
    """Pick + download (reference :251-342). mmCIF downloads are written to
    out_path directly: the port's parser reads mmCIF, so no conversion."""
    if len(pdb_list) == 1:
        pdb_base = pdb_list[0]
    elif result_ver == "computational":
        pdb_base = _select_computational_pdb(pdb_list)
    else:
        pdb_base = _select_experimental_pdb(pdb_list)
    if pdb_base is None:
        return None

    entry_id, _ = pdb_base.rsplit("_", 1)
    try:
        if result_ver == "computational":
            j = _entry_json(entry_id)
            url = j["rcsb_comp_model_provenance"]["source_url"]
            url = url.replace(".cif.gz", ".pdb").replace(".cif", ".pdb")
            content = _http_get(url).content
        else:
            try:
                content = _http_get(RCSB_FILES_URL.format(
                    entry_id=entry_id, ext="pdb")).content
            except Exception:
                content = _http_get(RCSB_FILES_URL.format(
                    entry_id=entry_id, ext="cif")).content
    except Exception:
        return None
    with open(out_path, "wb") as f:
        f.write(content)
    if also_save_accession:
        with open(out_path.replace(".pdb", "_accession.txt"), "w") as f:
            f.write(f"Downloaded from PDB with accession: {pdb_base}")
    return pdb_base


def download_pdb_files(prot_ids, prot_seqs, out_paths, known_pdb_ids=None,
                       overwrite=True, allow_complexed_pdb=False,
                       verbose_pdb_dl=False):
    """Batch download with search-record sidecars for resumability
    (reference :146-248). -> the ids whose structure is on disk."""
    log = print if verbose_pdb_dl else (lambda *a, **k: None)
    successes = []
    if known_pdb_ids is not None:
        for prot_id, pdb_id, out_path in zip(prot_ids, known_pdb_ids, out_paths):
            record = out_path.replace(".pdb", "_search_record.txt")
            if os.path.exists(out_path) and not overwrite:
                successes.append(prot_id)
                continue
            if os.path.exists(record) and not overwrite:
                continue
            _select_and_download_pdb([pdb_id + "_1"], out_path)
            with open(record, "w") as f:
                f.write(f"Search options: {pdb_id}_1\nDate: {_now()}")
        return successes

    for prot_id, prot_seq, out_path in zip(prot_ids, prot_seqs, out_paths):
        record = out_path.replace(".pdb", "_search_record.txt")
        if os.path.exists(out_path) and not overwrite:
            successes.append(prot_id)
            continue
        if os.path.exists(record) and not overwrite:
            continue
        log(f"Downloading PDB file for protein {prot_id}...")
        prot_ver = None
        acceptable = check_pdb_result(
            get_rcsb_res(prot_seq, "experimental", allow_complexed_pdb),
            "experimental")
        if acceptable:
            prot_ver = "experimental"
        else:
            acceptable = check_pdb_result(
                get_rcsb_res(prot_seq, "computational", allow_complexed_pdb),
                "computational")
            if acceptable:
                prot_ver = "computational"
        chosen = (_select_and_download_pdb(acceptable, out_path, prot_ver)
                  if acceptable else None)
        if chosen is not None:
            successes.append(prot_id)
        with open(record, "w") as f:
            f.write(f"Search options: {acceptable}\nChosen: {chosen}\n"
                    f"Sequence: {prot_seq}\nDate: {_now()}")
    return successes


# ---------------------------------------------------------------------------
# Computational folding (reference process_data.py:558-778)
# ---------------------------------------------------------------------------

def _run_af2(prot_seq, out_path, colabfold_dir="./ext-packages/colabfold",
             is_retry=False):
    """ColabFold container subprocess: 5 models, 3 recycles, stop-at-85,
    amber relax; retry wipes the tmp dir (reference :660-750)."""
    def _search(in_dir):
        hits = glob.glob(os.path.join(in_dir, "*_relaxed_rank_001*.pdb")) or \
            glob.glob(os.path.join(in_dir, "*rank_001*.pdb"))
        return sorted(hits)[0] if hits else None

    prot_id = hashlib.sha256(prot_seq.encode()).hexdigest()
    tmp_dir = f"{colabfold_dir}/tmp/{prot_id}"
    os.makedirs(tmp_dir, exist_ok=True)
    result = _search(tmp_dir)
    if result is not None:
        shutil.copy2(result, out_path)
        return True
    if is_retry:
        shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir, exist_ok=True)
    fa = os.path.join(tmp_dir, f"{prot_id}_fasta.fa")
    with open(fa, "w") as f:
        f.write(f">{prot_id}\n{prot_seq}")
    cmd = (f"singularity run --nv -B {colabfold_dir}/cache:/cache -B ./:/work "
           f"-B {tmp_dir}:/output/ {colabfold_dir}/colabfold.sif "
           f"colabfold_batch /work/{fa} /output/ --num-models 5 "
           f"--num-recycle 3 --stop-at-score 85 --random-seed 9 --templates "
           f"--amber --num-relax 1 --relax-max-iterations 2000")
    subprocess.run(shlex.split(cmd), stdout=subprocess.DEVNULL,
                   stderr=subprocess.STDOUT)
    result = _search(tmp_dir)
    if result is not None:
        shutil.copy2(result, out_path)
        return True
    return False


def _run_esmfold_api(prot_seq, out_path):
    req = urllib.request.Request(
        ESMFOLD_API, data=prot_seq.encode(), method="POST",
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    with urllib.request.urlopen(req, timeout=300) as r:
        content = r.read()
    with open(out_path, "wb") as f:
        f.write(content)
    return True


def _run_esmfold_local(prot_seq, out_path):
    """Local ESMFold via the transformers stack (reference's torch.hub path,
    :753-778); gated on its availability."""
    try:
        import torch
        from transformers import AutoTokenizer, EsmForProteinFolding
    except ImportError:
        return False
    try:
        tok = AutoTokenizer.from_pretrained("facebook/esmfold_v1")
        model = EsmForProteinFolding.from_pretrained("facebook/esmfold_v1")
        model.eval()
        with torch.no_grad():
            inputs = tok([prot_seq], return_tensors="pt", add_special_tokens=False)
            pdb_str = model.infer_pdbs(**inputs)[0] if hasattr(model, "infer_pdbs") \
                else model.infer_pdb(prot_seq)
        with open(out_path, "w") as f:
            f.write(pdb_str)
        return True
    except Exception:
        return False


def create_comp_models(prot_ids, prot_seqs, out_paths, overwrite=True,
                       model_types=("af2",), also_save_accession=True,
                       verbose_comp_fold=False,
                       colabfold_dir="./ext-packages/colabfold"):
    """Fold missing structures (reference :558-657): ESMFold API for <=400
    residues when enabled, AF2 (ColabFold) otherwise, with one retry."""
    successes, models_used = [], []
    for prot_id, prot_seq, out_path in zip(prot_ids, prot_seqs, out_paths):
        if os.path.exists(out_path) and not overwrite:
            successes.append(prot_id)
            models_used.append("NA")
            continue
        used = None
        if "esm" in model_types:
            try:
                if len(prot_seq) <= 400:
                    _run_esmfold_api(prot_seq, out_path)
                    used = "ESMFold_API"
                elif _run_esmfold_local(prot_seq, out_path):
                    used = "ESMFold_v1_Local"
            except Exception:
                used = None
        elif "af2" in model_types:
            ok = _run_af2(prot_seq, out_path, colabfold_dir, is_retry=False)
            if not ok:
                ok = _run_af2(prot_seq, out_path, colabfold_dir, is_retry=True)
            if ok:
                used = "AlphaFold2"
        if used:
            successes.append(prot_id)
            models_used.append(used)
            if also_save_accession:
                with open(out_path.replace(".pdb", "_accession.txt"), "w") as f:
                    f.write(f"{used} with sequence of {len(prot_seq)} residues: "
                            f"\n{prot_seq}")
    return successes, models_used


# ---------------------------------------------------------------------------
# Orchestration (reference process_data.py:18-143)
# ---------------------------------------------------------------------------

def process_data(proteins, ligands, affinity=None,
                 data_path="./data/deepdta_data/davis", known_pdb_ids=None,
                 pdb_dir_name="pdb_files", overwrite_csv=True,
                 skip_pdb_dl=False, overwrite_pdb=False,
                 allow_complexed_pdb=False, create_comp=False,
                 reverse_comp_fold_order=False, verbose_pdb_dl=False,
                 verbose_comp_fold=False) -> dict:
    """Build the canonical rows (``affinity[mol][prot]``, NaN pairs left
    out), download/fold structures, drop proteins that are still missing
    files. Writes ``processed_data_full.csv`` (read back instead when it
    exists and ``overwrite_csv`` is off) and ``<pdb_dir>/processed_data.csv``;
    -> the kept rows as records."""
    if affinity is None:
        affinity = np.full((len(ligands), len(proteins)), -9999.0)
    pdb_dir = os.path.join(data_path, pdb_dir_name)
    os.makedirs(pdb_dir, exist_ok=True)

    csv_fpath = os.path.join(data_path, "processed_data_full.csv")
    if os.path.exists(csv_fpath) and not overwrite_csv:
        full_data = tables.read_csv(csv_fpath)
    else:
        rows = []
        for prot_i, (prot_id, prot_seq) in enumerate(proteins.items()):
            for mol_i, (mol_id, mol_smiles) in enumerate(ligands.items()):
                score = affinity[mol_i][prot_i]
                if tables.is_na(score):
                    continue
                clean = re.sub(r"[^0-9a-zA-Z\-]", "_", str(prot_id))
                rows.append((prot_id, prot_seq, os.path.join(pdb_dir, f"{clean}.pdb"),
                             mol_id, mol_smiles, score))
        full_data = {c: [r[i] for r in rows] for i, c in enumerate(COLUMNS)}
        tables.write_csv(full_data, csv_fpath)

    prot_cols = ["protein_id", "protein_sequence", "protein_file"]
    uniq = tables.select(tables.drop_duplicates(full_data, prot_cols), prot_cols)

    if not skip_pdb_dl:
        download_pdb_files(uniq["protein_id"], uniq["protein_sequence"],
                           uniq["protein_file"], known_pdb_ids=known_pdb_ids,
                           overwrite=overwrite_pdb,
                           allow_complexed_pdb=allow_complexed_pdb,
                           verbose_pdb_dl=verbose_pdb_dl)

    have = set(glob.glob(os.path.join(pdb_dir, "*.pdb")))
    missing = tables.where(uniq, [f not in have for f in uniq["protein_file"]])
    if create_comp and tables.n_rows(missing):
        if reverse_comp_fold_order:
            missing = tables.take(missing, reversed(range(tables.n_rows(missing))))
        create_comp_models(missing["protein_id"], missing["protein_sequence"],
                           missing["protein_file"], overwrite=overwrite_pdb,
                           verbose_comp_fold=verbose_comp_fold)
        have = set(glob.glob(os.path.join(pdb_dir, "*.pdb")))
        missing = tables.where(uniq, [f not in have for f in uniq["protein_file"]])

    gone = set(missing["protein_id"])
    processed = tables.where(full_data, [p not in gone for p in full_data["protein_id"]])
    tables.write_csv(processed, os.path.join(pdb_dir, "processed_data.csv"))
    return processed
