"""Dataset registry: davis, kiba, metz, bindingdb[_kd/ki/ic50/ec50], belka,
plinder (its cached CSV, data/plinder.py) and synthetic -> the canonical six
columns as records (counterpart of caster_dta_tpu/data/datasets.py).

Behavioral spec: reference dataset/load_data.py:28-389. The JAX package
returns a pandas DataFrame; the port returns records, a dict of the columns
protein_id, protein_sequence, protein_file, molecule_id, molecule_smiles,
affinity_score (+ optional 'split'), one list per column, with the same rows
in the same order. Tables are read with the ``csv`` module, BELKA's parquet
with pyarrow where it is installed. Loaders accept a structures_dir of
pre-downloaded PDB files and drop proteins whose structure is missing
(mirroring process_data.py:133-143). The parse caches the loaders keep beside
their inputs are the port's own files (``*_records.pkl``), never the JAX
package's pandas pickles.
"""
from __future__ import annotations

import csv
import hashlib
import json
import os
import pickle
from collections import Counter, OrderedDict
from typing import Optional

import numpy as np

from caster_dta_torch.data import tables
from caster_dta_torch.data.featurize.smiles import validate_smiles

COLUMNS = ("protein_id", "protein_sequence", "protein_file", "molecule_id",
           "molecule_smiles", "affinity_score")


def drop_duplicate_pairs(records: dict) -> dict:
    """Keep the first row of each (protein_id, molecule_id) pair."""
    return tables.drop_duplicates(records, ["protein_id", "molecule_id"])


def _affinity_to_records(proteins: "OrderedDict", ligands: "OrderedDict",
                         affinity: np.ndarray, structures_dir: Optional[str],
                         skip_missing_structures: bool = True) -> dict:
    """(proteins, ligands, ligand×protein affinity matrix) -> canonical rows
    (reference process_data.py:55-78 builds the same full_data frame)."""
    prot_ids = list(proteins.keys())
    lig_ids = list(ligands.keys())
    affinity = np.asarray(affinity, dtype=np.float64)
    lig_idx, prot_idx = np.nonzero(~np.isnan(affinity))
    rows = []
    for li, pi in zip(lig_idx, prot_idx):
        pid, mid = prot_ids[pi], lig_ids[li]
        pfile = os.path.join(structures_dir, f"{pid}.pdb") if structures_dir else ""
        if structures_dir and skip_missing_structures and not os.path.exists(pfile):
            continue
        rows.append((pid, proteins[pid], pfile, mid, ligands[mid], float(affinity[li, pi])))
    return {c: [r[i] for r in rows] for i, c in enumerate(COLUMNS)}


def load_davis_kiba(name: str, data_root: str, structures_dir=None):
    """DeepDTA-format davis/kiba (reference load_data.py:86-91). The Davis Y
    matrix is Kd in nM; the standard transform is -log10(Kd/1e9) (the vendored
    Y file is already transformed)."""
    path = os.path.join(data_root, name)
    with open(os.path.join(path, "proteins.txt")) as f:
        proteins = json.load(f, object_pairs_hook=OrderedDict)
    with open(os.path.join(path, "ligands_iso.txt")) as f:
        ligands = json.load(f, object_pairs_hook=OrderedDict)
    with open(os.path.join(path, "Y"), "rb") as f:
        affinity = pickle.load(f, encoding="latin1")
    return _affinity_to_records(proteins, ligands, np.asarray(affinity), structures_dir)


def _read_table(path: str, delimiter: str = ",") -> tuple:
    """(header, rows) of a delimited text file; a row with more fields than
    the header is skipped, a shorter one padded with empty cells (pandas'
    ``on_bad_lines='skip'``)."""
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter=delimiter)
        header = next(reader)
        rows = []
        for row in reader:
            if not row or len(row) > len(header):
                continue
            rows.append(row + [""] * (len(header) - len(row)))
    return header, rows


def _number(cell: str) -> float:
    """A cell as pandas' ``to_numeric(errors='coerce')`` reads it: NaN when
    empty or not a number."""
    try:
        return float(cell)
    except ValueError:
        return float("nan")


def load_metz(data_root: str, structures_dir=None):
    """Metz interaction CSVs (reference load_data.py:94-129)."""
    path = os.path.join(data_root, "metz")
    header, inter = _read_table(os.path.join(path, "Metz_interaction.csv"))
    p_header, prot = _read_table(os.path.join(path, "prot_info.csv"))
    col = {h: j for j, h in enumerate(header)}
    p_col = {h: j for j, h in enumerate(p_header)}
    sid, smi = col["PUBCHEM_SID"], col["Canonical_Smiles"]
    inter = [r for r in inter if r[sid] != "" and r[smi] != ""]
    prot_names = [r[p_col["name"]] for r in prot]
    ligands = OrderedDict((str(int(float(r[sid]))), r[smi]) for r in inter)
    proteins = OrderedDict((r[p_col["name"]], r[p_col["sequence"]]) for r in prot)
    vals = np.array([[float("nan") if "<" in r[col[p]] else _number(r[col[p]])
                      for p in prot_names] for r in inter], dtype=np.float64)
    return _affinity_to_records(proteins, ligands, vals.reshape(len(inter), len(prot_names)),
                                structures_dir)


def _group_means(keys: list, values: list) -> dict:
    """Mean of ``values`` per key, summed as pandas' groupby mean sums
    (Kahan-compensated, in row order)."""
    sums: dict = {}
    comp: dict = {}
    nobs: dict = {}
    for key, val in zip(keys, values):
        if val != val:
            continue
        s, c = sums.get(key, 0.0), comp.get(key, 0.0)
        y = val - c
        t = s + y
        c = t - s - y
        comp[key] = 0.0 if c != c else c
        sums[key] = t
        nobs[key] = nobs.get(key, 0) + 1
    return {k: sums[k] / nobs[k] for k in sums}


def _pivot(rows: list, cols: list, values: list, index: list, columns: list) -> np.ndarray:
    """The ``len(index) × len(columns)`` matrix of ``values`` at (rows[i],
    cols[i]), NaN elsewhere; a repeated cell raises as pandas' pivot does."""
    r_at = {k: i for i, k in enumerate(index)}
    c_at = {k: i for i, k in enumerate(columns)}
    out = np.full((len(index), len(columns)), np.nan)
    seen = set()
    for r, c, v in zip(rows, cols, values):
        if (r, c) in seen:
            raise ValueError("Index contains duplicate entries, cannot reshape")
        seen.add((r, c))
        if r in r_at and c in c_at:
            out[r_at[r], c_at[c]] = v
    return out


def _sha(s: str) -> str:
    return hashlib.sha1(s.encode()).hexdigest()


def _parse_bindingdb(tsv: str, col: str) -> dict:
    """BindingDB_All.tsv -> the parsed rows of reference load_data.py:132-236:
    -log10(nM/1e9) of ``col``, finite values of valid SMILES, each
    (SMILES, sequence) pair once with the mean of its values, sorted by
    (ligand name, target name), names suffixed with the SMILES' and the
    sequence's SHA-1."""
    name_c, smi_c, tgt_c, seq_c = ("BindingDB Ligand Name", "Ligand SMILES", "Target Name",
                                   "BindingDB Target Chain Sequence")
    header, rows = _read_table(tsv, "\t")
    at = {h: j for j, h in enumerate(header)}
    rows = [[r[at[k]] for k in (name_c, smi_c, tgt_c, seq_c)] + [_number(r[at[col]])]
            for r in rows]
    rows = [r for r in rows if r[4] == r[4]]
    with np.errstate(divide="ignore", invalid="ignore"):   # 0 and negatives drop below
        aff = -np.log10(np.array([r[4] for r in rows], dtype=np.float64) / 1e9)
    rows = [r[:4] + [float(a)] for r, a in zip(rows, aff) if np.isfinite(a)]
    rows = [r for r in rows if validate_smiles(r[1])]
    means = _group_means([(r[1], r[3]) for r in rows], [r[4] for r in rows])
    nodupe, seen = [], set()
    for r in rows:
        if (r[1], r[3]) not in seen:
            seen.add((r[1], r[3]))
            nodupe.append(r[:4] + [means[(r[1], r[3])]])
    nodupe.sort(key=lambda r: (r[0], r[2]))
    for r in nodupe:
        r[0] = f"{r[0]}__{_sha(r[1])}"
        r[2] = f"{r[2]}__{_sha(r[3])}"
    return {"names": [r[0] for r in nodupe], "smiles": [r[1] for r in nodupe],
            "targets": [r[2] for r in nodupe], "sequences": [r[3] for r in nodupe],
            "values": [r[4] for r in nodupe]}


def load_bindingdb(data_root: str, task: str = "kd", structures_dir=None,
                   min_len: int = 25, max_len: int = 3000):
    """BindingDB_All.tsv parse (reference load_data.py:132-252): -log10(nM/1e9)
    transform, SMILES validation, dupe-pair mean-averaging, name+hash ids,
    25<=len<=3000 protein filter."""
    path = os.path.join(data_root, "bindingdb")
    col = {"kd": "Kd (nM)", "ki": "Ki (nM)", "ic50": "IC50 (nM)",
           "ec50": "EC50 (nM)"}[task]
    cache = os.path.join(path, f"BindingDB_All.tsv_parsed_{task}_records.pkl")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            bdb = pickle.load(f)
    else:
        tsv = os.path.join(path, "BindingDB_All.tsv")
        if not os.path.exists(tsv):
            raise FileNotFoundError(
                f"{tsv} not present — the raw BindingDB dump (~1 GB) is not "
                "vendored and the port downloads nothing (no network egress), so the "
                "bindingdb datasets cannot be built without it. Download "
                "BindingDB_All.tsv from bindingdb.org into that directory "
                "(or point --data-root at a tree that has it), or use one of "
                "davis/kiba/metz instead.")
        bdb = _parse_bindingdb(tsv, col)
        with open(cache, "wb") as f:
            pickle.dump(bdb, f)

    keep = [i for i, s in enumerate(bdb["sequences"]) if min_len <= len(s) <= max_len]
    names = [bdb["names"][i] for i in keep]
    smiles = [bdb["smiles"][i] for i in keep]
    targets = [bdb["targets"][i] for i in keep]
    seqs = [bdb["sequences"][i].upper() for i in keep]
    values = [bdb["values"][i] for i in keep]
    # each distinct (name, SMILES) and (target, sequence) pair, first seen first
    ligands = OrderedDict(dict.fromkeys(zip(names, smiles)).keys())
    proteins = OrderedDict(dict.fromkeys(zip(targets, seqs)).keys())
    matrix = _pivot(names, targets, values, list(ligands), list(proteins))
    return _affinity_to_records(proteins, ligands, matrix, structures_dir)


# BELKA's three fixed targets (public sequences; reference
# load_data.py:268-273 hard-codes the same) and their known structures.
BELKA_PROTEINS = OrderedDict([
    ("BRD4", "GPMEQLKCCSGILKEMFAKKHAAYAWPFYKPVDVEALGLHDYCDIIKHPMDMSTIKSKLE"
             "AREYRDAQEFGADVRLMFSNCYKYNPPDHEVVAMARKLQDVFEMRFAKM"),
    ("HSA", "DAHKSEVAHRFKDLGEENFKALVLIAFAQYLQQCPFEDHVKLVNEVTEFAKTCVADESAENC"
            "DKSLHTLFGDKLCTVATLRETYGEMADCCAKQEPERNECFLQHKDDNPNLPRLVRPEVDVMC"
            "TAFHDNEETFLKKYLYEIARRHPYFYAPELLFFAKRYKAAFTECCQAADKAACLLPKLDELR"
            "DEGKASSAKQRLKCASLQKFGERAFKAWAVARLSQRFPKAEFAEVSKLVTDLTKVHTECCHG"
            "DLLECADDRADLAKYICENQDSISSKLKECCEKPLLEKSHCIAEVENDEMPADLPSLAADFV"
            "ESKDVCKNYAEAKDVFLGMFLYEYARRHPDYSVVLLLRLAKTYETTLEKCCAAADPHECYAK"
            "VFDEFKPLVEEPQNLIKQNCELFEQLGEYKFQNALLVRYTKKVPQVSTPTLVEVSRNLGKVG"
            "SKCCKHPEAKRMPCAEDYLSVVLNQLCVLHEKTPVSDRVTKCCTESLVNRRPCFSALEVDET"
            "YVPKEFNAETFTFHADICTLSEKERQIKKQTALVELVKHKPKATKEQLKAVMDDFAAFVEKC"
            "CKADDKETCFAEEGKKLVAASQAALGL"),
    ("sEH", "MTLRAAVFDLDGVLALPAVFGVLGRTEEALALPRGLLNDAFQKGGPEGATTRLMKGEITLSQ"
            "WIPLMEENCRKCSETAKVCLPKNFSIKEIFDKAISARKINRPMLQAALMLRKKGFTTAILTN"
            "TWLDDRAERDGLAQLMCELKMHFDFLIESCQVGMVKPEPQIYKFLLDTLKASPSEVVFLDDI"
            "GANLKPARDLGMVTILVQDTDTALKELEKVTGIQLLNTPAPLPTSCNPSDMSHGYVTVKPRV"
            "RLHFVELGSGPAVCLCHGFPESWYSWRYQIPALAQAGYRVLAMDMKGYGESSAPPEIEEYCM"
            "EVLCKEMVTFLDKLGLSQAVFIGHDWGGMLVWYMALFYPERVRAVASLNTPFIPANPNMSPL"
            "ESIKANPVFDYQLYFQEPGVAEAELEQNLSRTFKSLFRASDESVLSMHKVCEAGGLFVNSPE"
            "EPSLSRMVTEEEIQFYVQQFKKSGFRGPLNWYRNMERNWKWACKSLGRKILIPALMVTAEKD"
            "FVLVPQMSQHMEDWIPHLKRGHIEDCGHWTQMDKPTEVNQILIKWLDSDARNPPVVSKM"),
])
BELKA_KNOWN_PDB_IDS = {"BRD4": "7USK", "HSA": "1AO6", "sEH": "3i28"}


def load_belka(data_root: str, structures_dir=None,
               affinity_fname: str = "train.parquet"):
    """Leash BELKA binary-binding dataset (reference load_data.py:254-344):
    parquet of (molecule_smiles, protein_name, binds) against 3 fixed
    targets, SMILES-validated, pivoted to a ligand x protein matrix (ligands
    sorted, targets in BELKA_PROTEINS order), then long-form canonical rows.
    The parsed pivot is pickled beside the parquet, as the reference caches
    it. Reading the parquet needs pyarrow."""
    path = os.path.join(data_root, "belka")
    fp = os.path.join(path, affinity_fname)
    if not os.path.exists(fp):
        raise FileNotFoundError(f"Could not locate BELKA affinity file {fp}")

    cache_piv = os.path.join(path, f"{affinity_fname}_parsed_pivot_records.pkl")
    if os.path.exists(cache_piv):
        with open(cache_piv, "rb") as f:
            piv = pickle.load(f)
    else:
        try:
            import pyarrow.parquet as pq
        except ImportError as err:
            raise ImportError("reading BELKA's parquet needs the pyarrow package") from err
        table = pq.read_table(fp, columns=["molecule_smiles", "protein_name", "binds"])
        smiles, names, binds = (table.column(c).to_pylist()
                                for c in ("molecule_smiles", "protein_name", "binds"))
        keep = [i for i, s in enumerate(smiles) if validate_smiles(s)]
        smiles, names, binds = ([x[i] for i in keep] for x in (smiles, names, binds))
        index = sorted(set(smiles))
        columns = [c for c in BELKA_PROTEINS if c in set(names)]
        piv = {"index": index, "columns": columns,
               "values": _pivot(smiles, names, binds, index, columns)}
        with open(cache_piv, "wb") as f:
            pickle.dump(piv, f)

    ligands = OrderedDict((f"belka__{_sha(s)}", s) for s in piv["index"])
    proteins = OrderedDict((k, BELKA_PROTEINS[k]) for k in piv["columns"])
    return _affinity_to_records(proteins, ligands, np.asarray(piv["values"], np.float64),
                                structures_dir)


def apply_mostcommon_filter(records: dict, thresh: float = 0.1) -> dict:
    """Downsample overrepresented filler values (load_data.py:347-356; e.g.
    Davis' 75% filler 5.0)."""
    values = [v for v in records["affinity_score"] if v == v]
    over = {v for v, c in Counter(values).items() if c / len(values) > thresh}
    if over:
        records = tables.take(records, [i for i, v in enumerate(records["affinity_score"])
                                      if v not in over])
    return records


def apply_proteinseqdupe_filter(records: dict) -> dict:
    """Keep only the protein with the most distinct affinities per duplicated
    sequence, the first by protein_id on a tie (load_data.py:361-386)."""
    first_seq: dict = {}
    for pid, seq in zip(records["protein_id"], records["protein_sequence"]):
        first_seq.setdefault(pid, seq)
    by_seq: dict = {}
    for pid in sorted(first_seq):
        by_seq.setdefault(first_seq[pid], []).append(pid)
    distinct: dict = {}
    for pid, aff in zip(records["protein_id"], records["affinity_score"]):
        if aff == aff:
            distinct.setdefault(pid, set()).add(aff)
    drop = set()
    for pids in by_seq.values():
        if len(pids) > 1:
            counts = [len(distinct.get(p, ())) for p in pids]
            best = pids[counts.index(max(counts))]
            drop.update(p for p in pids if p != best)
    return tables.take(records, [i for i, p in enumerate(records["protein_id"])
                               if p not in drop])


def load_dataset(dataset_name: str, data_root: str = "./data",
                 structures_dir: Optional[str] = None,
                 do_mostcommon_filter: bool = False,
                 do_proteinseqdupe_filter: bool = False,
                 **kwargs) -> dict:
    """Name-dispatched loader (reference load_data.py:28-96 interface) ->
    records."""
    name = dataset_name.lower()
    if name in ("davis", "kiba"):
        rec = load_davis_kiba(name, os.path.join(data_root, "deepdta_data"), structures_dir)
    elif name == "metz":
        rec = load_metz(os.path.join(data_root, "other_data"), structures_dir)
    elif name.startswith("bindingdb"):
        task = name.split("_")[-1] if "_" in name else "kd"
        rec = load_bindingdb(os.path.join(data_root, "other_data"), task, structures_dir)
    elif "belka" in name:
        rec = load_belka(os.path.join(data_root, "belka_data"), structures_dir, **kwargs)
    elif name == "plinder":
        from caster_dta_torch.data.plinder import parse_plinder
        rec = parse_plinder(os.path.join(data_root, "plinder_data"), **kwargs)
    elif name == "synthetic":
        # offline end-to-end runs: on-disk helix-backbone PDBs + pool SMILES
        # with a size-dependent affinity signal (data/synthetic.py)
        from caster_dta_torch.data.synthetic import make_synthetic_records
        rec = make_synthetic_records(
            os.path.join(data_root, "synthetic_pdbs"),
            **{k: v for k, v in kwargs.items()
               if k in ("n_proteins", "n_molecules", "n_pairs", "res_range", "seed")})
    else:
        raise ValueError(f"Dataset name {dataset_name!r} not recognized")
    if do_mostcommon_filter:
        rec = apply_mostcommon_filter(rec)
    if do_proteinseqdupe_filter:
        rec = apply_proteinseqdupe_filter(rec)
    return rec
