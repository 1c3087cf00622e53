"""Self-contained PDB backbone parser + residue graph featurization.

Behavioral spec: reference utils/pdb_utils.py:11-98, which uses mdtraj. This
package does not depend on mdtraj, so the parsing is implemented directly; the observable
behavior is matched:

  * select protein atoms named N/CA/C/O, first model only;
  * trim leading/trailing atoms until the atom-name string starts/ends with
    the full 'N CA C O' pattern (terminal incomplete residues dropped);
  * coordinates in nanometers by default (mdtraj convention: PDB Å / 10),
    multiplied by 10 when dist_units='angstroms';
  * residue 3-letter -> 1-letter -> int types with 'X' fallback.

Also parses minimal mmCIF (atom_site loop), covering the reference's
mmCIF->PDB conversion fallback (dataset/process_data.py:294-335).
"""
from __future__ import annotations

import gzip
import numpy as np

from caster_dta_torch.data.featurize import definitions as protein_maps
from caster_dta_torch.data.featurize.protein import (
    compute_residue_edge_features, compute_residue_node_features)

_BACKBONE = ("N", "CA", "C", "O")
# HETATM residues mdtraj still treats as protein (modified residues)
_HET_PROTEIN = {"MSE", "SEC", "PYL", "MLY", "SEP", "TPO", "PTR", "CSO", "HYP"}


def _open_maybe_gz(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def parse_pdb_backbone(pdb_file: str):
    """Parse backbone atoms from a PDB or mmCIF file.

    Returns (atom_names list[str], coords [n_atoms, 3] in Angstroms,
    res_names list[str] one per atom's residue occurrence order).
    """
    with _open_maybe_gz(pdb_file) as f:
        text = f.read()
    if _looks_like_cif(text):
        return _parse_cif(text)
    return _parse_pdb(text)


def _looks_like_cif(text: str) -> bool:
    head = text[:4000]
    return "_atom_site." in head or head.lstrip().startswith("data_")


def _parse_pdb(text: str):
    names, coords, resnames, reskeys = [], [], [], []
    seen_atoms_in_res: dict = {}
    in_model = 0
    for line in text.splitlines():
        rec = line[:6]
        if rec == "MODEL ":
            in_model += 1
            if in_model > 1:
                break  # first model only (reference pdb_utils.py:42-43)
            continue
        if rec == "ENDMDL":
            break
        if rec not in ("ATOM  ", "HETATM"):
            continue
        resname = line[17:20].strip()
        if rec == "HETATM" and resname not in _HET_PROTEIN:
            continue
        name = line[12:16].strip()
        if name not in _BACKBONE:
            continue
        altloc = line[16].strip()
        if altloc not in ("", "A"):
            continue
        reskey = (line[21], line[22:26].strip(), line[26].strip())  # chain, seq, icode
        # skip duplicate atom names within one residue (altloc dupes)
        atomset = seen_atoms_in_res.setdefault(reskey, set())
        if name in atomset:
            continue
        atomset.add(name)
        names.append(name)
        coords.append((float(line[30:38]), float(line[38:46]), float(line[46:54])))
        resnames.append(resname)
        reskeys.append(reskey)
    return names, np.asarray(coords, dtype=np.float64), resnames, reskeys


def _parse_cif(text: str):
    """Minimal mmCIF atom_site parser (columns by header order)."""
    lines = text.splitlines()
    header: list[str] = []
    rows_start = None
    in_loop = False
    for i, line in enumerate(lines):
        s = line.strip()
        if s == "loop_":
            in_loop = True
            header = []
            continue
        if in_loop and s.startswith("_atom_site."):
            header.append(s.split(".", 1)[1].split()[0])
            rows_start = i + 1
            continue
        if header and not s.startswith("_"):
            rows_start = i
            break
        if in_loop and not s.startswith("_") and not header:
            in_loop = False
    if not header:
        raise ValueError("no _atom_site loop found in mmCIF file")

    col = {h: j for j, h in enumerate(header)}
    names, coords, resnames, reskeys = [], [], [], []
    seen_atoms_in_res: dict = {}
    first_model = None
    for line in lines[rows_start:]:
        s = line.strip()
        if not s or s.startswith(("#", "loop_", "_", "data_")):
            break
        parts = s.split()
        if len(parts) < len(header):
            continue
        group = parts[col["group_PDB"]] if "group_PDB" in col else "ATOM"
        resname = parts[col.get("label_comp_id", col.get("auth_comp_id"))]
        if group == "HETATM" and resname not in _HET_PROTEIN:
            continue
        name = parts[col.get("label_atom_id", col.get("auth_atom_id"))].strip('"')
        if name not in _BACKBONE:
            continue
        if "pdbx_PDB_model_num" in col:
            model = parts[col["pdbx_PDB_model_num"]]
            if first_model is None:
                first_model = model
            elif model != first_model:
                break
        alt = parts[col["label_alt_id"]] if "label_alt_id" in col else "."
        if alt not in (".", "?", "A"):
            continue
        chain = parts[col.get("auth_asym_id", col.get("label_asym_id"))]
        seq = parts[col.get("auth_seq_id", col.get("label_seq_id"))]
        reskey = (chain, seq, "")
        atomset = seen_atoms_in_res.setdefault(reskey, set())
        if name in atomset:
            continue
        atomset.add(name)
        names.append(name)
        coords.append((float(parts[col["Cartn_x"]]),
                       float(parts[col["Cartn_y"]]),
                       float(parts[col["Cartn_z"]])))
        resnames.append(resname)
        reskeys.append(reskey)
    return names, np.asarray(coords, dtype=np.float64), resnames, reskeys


def load_backbone_coords(pdb_file: str):
    """Backbone coords + residue identities with terminal trimming.

    Returns (res_coords [n_res, 4, 3] in nanometers, res_names list[str]).
    """
    names, coords, resnames, reskeys = parse_pdb_backbone(pdb_file)
    if len(names) == 0:
        raise ValueError(f"no protein backbone atoms found in {pdb_file}")

    # Trim until the atom string starts with N CA C O and ends with ...O
    # (reference pdb_utils.py:45-56 does this with a string search)
    atomstr = "".join(names)
    expected = "NCACO"
    first_ind = atomstr.find(expected)
    last_ind = atomstr[::-1].find(expected[::-1])
    if first_ind < 0 or last_ind < 0:
        raise ValueError(f"no complete backbone residue found in {pdb_file}")
    # first_ind/last_ind are character offsets; map to atom indices
    char_offsets = np.cumsum([0] + [len(n) for n in names])
    start_atom = int(np.searchsorted(char_offsets, first_ind))
    if char_offsets[start_atom] != first_ind:
        # pattern starts mid-atom-name (e.g. inside 'CA') — scan forward
        start_atom = int(np.searchsorted(char_offsets, first_ind, side="right"))
    end_char = len(atomstr) - last_ind
    end_atom = int(np.searchsorted(char_offsets, end_char))

    names = names[start_atom:end_atom]
    coords = coords[start_atom:end_atom]
    resnames = resnames[start_atom:end_atom]

    n_atoms = len(names)
    if n_atoms % 4 != 0:
        raise ValueError(
            f"{pdb_file}: {n_atoms} backbone atoms not divisible by 4 — "
            "mid-chain incomplete residues are not supported (matches reference)")
    n_res = n_atoms // 4
    res_coords = (coords / 10.0).reshape(n_res, 4, 3)  # Å -> nm (mdtraj units)
    res_names = resnames[::4]
    return res_coords.astype(np.float32), list(res_names)


def process_pdb(pdb_file: str, dist_units: str, edge_thresh, thresh_type,
                keep_self_loops, vectorize_features, add_esm2_embeds=False,
                add_residue_posenc=False, include_aa_props=True):
    """Full PDB -> (node_features, edge_features, node_types, edge_types)
    (reference utils/pdb_utils.py:11-98)."""
    res_coords, res_names = load_backbone_coords(pdb_file)
    n_res = res_coords.shape[0]

    if dist_units == "angstroms":
        res_coords = res_coords * 10
    elif dist_units != "nanometers":
        raise ValueError(f"Distance units {dist_units!r} not recognized. "
                         "Must be 'angstroms' or 'nanometers'")

    res_1letter = [protein_maps.PROTEIN_3LETTER_1LETTER_MAP[r] for r in res_names]
    res_idents = [protein_maps.PROTEIN_1LETTER_INT_MAP[r] for r in res_1letter]

    node_features = compute_residue_node_features(
        res_coords, res_idents, vectorize_features, add_esm2_embeds,
        add_residue_posenc, include_aa_props)
    node_types = np.asarray(res_idents, dtype=np.int32)
    edge_features = compute_residue_edge_features(
        res_coords, res_idents, edge_thresh, thresh_type, keep_self_loops,
        vectorize_features)
    edge_types = np.zeros([n_res, n_res], dtype=np.int32)
    return node_features, edge_features, node_types, edge_types
