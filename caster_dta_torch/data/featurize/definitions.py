"""Feature vocabularies: amino-acid maps/property tables and SMILES one-hot maps.

Behavioral spec: reference utils/protein_definitions.py and
utils/smiles_definitions.py. The amino-acid property values are public data
from the CRC Handbook of Chemistry and Physics (95th ed., "Properties of Amino
Acids") and the Wimley-White hydrophobicity scale; each table is min-max
normalized to [0, 1] with 'X' (unknown residue) mapped to 0.
"""
from __future__ import annotations

from collections import defaultdict

PROTEIN_3LETTER_1LETTER_MAP = defaultdict(lambda: "X", {
    "ALA": "A", "CYS": "C", "ASP": "D", "GLU": "E", "PHE": "F", "GLY": "G",
    "HIS": "H", "ILE": "I", "LYS": "K", "LEU": "L", "MET": "M", "ASN": "N",
    "PRO": "P", "GLN": "Q", "ARG": "R", "SER": "S", "THR": "T", "VAL": "V",
    "TRP": "W", "TYR": "Y", "UNK": "X",
})

_ORDERED_1LETTER = ["A", "C", "D", "E", "F", "G", "H", "I", "K", "L", "M",
                    "N", "P", "Q", "R", "S", "T", "V", "W", "Y", "X"]
PROTEIN_1LETTER_3LETTER_MAP = {v: k for k, v in dict(PROTEIN_3LETTER_1LETTER_MAP).items()}
PROTEIN_1LETTER_INT_MAP = {aa: i for i, aa in enumerate(_ORDERED_1LETTER)}
PROTEIN_INT_1LETTER_MAP = {v: k for k, v in PROTEIN_1LETTER_INT_MAP.items()}


def normalize_aa_dict(d: dict, X_val=0.0) -> dict:
    """Min-max normalize to [0,1]; optionally add an 'X' default
    (reference protein_definitions.py:46-63)."""
    lo, hi = min(d.values()), max(d.values())
    out = {k: (v - lo) / (hi - lo) for k, v in d.items()}
    if X_val is not None:
        out["X"] = sum(out.values()) / len(out) if X_val == "mean" else X_val
    return out


# CRC Handbook M_r column (molecular weights)
AA_WEIGHTS = normalize_aa_dict({
    "A": 89.09, "C": 121.16, "D": 133.10, "E": 147.13, "F": 165.19,
    "G": 75.07, "H": 155.15, "I": 131.17, "K": 146.19, "L": 131.17,
    "M": 149.21, "N": 132.12, "P": 115.13, "Q": 146.14, "R": 174.20,
    "S": 105.09, "T": 119.12, "V": 117.15, "W": 204.23, "Y": 181.19})

# CRC pKa (-COOH)
AA_PKAS = normalize_aa_dict({
    "A": 2.33, "C": 1.91, "D": 1.95, "E": 2.16, "F": 2.18, "G": 2.34,
    "H": 1.70, "I": 2.26, "K": 2.15, "L": 2.32, "M": 2.16, "N": 2.16,
    "P": 1.95, "Q": 2.18, "R": 2.03, "S": 2.13, "T": 2.20, "V": 2.27,
    "W": 2.38, "Y": 2.24})

# CRC pKb (-NH2)
AA_PKBS = normalize_aa_dict({
    "A": 9.71, "C": 10.28, "D": 9.66, "E": 9.58, "F": 9.09, "G": 9.58,
    "H": 9.09, "I": 9.60, "K": 9.16, "L": 9.58, "M": 9.08, "N": 8.73,
    "P": 10.47, "Q": 9.00, "R": 9.00, "S": 9.05, "T": 8.96, "V": 9.52,
    "W": 9.34, "Y": 9.04})

# CRC pKc (side-chain/functional group)
AA_PKCS = normalize_aa_dict({
    "A": 0.0, "C": 8.14, "D": 3.71, "E": 4.15, "F": 0.0, "G": 0.0,
    "H": 6.04, "I": 0.0, "K": 10.67, "L": 0.0, "M": 0.0, "N": 0.0,
    "P": 0.0, "Q": 0.0, "R": 12.10, "S": 0.0, "T": 0.0, "V": 0.0,
    "W": 0.0, "Y": 10.10})

# CRC pI (isoelectric point)
AA_PKIS = normalize_aa_dict({
    "A": 6.00, "C": 5.07, "D": 2.77, "E": 3.22, "F": 5.48, "G": 5.97,
    "H": 7.59, "I": 6.02, "K": 9.74, "L": 5.98, "M": 5.74, "N": 5.41,
    "P": 6.30, "Q": 5.65, "R": 10.76, "S": 5.68, "T": 5.60, "V": 5.96,
    "W": 5.89, "Y": 5.66})

# Wimley-White hydrophobicity (ionized asp/glu/his; more positive = more hydrophobic)
AA_HYDROPHOB = normalize_aa_dict({
    "A": -0.17, "C": 0.24, "D": -1.23, "E": -2.02, "F": 1.13, "G": -0.01,
    "H": -0.96, "I": 0.31, "K": -0.99, "L": 0.56, "M": 0.23, "N": -0.42,
    "P": -0.45, "Q": -0.58, "R": -0.81, "S": -0.13, "T": -0.14, "V": -0.07,
    "W": 1.85, "Y": 0.94})

AA_ALIPHATIC = defaultdict(lambda: 0, {aa: 1 for aa in ["A", "G", "I", "L", "P", "V"]})
AA_AROMATIC = defaultdict(lambda: 0, {aa: 1 for aa in ["F", "H", "W", "Y"]})
AA_ACIDIC = defaultdict(lambda: 0, {aa: 1 for aa in ["D", "E"]})
AA_BASIC = defaultdict(lambda: 0, {aa: 1 for aa in ["H", "K", "R"]})
AA_POLAR_NEUTRAL = defaultdict(lambda: 0, {aa: 1 for aa in ["N", "Q", "S", "T"]})

AA_PROPERTY_DICTS = [AA_WEIGHTS, AA_PKAS, AA_PKBS, AA_PKCS, AA_PKIS,
                     AA_HYDROPHOB, AA_ALIPHATIC, AA_AROMATIC, AA_ACIDIC,
                     AA_BASIC, AA_POLAR_NEUTRAL]


# ---------------------------------------------------------------------------
# SMILES / molecule vocabularies (reference smiles_definitions.py)
# ---------------------------------------------------------------------------

def map_intdict_to_onehot(in_dict: dict, add_other: bool = False):
    n = len(in_dict) + (1 if add_other else 0)
    out = {}
    for k, v in in_dict.items():
        oh = [0] * n
        oh[v] = 1
        out[k] = oh
    if add_other:
        other = [0] * (n - 1) + [1]
        out = defaultdict(lambda: other, out)
    return out


SELECT_ATOMICNUMS_TO_KEEP = [1, 6, 7, 8, 9, 15, 16, 17, 35, 53]  # H C N O F P S Cl Br I
SELECT_ATOMICNUM_TO_NTYPE = defaultdict(
    lambda: len(SELECT_ATOMICNUMS_TO_KEEP),
    {j: i for i, j in enumerate(SELECT_ATOMICNUMS_TO_KEEP)})
ALL_ATOMICNUM_TO_NTYPE = defaultdict(lambda: 118,
                                     {j: i for i, j in enumerate(range(1, 119))})

CHIRALITIES = ["CHI_TETRAHEDRAL_CW", "CHI_TETRAHEDRAL_CCW"]
SMILES_CHIRALITY_MAP = map_intdict_to_onehot(
    {j: i for i, j in enumerate(CHIRALITIES)}, add_other=True)

HYBRIDIZATIONS = ["S", "SP", "SP2", "SP3", "SP3D", "SP3D2"]
SMILES_HYBRID_MAP = map_intdict_to_onehot(
    {j: i for i, j in enumerate(HYBRIDIZATIONS)}, add_other=True)

SMILES_H_MAP = map_intdict_to_onehot(
    {j: i for i, j in enumerate([0, 1, 2, 3, 4])}, add_other=True)
SMILES_CHARGE_MAP = map_intdict_to_onehot(
    {j: i for i, j in enumerate([-2, -1, 0, 1, 2])}, add_other=True)
SMILES_RADICAL_MAP = map_intdict_to_onehot(
    {j: i for i, j in enumerate([0, 1, 2])}, add_other=True)
SMILES_DEGREE_MAP = map_intdict_to_onehot(
    {j: i for i, j in enumerate(range(11))}, add_other=True)
SMILES_VALENCE_MAP = map_intdict_to_onehot(
    {j: i for i, j in enumerate(range(7))}, add_other=True)

BOND_TYPES = ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC"]
SMILES_BOND_MAP = defaultdict(lambda: len(BOND_TYPES),
                              {j: i for i, j in enumerate(BOND_TYPES)})

STEREO_CONFIGS = ["STEREONONE", "STEREOANY", "STEREOZ", "STEREOE",
                  "STEREOCIS", "STEREOTRANS"]
SMILES_STEREO_MAP = map_intdict_to_onehot(
    {j: i for i, j in enumerate(STEREO_CONFIGS)}, add_other=True)
