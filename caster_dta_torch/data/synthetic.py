"""Synthetic dataset generation: realistic-geometry protein backbones written
as PDB files plus drug-like SMILES, for tests and benchmarks in environments
without network access to RCSB/AlphaFoldDB (the reference's acquisition layer,
dataset/process_data.py, needs the network). Counterpart of
caster_dta_tpu/data/synthetic.py: the same RNG calls, so the same PDB bytes
and the same rows; the rows come as records (data/datasets.py), not a
DataFrame.

The backbone generator places N/CA/C/O along an idealized alpha helix with
Gaussian jitter, so CA-CA distances (~3.8 Å sequential) and 4 Å-threshold
contact graphs look like real proteins to the featurizer.
"""
from __future__ import annotations

import os

import numpy as np

from caster_dta_torch.data.datasets import COLUMNS, drop_duplicate_pairs
from caster_dta_torch.data.featurize.definitions import (
    PROTEIN_1LETTER_3LETTER_MAP, PROTEIN_1LETTER_INT_MAP)

_AA = [a for a in PROTEIN_1LETTER_INT_MAP if a != "X"]

# a small pool of valid drug-like SMILES (hand-writable classics)
SMILES_POOL = [
    "CC(=O)Oc1ccccc1C(=O)O",                       # aspirin
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O",                  # ibuprofen
    "Cn1cnc2c1c(=O)n(C)c(=O)n2C",                  # caffeine
    "NC(=O)c1ccc(N)cc1",                           # aminobenzamide
    "Oc1ccc(cc1)C(=O)O",                           # 4-hydroxybenzoic acid
    "CC(N)Cc1ccccc1",                              # amphetamine
    "Clc1ccc(cc1)C(=O)Nc1ccccc1",                  # amide
    "COc1ccc(CCN)cc1OC",                           # dimethoxyphenethylamine
    "CCN(CC)CCNC(=O)c1ccc(N)cc1",                  # procainamide
    "OC(=O)CCc1ccccc1",                            # hydrocinnamic acid
    "c1ccc2c(c1)cccn2",                            # quinoline
    "CC1=CC(=O)C=CC1=O",                           # methylquinone
    "NCCc1c[nH]c2ccccc12",                         # tryptamine
    "OCC(O)C(O)C(O)C(O)CO",                        # sorbitol
    "CN1CCC(CC1)c1ccccc1",                         # phenylpiperidine
    "Fc1ccc(cc1)S(=O)(=O)N",                       # fluorobenzenesulfonamide
]


def helix_backbone(n_res: int, rng: np.random.Generator,
                   jitter: float = 0.15) -> np.ndarray:
    """Idealized alpha-helix backbone coords [n_res, 4, 3] in Angstroms."""
    rise, per_turn, radius = 1.5, 3.6, 2.3
    t = np.arange(n_res) * (2 * np.pi / per_turn)
    z = np.arange(n_res) * rise
    ca = np.stack([radius * np.cos(t), radius * np.sin(t), z], axis=1)
    # offsets for N, C, O relative to CA (approximate ideal geometry)
    tang = np.gradient(ca, axis=0)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    radial = ca - np.stack([np.zeros(n_res), np.zeros(n_res), z], axis=1)
    radial /= np.linalg.norm(radial, axis=1, keepdims=True)
    n = ca - 1.46 * tang * 0.85 - 0.4 * radial
    c = ca + 1.52 * tang * 0.85 - 0.4 * radial
    o = c + 1.23 * np.cross(tang, radial)
    coords = np.stack([n, ca, c, o], axis=1)
    coords += rng.normal(scale=jitter, size=coords.shape)
    return coords


def write_pdb(path: str, coords: np.ndarray, sequence: str) -> None:
    """Write [n_res, 4, 3] backbone (Angstroms) as a minimal PDB file."""
    lines = []
    serial = 1
    for i, (res_coords, aa) in enumerate(zip(coords, sequence)):
        res3 = PROTEIN_1LETTER_3LETTER_MAP.get(aa, "UNK")
        for name, xyz in zip(("N", "CA", "C", "O"), res_coords):
            lines.append(
                f"ATOM  {serial:>5d}  {name:<3s} {res3} A{i + 1:>4d}    "
                f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00          "
                f" {name[0]}")
            serial += 1
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def make_synthetic_records(out_dir: str, n_proteins: int = 4,
                           n_molecules: int = 8, n_pairs: int = 24,
                           res_range=(20, 60), seed: int = 0) -> dict:
    """The canonical six columns (a list each) with on-disk synthetic PDBs:
    the rows of caster_dta_tpu's ``make_synthetic_dataframe``."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    prots = {}
    for i in range(n_proteins):
        n_res = int(rng.integers(*res_range))
        seq = "".join(rng.choice(_AA, n_res))
        path = os.path.join(out_dir, f"prot{i}.pdb")
        write_pdb(path, helix_backbone(n_res, rng), seq)
        prots[f"prot{i}"] = (seq, path)
    mols = {f"mol{i}": SMILES_POOL[i % len(SMILES_POOL)]
            for i in range(n_molecules)}

    rows = []
    for _ in range(n_pairs):
        pid = f"prot{rng.integers(n_proteins)}"
        mid = f"mol{rng.integers(n_molecules)}"
        seq, path = prots[pid]
        # a learnable synthetic signal: affinity depends on sizes
        aff = 5.0 + 0.02 * len(seq) + 0.1 * len(mols[mid]) \
            + float(rng.normal(scale=0.2))
        rows.append((pid, seq, path, mid, mols[mid], aff))
    return drop_duplicate_pairs({c: [r[i] for r in rows] for i, c in enumerate(COLUMNS)})
