"""Write benchmark/data/davis_sizes.json: the residue count and the 4 A
contact-edge count of each Davis kinase structure, by the featurizer's
rules (runs/davis_seed9/dataset_kwargs.json: CA-CA distance <= 4 A, self
loops kept; residues as caster_dta_torch.data.featurize.pdb trims them).

Run once on the CPU from the repository root, where data/structures_davis
holds the 442 PDB files:

    python benchmark/make_davis_sizes.py

No benchmark run reads the structures: the mixes read this table.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "benchmark", "data", "davis_sizes.json")
EDGE_THRESH_A = 4.0


def sizes(path: str) -> tuple:
    from caster_dta_torch.data.featurize.pdb import load_backbone_coords

    coords, _ = load_backbone_coords(path)
    ca = coords[:, 1, :].astype(np.float64) * 10.0          # nm -> A
    n = len(ca)
    edges = 0
    for start in range(0, n, 512):                         # dist <= 4 A, self loops included
        d = np.linalg.norm(ca[start:start + 512, None, :] - ca[None, :, :], axis=-1)
        edges += int((d <= EDGE_THRESH_A).sum())
    return n, edges


def main() -> None:
    sys.path.insert(0, ROOT)
    folder = os.path.join(ROOT, "data", "structures_davis")
    rows = []
    for name in sorted(os.listdir(folder)):
        if name.endswith(".pdb"):
            n, e = sizes(os.path.join(folder, name))
            rows.append({"target": name[:-4], "residues": n, "edges": e})
    with open(OUT, "w") as f:
        json.dump({"source": "data/structures_davis (442 Davis kinase structures), "
                             "CA-CA <= 4 A with self loops, as the featurizer builds edges",
                   "proteins": rows}, f, indent=0)
    r = np.array([row["residues"] for row in rows])
    print(f"{len(rows)} proteins: residues {r.min()}-{r.max()}, median {np.median(r):.0f}, "
          f"mean {r.mean():.0f}, p90 {np.percentile(r, 90):.0f} -> {OUT}")


if __name__ == "__main__":
    main()
