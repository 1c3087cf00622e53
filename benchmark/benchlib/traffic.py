"""The one traffic generator: a mix file's parameters and a seed in, the
proteins, ligands and pairs of a run out, as plain graph dicts (the
featurizer's contract) that the port's PairDataset and the plain reference
both take.

What a mix fixes, the same for every seed: the targets' residue and edge
counts (rows of data/davis_sizes.json, chosen by the mix), the ligands' atom
and ring counts (drawn from the mix's own ``size_seed``), the pairs and the
split shares. What the run's seed draws: every feature, type and edge
placement, the targets' pKd values, the order of the pairs, and the split.
So two seeds do the same amount of work in another order.

Proteins: node scalars 17 and vectors 3, edge scalars 32 and vector 1,
residue types in [0, 21), one edge type; self loops, then links to sequence
neighbours (i, i+1), then (i, i+2) and (i, i+3) as the table's edge count
needs, both directions. Ligands: node features 41, edge features 9, atom
types in [0, 10), bond types in [0, 5); a random spanning tree plus ring
closures, bonds both ways and a self loop on every atom.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from benchlib.spec import BENCH_DIR, load_json

# streams of the run seed
_PROTEIN, _LIGAND, _PAIRS = 1, 2, 3


@dataclass
class Traffic:
    proteins: dict      # id -> graph dict
    molecules: dict     # id -> graph dict
    pairs: list         # (protein id, molecule id)
    targets: np.ndarray  # f32 pKd per pair


def _graph(node_s, node_v, src, dst, edge_s, edge_v, node_type, edge_type) -> dict:
    return {"node_s": node_s, "node_v": node_v, "edge_index": np.stack([src, dst]).astype(np.int32),
            "edge_s": edge_s, "edge_v": edge_v, "node_type": node_type.astype(np.int32),
            "edge_type": edge_type.astype(np.int32), "n_nodes": int(len(node_s)),
            "n_edges": int(len(src))}


def protein_graph(rng: np.random.Generator, n: int, n_edges: int) -> dict:
    """A protein of ``n`` residues and ``n_edges`` directed edges (self loops
    included), its contacts between close sequence neighbours."""
    pairs_needed = (n_edges - n) // 2
    cands = [np.stack([np.arange(n - k), np.arange(k, n)], 1) for k in (1, 2, 3) if n > k]
    chosen = []
    for c in cands:
        take = min(pairs_needed - sum(len(x) for x in chosen), len(c))
        if take <= 0:
            break
        chosen.append(c[np.sort(rng.choice(len(c), take, replace=False))])
    links = np.concatenate(chosen) if chosen else np.zeros((0, 2), np.int64)
    self_loops = np.arange(n)
    src = np.concatenate([self_loops, links[:, 0], links[:, 1]])
    dst = np.concatenate([self_loops, links[:, 1], links[:, 0]])
    e = len(src)
    return _graph(rng.standard_normal((n, 17), np.float32),
                  rng.standard_normal((n, 3, 3), np.float32), src, dst,
                  rng.standard_normal((e, 32), np.float32),
                  rng.standard_normal((e, 1, 3), np.float32),
                  rng.integers(0, 21, n), np.zeros(e, np.int64))


def ligand_graph(rng: np.random.Generator, n: int, rings: int) -> dict:
    """A ligand of ``n`` heavy atoms: a spanning tree, ``rings`` ring
    closures, bonds both ways and a self loop per atom."""
    parent = np.array([i - 1 if rng.random() < 0.7 else rng.integers(0, i) for i in range(1, n)])
    bonds = set(zip(range(1, n), parent.tolist()))
    tries = 0
    while len(bonds) < n - 1 + rings and tries < 1000:
        a, b = sorted(rng.choice(n, 2, replace=False).tolist())
        if b - a >= 2 and (b, a) not in bonds and (a, b) not in bonds:
            bonds.add((b, a))
        tries += 1
    bonds = np.array(sorted(bonds))
    src = np.concatenate([np.arange(n), bonds[:, 0], bonds[:, 1]])
    dst = np.concatenate([np.arange(n), bonds[:, 1], bonds[:, 0]])
    e = len(src)
    return _graph(rng.standard_normal((n, 41), np.float32), None, src, dst,
                  rng.standard_normal((e, 9), np.float32), None,
                  rng.integers(0, 10, n), rng.integers(0, 5, e))


def target_sizes(spec: dict) -> list:
    """(residues, edges) of the mix's targets: every row of the table, or
    ``count`` rows at evenly spaced quantiles of the residue counts."""
    rows = load_json(os.path.join(BENCH_DIR, "data", spec["table"]))["proteins"]
    sizes = sorted((r["residues"], r["edges"]) for r in rows)
    if spec["select"] == "all":
        return sizes
    k = spec["count"]
    return [sizes[int((i + 0.5) * len(sizes) / k)] for i in range(k)]


def ligand_sizes(spec: dict, size_seed: int) -> list:
    """(atoms, rings) of the mix's ligands, fixed by ``size_seed``."""
    rng = np.random.default_rng(size_seed)
    out = []
    for _ in range(spec["count"]):
        lo, hi = spec["tail_atoms"] if rng.random() < spec["tail_share"] else spec["atoms"]
        out.append((int(rng.integers(lo, hi + 1)), int(rng.integers(spec["rings"][0],
                                                                    spec["rings"][1] + 1))))
    return out


def generate(mix: dict, seed: int) -> Traffic:
    """The run's traffic: every target against every ligand, in an order
    drawn from ``seed``."""
    t_sizes = target_sizes(mix["targets"])
    l_sizes = ligand_sizes(mix["ligands"], mix["size_seed"])
    rng_p = np.random.default_rng([seed, _PROTEIN])
    rng_l = np.random.default_rng([seed, _LIGAND])
    rng = np.random.default_rng([seed, _PAIRS])
    proteins = {i: protein_graph(rng_p, n, e) for i, (n, e) in enumerate(t_sizes)}
    molecules = {i: ligand_graph(rng_l, n, r) for i, (n, r) in enumerate(l_sizes)}
    pairs = [(p, m) for p in proteins for m in molecules]
    order = rng.permutation(len(pairs))
    pairs = [pairs[i] for i in order]
    targets = (5.5 + 0.9 * rng.standard_normal(len(pairs))).astype(np.float32)
    return Traffic(proteins, molecules, pairs, targets)
