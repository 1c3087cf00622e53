"""Pair batches (counterpart of PairBatch in caster_dta_tpu/data/batching.py)
and a seeded synthetic-pair generator.

``synthetic_pair_batch`` makes the same RNG calls, in the same order, as
``__graft_entry__._synthetic_batch`` of the JAX package, so one seed gives the
same batch in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from caster_dta_torch.data.graphs import GraphBatch, pad_graph, stack_graphs


@dataclass
class PairBatch:
    protein: GraphBatch
    molecule: GraphBatch
    target: torch.Tensor     # f32 [B]
    weight: torch.Tensor     # f32 [B]; 0 for padding pairs
    pair_idx: torch.Tensor   # i32 [B] dataset indices

    def to(self, device) -> "PairBatch":
        return PairBatch(self.protein.to(device), self.molecule.to(device),
                         self.target.to(device), self.weight.to(device),
                         self.pair_idx.to(device))

    @property
    def bucket(self):
        return (self.protein.n_pad, self.protein.e_pad,
                self.molecule.n_pad, self.molecule.e_pad)


def synthetic_pair_batch(b: int, n_p: int, e_p: int, n_m: int, e_m: int,
                         seed: int = 0) -> PairBatch:
    """B random protein/molecule pairs padded to (n_p, e_p) / (n_m, e_m):
    proteins with ~9 edges per residue (17 scalar + 3 vector node channels,
    32 + 1 edge channels, 20 residue types), molecules with ~4 edges per atom
    (41 node and 9 edge channels, 11 atom and 5 bond types)."""
    rng = np.random.default_rng(seed)
    prots, mols = [], []
    for _ in range(b):
        nr = int(rng.integers(max(n_p // 2, 4), n_p + 1))
        er = min(e_p, nr * 9)
        src = np.clip(np.repeat(np.arange(nr), 9)[:er]
                      + rng.integers(-4, 5, er), 0, nr - 1)
        dst = np.repeat(np.arange(nr), 9)[:er]
        prots.append(pad_graph(
            node_s=rng.normal(size=(nr, 17)).astype(np.float32),
            node_v=rng.normal(size=(nr, 3, 3)).astype(np.float32),
            edge_index=np.stack([src, dst]),
            edge_s=rng.normal(size=(er, 32)).astype(np.float32),
            edge_v=rng.normal(size=(er, 1, 3)).astype(np.float32),
            node_type=rng.integers(0, 20, nr), edge_type=np.zeros(er),
            n_pad=n_p, e_pad=e_p))
        nm = int(rng.integers(max(n_m // 2, 4), n_m + 1))
        em = min(e_m, nm * 4)
        mols.append(pad_graph(
            node_s=rng.normal(size=(nm, 41)).astype(np.float32), node_v=None,
            edge_index=rng.integers(0, nm, size=(2, em)),
            edge_s=rng.normal(size=(em, 9)).astype(np.float32), edge_v=None,
            node_type=rng.integers(0, 11, nm),
            edge_type=rng.integers(0, 5, em), n_pad=n_m, e_pad=e_m))
    return PairBatch(protein=stack_graphs(prots), molecule=stack_graphs(mols),
                     target=torch.from_numpy(rng.normal(size=b).astype(np.float32)),
                     weight=torch.ones(b, dtype=torch.float32),
                     pair_idx=torch.arange(b, dtype=torch.int32))
