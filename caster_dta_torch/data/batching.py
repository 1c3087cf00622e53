"""Pair batches, static-shape bucketed batching and seeded synthetic pairs
(counterpart of caster_dta_tpu/data/batching.py).

Each pair goes to a static bucket (N_pad, E_pad, A_pad, M_pad) from geometric
ladders; the bucket's batch size comes from the reference's cost model,
``clamp(max_num // (E_pad + M_pad + N_pad * A_pad), 1, max_batch_size)``, and
partial batches are padded by repeating the last pair with loss weight 0.
``BucketedLoader`` makes the same bucket assignment, coalescing, epoch-indexed
shuffle and batches as the JAX loader, as torch CPU tensors.

``synthetic_pair_batch`` makes the same RNG calls, in the same order, as
``__graft_entry__._synthetic_batch`` of the JAX package, so one seed gives the
same batch in both packages. ``synthetic_pair_dataset`` makes an in-memory
dataset of graph dicts with the same feature widths.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

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
                         seed: int = 0, scalar_protein: bool = False) -> PairBatch:
    """B random protein/molecule pairs padded to (n_p, e_p) / (n_m, e_m):
    proteins with ~9 edges per residue (17 scalar + 3 vector node channels,
    32 + 1 edge channels, 20 residue types; with ``scalar_protein`` in the
    scalar layout of ``scalar_protein_graph``), molecules with ~4 edges per
    atom (41 node and 9 edge channels, 11 atom and 5 bond types)."""
    rng = np.random.default_rng(seed)
    prots, mols = [], []
    for _ in range(b):
        nr = int(rng.integers(max(n_p // 2, 4), n_p + 1))
        er = min(e_p, nr * 9)
        src = np.clip(np.repeat(np.arange(nr), 9)[:er]
                      + rng.integers(-4, 5, er), 0, nr - 1)
        dst = np.repeat(np.arange(nr), 9)[:er]
        prot = _graph(rng.normal(size=(nr, 17)).astype(np.float32),
                      rng.normal(size=(nr, 3, 3)).astype(np.float32), np.stack([src, dst]),
                      rng.normal(size=(er, 32)).astype(np.float32),
                      rng.normal(size=(er, 1, 3)).astype(np.float32),
                      rng.integers(0, 20, nr), np.zeros(er))
        if scalar_protein:
            prot = scalar_protein_graph(prot)
        prots.append(pad_graph(**{k: v for k, v in prot.items() if k not in _COUNTS},
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


# ------------------------------------------------------------ bucketing

PROTEIN_NODE_LADDER = (32, 64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048,
                       3072, 4608)
MOLECULE_NODE_LADDER = (48, 128, 256, 384)
EDGE_LADDER = tuple(2 ** k for k in range(4, 21))
MOLECULE_EDGE_LADDER = (256, 1024, 4096)


def _ladder(value: int, ladder: Sequence[int]) -> int:
    for step in ladder:
        if value <= step:
            return step
    raise ValueError(f"size {value} exceeds largest bucket {ladder[-1]}")


def dataset_budgets(dataset_name: str):
    """Per-dataset element budget and max batch size (the reference's
    train_model.py:240-248)."""
    if dataset_name == "kiba":
        return 8_000_000, 64
    if dataset_name in ("bindingdb", "belka") or "bindingdb" in dataset_name:
        return 4_000_000, 32
    return 16_000_000, 128


class _LRUPadCache:
    """Byte-bounded LRU of padded per-graph arrays."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._d: OrderedDict = OrderedDict()
        self.nbytes = 0

    def get(self, key):
        hit = self._d.get(key)
        if hit is not None:
            self._d.move_to_end(key)
        return hit

    def put(self, key, entry: dict) -> None:
        if key in self._d:
            return
        self._d[key] = entry
        self.nbytes += sum(v.nbytes for v in entry.values())
        while self.nbytes > self.max_bytes and len(self._d) > 1:
            _, old = self._d.popitem(last=False)
            self.nbytes -= sum(v.nbytes for v in old.values())

    def clear(self) -> None:
        self._d.clear()
        self.nbytes = 0


class BucketedLoader:
    """Iterates PairBatches of static shape per bucket.

    ``dataset`` is any indexable of ``(protein graph dict, molecule graph
    dict, target)``; a graph dict holds ``node_s, node_v, edge_index, edge_s,
    edge_v, node_type, edge_type, n_nodes, n_edges``. When the dataset has
    ``pair_indices`` (pair -> (protein id, molecule id)), padded graphs are
    cached per protein and molecule, else per pair."""

    def __init__(self, dataset, indices: Optional[Sequence[int]] = None,
                 max_num: int = 12_000_000, max_batch_size: Optional[int] = 128,
                 shuffle: bool = True, seed: int = 0, include_nodepair: bool = True,
                 protein_node_ladder=PROTEIN_NODE_LADDER,
                 molecule_node_ladder=MOLECULE_NODE_LADDER,
                 edge_ladder=EDGE_LADDER, molecule_edge_ladder=MOLECULE_EDGE_LADDER,
                 coalesce: bool = True, coalesce_min_batches: int = 4,
                 pad_cache_bytes: int = 2_000_000_000):
        self.dataset = dataset
        self.indices = np.asarray(indices if indices is not None else np.arange(len(dataset)))
        self.max_num = max_num
        self.max_batch_size = max_batch_size or 1 << 30
        self.shuffle, self.seed, self.include_nodepair = shuffle, seed, include_nodepair
        # epoch-indexed shuffling: each epoch's order depends only on (seed, epoch)
        self.epoch = 0
        self._bucket_of = {}
        for i in self.indices:
            pg, mg, _ = dataset[int(i)]
            self._bucket_of[int(i)] = (_ladder(pg["n_nodes"], protein_node_ladder),
                                       _ladder(pg["n_edges"], edge_ladder),
                                       _ladder(mg["n_nodes"], molecule_node_ladder),
                                       _ladder(mg["n_edges"], molecule_edge_ladder))
        self._coalesce_min_batches = coalesce_min_batches
        if coalesce:
            self._coalesce_buckets()
        self._pad_cache = _LRUPadCache(pad_cache_bytes)
        self.last_batch_edges = 0

    def _coalesce_buckets(self) -> None:
        """Merge each bucket holding fewer than coalesce_min_batches full
        batches into the cheapest bucket that covers it (sorted, so
        deterministic)."""
        def cost(b):
            return b[1] + b[3] + b[0] * b[2]

        while True:
            groups = self.buckets()
            merged = False
            for b, idxs in sorted(groups.items()):
                if len(idxs) >= self.bucket_batch_size(b) * self._coalesce_min_batches:
                    continue
                cands = [c for c in groups if c != b and all(ci >= bi for ci, bi in zip(c, b))]
                if not cands:
                    continue
                target = min(cands, key=cost)
                for i in idxs:
                    self._bucket_of[i] = target
                merged = True
                break
            if not merged:
                return

    def bucket_batch_size(self, bucket) -> int:
        n_p, e_p, n_m, e_m = bucket
        cost = e_p + e_m + (n_p * n_m if self.include_nodepair else 0)
        return int(np.clip(self.max_num // max(cost, 1), 1, self.max_batch_size))

    def buckets(self) -> dict:
        out: dict = {}
        for i, b in self._bucket_of.items():
            out.setdefault(b, []).append(i)
        return out

    def iter_index_batches(self):
        """Yield (bucket, pair indices) groups in epoch order."""
        order = self.indices.copy()
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        self.epoch += 1
        queues: dict = {}
        for i in order:
            b = self._bucket_of[int(i)]
            q = queues.setdefault(b, [])
            q.append(int(i))
            if len(q) >= self.bucket_batch_size(b):
                yield b, q
                queues[b] = []
        for b, q in queues.items():   # partial batches, padded in _assemble
            if q:
                yield b, q

    def __iter__(self) -> Iterator[PairBatch]:
        for b, q in self.iter_index_batches():
            yield self._assemble(b, q)

    def __len__(self) -> int:
        return sum(-(-len(idxs) // self.bucket_batch_size(b))
                   for b, idxs in self.buckets().items())

    def _padded_graph(self, kind: str, key, graph: dict, n_pad: int, e_pad: int) -> dict:
        cache_key = (kind, key, n_pad, e_pad)
        hit = self._pad_cache.get(cache_key)
        if hit is None:
            hit = pad_graph(node_s=graph["node_s"], node_v=graph["node_v"],
                            edge_index=graph["edge_index"], edge_s=graph["edge_s"],
                            edge_v=graph["edge_v"], node_type=graph["node_type"],
                            edge_type=graph["edge_type"], n_pad=n_pad, e_pad=e_pad)
            self._pad_cache.put(cache_key, hit)
        return hit

    def _assemble(self, bucket, idxs) -> PairBatch:
        n_p, e_p, n_m, e_m = bucket
        bs = self.bucket_batch_size(bucket)
        weight = np.zeros(bs, np.float32)
        weight[:len(idxs)] = 1.0
        full_idxs = list(idxs) + [idxs[-1]] * (bs - len(idxs))
        pair_ids = getattr(self.dataset, "pair_indices", None)
        prots, mols, targets = [], [], []
        for i in full_idxs:
            pg, mg, target = self.dataset[i]
            pid, mid = pair_ids[i] if pair_ids is not None else (i, i)
            prots.append(self._padded_graph("p", pid, pg, n_p, e_p))
            mols.append(self._padded_graph("m", mid, mg, n_m, e_m))
            targets.append(target)
        self.last_batch_edges = sum(int(self.dataset[i][0]["n_edges"])
                                    + int(self.dataset[i][1]["n_edges"]) for i in idxs)
        return PairBatch(protein=stack_graphs(prots), molecule=stack_graphs(mols),
                         target=torch.tensor(np.asarray(targets, np.float32)),
                         weight=torch.from_numpy(weight),
                         pair_idx=torch.tensor(full_idxs, dtype=torch.int32))


# ------------------------------------------------------------ datasets

class PairDataset:
    """In-memory pairs over deduplicated protein and molecule graph stores:
    ``dataset[i] -> (protein graph dict, molecule graph dict, target)``.

    ``scale_output`` (a list of 'standardize', 'minmax', 'log', applied in
    order) rescales the targets as the reference's dataset does;
    ``unscale_target`` undoes it and ``rescale_params`` gives the
    ``dataset_rescale_params.json`` schema. ``metadata_dict`` gives the
    feature widths and type counts as the JAX package's
    ``ProteinMoleculeDataset`` does."""

    def __init__(self, proteins: dict, molecules: dict, pairs: Sequence, targets,
                 scale_output: Optional[Sequence[str]] = None):
        self.protein_data, self.molecule_data = proteins, molecules
        self.pair_indices = {i: (p, m) for i, (p, m) in enumerate(pairs)}
        self.affinity_data = np.asarray(targets, np.float32)
        self.scale_output = list(scale_output or [])
        self._factors: dict = {}
        a = self.affinity_data
        for kind in self.scale_output:
            if kind == "standardize":
                std = float(np.std(a, ddof=1))
                self._factors[kind] = {"scale_mean_factor": float(np.mean(a)),
                                       "scale_std_factor": std if std > 0 else 1.0}
                f = self._factors[kind]
                a = (a - f["scale_mean_factor"]) / f["scale_std_factor"]
            elif kind == "minmax":
                self._factors[kind] = {"scale_min_factor": float(np.min(a)),
                                       "scale_max_factor": float(np.max(a))}
                f = self._factors[kind]
                a = (a - f["scale_min_factor"]) / (f["scale_max_factor"] - f["scale_min_factor"])
                a = a * 2 - 1
            elif kind == "log":
                a = np.log1p(a)
            else:
                raise ValueError(f"unknown scale_output {kind!r}")
        self.affinity_data = np.asarray(a, np.float32)
        self.metadata_dict = self._feature_metadata()

    def _feature_metadata(self) -> dict:
        def widths(g):
            s, v, es, ev = (_width(g[k]) for k in ("node_s", "node_v", "edge_s", "edge_v"))
            return (s, v) if v else s, (es, ev) if ev else es

        def n_types(store, key):
            return int(max(int(g[key].max()) if g[key].size else 0 for g in store.values())) + 1

        p_node, p_edge = widths(next(iter(self.protein_data.values())))
        m_node, m_edge = widths(next(iter(self.molecule_data.values())))
        return {"protein_node_features": p_node, "protein_edge_features": p_edge,
                "molecule_node_features": m_node, "molecule_edge_features": m_edge,
                "protein_node_types": n_types(self.protein_data, "node_type"),
                "protein_edge_types": n_types(self.protein_data, "edge_type"),
                "molecule_node_types": n_types(self.molecule_data, "node_type"),
                "molecule_edge_types": n_types(self.molecule_data, "edge_type")}

    def __len__(self) -> int:
        return len(self.affinity_data)

    def __getitem__(self, idx):
        pid, mid = self.pair_indices[idx]
        return self.protein_data[pid], self.molecule_data[mid], self.affinity_data[idx]

    def unscale_target(self, values):
        values = np.asarray(values)
        for kind in self.scale_output[::-1]:
            f = self._factors.get(kind, {})
            if kind == "standardize":
                values = values * f["scale_std_factor"] + f["scale_mean_factor"]
            elif kind == "minmax":
                values = (values + 1) * 0.5
                values = (values * (f["scale_max_factor"] - f["scale_min_factor"])
                          + f["scale_min_factor"])
            elif kind == "log":
                values = np.expm1(values)
        return values

    def rescale_params(self) -> dict:
        return {"scale_output": list(self.scale_output),
                **{k: dict(v) for k, v in self._factors.items()}}


def _width(x) -> int:
    """The channels of a feature array ([n, c] or [n, c, 3]); 0 for None."""
    return 0 if x is None else int(np.asarray(x).shape[1])


def _protein(rng: np.random.Generator, n_nodes: int, n_edges: int) -> dict:
    """A protein graph dict with the trained config's widths: 17 scalar and 3
    vector node channels, 32 + 1 edge channels, residue types in [0, 20);
    each residue takes about n_edges / n_nodes edges from nearby residues."""
    deg = max(n_edges // n_nodes, 1)
    dst = np.repeat(np.arange(n_nodes), deg)[:n_edges]
    src = np.clip(dst + rng.integers(-4, 5, dst.size), 0, n_nodes - 1)
    return _graph(rng.normal(size=(n_nodes, 17)).astype(np.float32),
                  rng.normal(size=(n_nodes, 3, 3)).astype(np.float32),
                  np.stack([src, dst]),
                  rng.normal(size=(dst.size, 32)).astype(np.float32),
                  rng.normal(size=(dst.size, 1, 3)).astype(np.float32),
                  rng.integers(0, 20, n_nodes), np.zeros(dst.size, np.int64))


def _molecule(rng: np.random.Generator, n_nodes: int, n_edges: int) -> dict:
    """A molecule graph dict with the trained config's widths: 41 node and 9
    edge channels, atom types in [0, 10), bond types in [0, 5)."""
    return _graph(rng.normal(size=(n_nodes, 41)).astype(np.float32), None,
                  rng.integers(0, n_nodes, size=(2, n_edges)),
                  rng.normal(size=(n_edges, 9)).astype(np.float32), None,
                  rng.integers(0, 10, n_nodes), rng.integers(0, 5, n_edges))


_COUNTS = ("n_nodes", "n_edges")


def scalar_protein_graph(g: dict) -> dict:
    """A protein graph dict in the scalar layout that data/build.py gives
    with ``vectorize_features=False``: each node's and each edge's vector
    channels flattened onto its scalars (17 + 9 = 26 node and 32 + 3 = 35
    edge channels for the trained widths), no vector channels."""
    out = dict(g)
    for s, v in (("node_s", "node_v"), ("edge_s", "edge_v")):
        if g[v] is not None:
            out[s] = np.concatenate([g[s], g[v].reshape(len(g[v]), -1)], axis=-1)
            out[v] = None
    return out


def _graph(node_s, node_v, edge_index, edge_s, edge_v, node_type, edge_type) -> dict:
    return {"node_s": node_s, "node_v": node_v, "edge_index": edge_index, "edge_s": edge_s,
            "edge_v": edge_v, "node_type": node_type, "edge_type": edge_type,
            "n_nodes": int(node_s.shape[0]), "n_edges": int(edge_index.shape[1])}


def synthetic_pair_dataset(n_pairs: int, n_proteins: int, n_molecules: int,
                           protein_nodes: Sequence[tuple], molecule_nodes: tuple,
                           seed: int = 0, scalar_protein: bool = False) -> PairDataset:
    """Seeded pairs over ``n_proteins`` proteins and ``n_molecules``
    molecules, targets pKd-like around 5.5, standardized. Protein i draws its
    residue count from the inclusive range ``protein_nodes[i % len]`` and has
    8 edges per residue (with ``scalar_protein`` in the scalar layout of
    ``scalar_protein_graph``); each molecule draws its atom count from
    ``molecule_nodes`` and has 4 edges per atom."""
    rng = np.random.default_rng(seed)
    proteins = {}
    for i in range(n_proteins):
        lo, hi = protein_nodes[i % len(protein_nodes)]
        n = int(rng.integers(lo, hi + 1))
        proteins[i] = _protein(rng, n, 8 * n)
        if scalar_protein:
            proteins[i] = scalar_protein_graph(proteins[i])
    molecules = {}
    for i in range(n_molecules):
        n = int(rng.integers(molecule_nodes[0], molecule_nodes[1] + 1))
        molecules[i] = _molecule(rng, n, 4 * n)
    pairs = [(int(rng.integers(n_proteins)), int(rng.integers(n_molecules)))
             for _ in range(n_pairs)]
    return PairDataset(proteins, molecules, pairs, 5.5 + 0.9 * rng.normal(size=n_pairs),
                       scale_output=["standardize"])
