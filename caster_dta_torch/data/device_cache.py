"""Device-resident graph store: batches assemble on the card, not the host
(counterpart of caster_dta_tpu/data/device_cache.py).

Each bucket's deduplicated padded graphs are stacked once (``stack_graphs``)
and copied to the device once. A batch is then ``store[rows]`` along dim 0
of every GraphBatch field (``index_select`` on the device), so only the int32
rows, the targets and the weights go from the host each step, packed into one
int32 array (``pack_batch_rows``) and copied in one transfer; a megabatch's
[k, B] arrays go up in one transfer too.

``DeviceResidentLoader.maybe`` returns the plain BucketedLoader when the
stores would exceed the byte budget, as in the JAX package.

Under data parallelism (parallel/mesh.py) every rank builds the whole store
on its own device and gathers only its rows of each batch
(``mesh.shard_batch`` of a StoreBatch or MegaBatch): the JAX package's
``store_sharding=replicated``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from caster_dta_torch.data.batching import BucketedLoader, PairBatch
from caster_dta_torch.data.graphs import GraphBatch, stack_graphs
from caster_dta_torch.device import resolve_device

# int32 words: each field of packed row arrays starts a multiple of 64 bytes
# after the array's start, so views of a field are aligned alike wherever they
# lie (elementwise and reduction kernels pick their vector width from alignment)
FIELD_ALIGN = 16


def field_words(b: int) -> int:
    """int32 words of one field of batch size ``b``, padded to FIELD_ALIGN."""
    return -(-b // FIELD_ALIGN) * FIELD_ALIGN


def pack_batch_rows(p_rows, m_rows, target, weight) -> np.ndarray:
    """One int32 array [..., 4 * field_words(B)] of a batch's (or k batches')
    p_rows, m_rows (int32 [..., B]), target and weight (f32 bits), each from
    a multiple of FIELD_ALIGN words."""
    p_rows = np.asarray(p_rows, np.int32)
    lead, b = p_rows.shape[:-1], p_rows.shape[-1]
    bp = field_words(b)
    out = np.zeros(lead + (4 * bp,), np.int32)
    for i, a in enumerate((p_rows, np.asarray(m_rows, np.int32),
                           np.asarray(target, np.float32).view(np.int32),
                           np.asarray(weight, np.float32).view(np.int32))):
        out[..., i * bp: i * bp + b] = a
    return out


def unpack_batch_rows(packed: torch.Tensor, b: int) -> tuple:
    """Views (p_rows, m_rows, target, weight) of one packed batch [4 * field_words(b)]."""
    bp = field_words(b)
    p_rows, m_rows, target, weight = (packed[i * bp: i * bp + b] for i in range(4))
    return p_rows, m_rows, target.view(torch.float32), weight.view(torch.float32)


def upload(packed: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host-to-device copy of a packed array (from pinned memory on the
    card, so the host does not wait for it)."""
    t = torch.from_numpy(packed)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def take(store: GraphBatch, rows: torch.Tensor) -> GraphBatch:
    """The batch ``store[rows]``: every field's rows along dim 0, on the
    store's device."""
    return GraphBatch(**{f.name: getattr(store, f.name).index_select(0, rows)
                         for f in dataclasses.fields(store)})


@dataclass
class MegaBatch:
    """A bucket's epoch of batches as one dispatch unit: the per-step arrays
    are [k, B] (k = batches this bucket holds this epoch), on the host; the
    stores are the bucket's, on the device."""

    bucket: tuple
    p_store: GraphBatch     # [P, ...] on the device
    m_store: GraphBatch     # [M, ...]
    p_rows: np.ndarray      # i32 [k, B]
    m_rows: np.ndarray      # i32 [k, B]
    target: np.ndarray      # f32 [k, B]
    weight: np.ndarray      # f32 [k, B]
    pair_idx: np.ndarray    # i32 [k, B]

    @property
    def n_steps(self) -> int:
        return self.p_rows.shape[0]

    def batch(self, j: int) -> "StoreBatch":
        """Step j as a StoreBatch."""
        return StoreBatch(self.p_store, self.m_store, *(
            torch.from_numpy(a[j].copy()) for a in (self.p_rows, self.m_rows, self.target,
                                                     self.weight, self.pair_idx)))


@dataclass
class StoreBatch:
    """A batch as (device-resident stores + rows): stands in for a PairBatch.
    ``.protein``/``.molecule`` gather the store's rows; ``.to(device)`` gives
    the PairBatch on the stores' device after one host-to-device copy of the
    rows, targets and weights. The host arrays are CPU tensors."""

    p_store: GraphBatch
    m_store: GraphBatch
    p_rows: torch.Tensor     # i32 [B]
    m_rows: torch.Tensor     # i32 [B]
    target: torch.Tensor     # f32 [B]
    weight: torch.Tensor     # f32 [B]
    pair_idx: torch.Tensor   # i32 [B]

    @property
    def protein(self) -> GraphBatch:
        return take(self.p_store, self.p_rows.to(self.p_store.node_s.device))

    @property
    def molecule(self) -> GraphBatch:
        return take(self.m_store, self.m_rows.to(self.m_store.node_s.device))

    @property
    def bucket(self):
        return (self.p_store.n_pad, self.p_store.e_pad, self.m_store.n_pad, self.m_store.e_pad)

    def to(self, device) -> PairBatch:
        device = torch.device(device)
        store_device = self.p_store.node_s.device
        if (device.type, device.index or 0) != (store_device.type, store_device.index or 0):
            raise ValueError(f"the store lies on {store_device}, not on {device}")
        p_rows, m_rows, target, weight = unpack_batch_rows(upload(pack_batch_rows(
            self.p_rows.numpy(), self.m_rows.numpy(), self.target.numpy(),
            self.weight.numpy()), store_device), len(self.p_rows))
        return PairBatch(take(self.p_store, p_rows), take(self.m_store, m_rows), target, weight,
                         self.pair_idx)


def _graph_nbytes(n_pad, e_pad, ds, dv, es, ev) -> int:
    node = n_pad * (4 * ds + 12 * dv + 4 + 1)
    edge = e_pad * (4 * es + 12 * ev + 4 + 4 + 4 + 1)
    return node + edge


class DeviceResidentLoader:
    """BucketedLoader-compatible iterator with batch assembly on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, loader: BucketedLoader, device: str | torch.device = "cuda"):
        self.loader = loader
        self.dataset = loader.dataset
        self.device = resolve_device(device)
        # per bucket: stacked GraphBatch stores and key -> row maps
        self._p_store: dict = {}
        self._m_store: dict = {}
        self._p_rows: dict = {}
        self._m_rows: dict = {}
        self._n_edges: dict = {}   # (kind, key) -> real edge count
        self.last_batch_edges = 0
        self._build_stores()

    # ------------------------------------------------------------------ build
    def _build_stores(self) -> None:
        ds = self.dataset
        for b, idxs in self.loader.buckets().items():
            n_p, e_p, n_m, e_m = b
            pkeys = list(dict.fromkeys(ds.pair_indices[i][0] for i in idxs))
            mkeys = list(dict.fromkeys(ds.pair_indices[i][1] for i in idxs))
            self._p_rows[b] = {k: r for r, k in enumerate(pkeys)}
            self._m_rows[b] = {k: r for r, k in enumerate(mkeys)}
            self._p_store[b] = stack_graphs([
                self.loader._padded_graph("p", k, ds.protein_data[k], n_p, e_p)
                for k in pkeys]).to(self.device)
            self._m_store[b] = stack_graphs([
                self.loader._padded_graph("m", k, ds.molecule_data[k], n_m, e_m)
                for k in mkeys]).to(self.device)
            for k in pkeys:
                self._n_edges[("p", k)] = int(ds.protein_data[k]["n_edges"])
            for k in mkeys:
                self._n_edges[("m", k)] = int(ds.molecule_data[k]["n_edges"])
        # the stores hold every padded graph now; the loader's host copies go
        self.loader._pad_cache.clear()

    @classmethod
    def estimate_store_bytes(cls, loader: BucketedLoader) -> int:
        ds = loader.dataset
        md = ds.metadata_dict
        pds, pdv = md["protein_node_features"]
        pes, pev = md["protein_edge_features"]
        mds = md["molecule_node_features"]
        mes = md["molecule_edge_features"]
        total = 0
        for b, idxs in loader.buckets().items():
            n_p, e_p, n_m, e_m = b
            pids = {ds.pair_indices[i][0] for i in idxs}
            mids = {ds.pair_indices[i][1] for i in idxs}
            total += len(pids) * _graph_nbytes(n_p, e_p, pds, pdv, pes, pev)
            total += len(mids) * _graph_nbytes(n_m, e_m, mds, 0, mes, 0)
        return total

    @classmethod
    def maybe(cls, loader: BucketedLoader, budget_bytes: Optional[int] = 4_000_000_000,
              device: str | torch.device = "cuda"):
        """Wrap when the stores fit the budget; else return the loader as it is."""
        if budget_bytes is not None and cls.estimate_store_bytes(loader) > budget_bytes:
            return loader
        return cls(loader, device=device)

    # ------------------------------------------------------------------- iter
    def __len__(self) -> int:
        return len(self.loader)

    def buckets(self) -> dict:
        return self.loader.buckets()

    def _index_batch_arrays(self, b, idxs):
        """Host arrays of a batch (rows, target, weight, pair_idx) and its
        real-edge count, shared by the per-batch and megabatch paths."""
        ds = self.dataset
        bs = self.loader.bucket_batch_size(b)
        weight = np.zeros(bs, np.float32)
        weight[: len(idxs)] = 1.0
        full = list(idxs) + [idxs[-1]] * (bs - len(idxs))
        p_rows = np.asarray([self._p_rows[b][ds.pair_indices[i][0]] for i in full], np.int32)
        m_rows = np.asarray([self._m_rows[b][ds.pair_indices[i][1]] for i in full], np.int32)
        target = np.asarray([ds.affinity_data[i] for i in full], np.float32)
        n_edges = sum(self._n_edges[("p", ds.pair_indices[i][0])]
                      + self._n_edges[("m", ds.pair_indices[i][1])] for i in idxs)
        return p_rows, m_rows, target, weight, np.asarray(full, np.int32), n_edges

    def iter_megabatches(self):
        """Yield (MegaBatch, real edges per step) per bucket over this epoch's
        batches. Within a bucket the batches keep the epoch's shuffle order;
        the buckets come in a seeded per-epoch order, (seed, epoch, 0xB), as
        in the JAX package."""
        epoch = self.loader.epoch   # iter_index_batches increments it
        groups: dict = {}
        for b, idxs in self.loader.iter_index_batches():
            groups.setdefault(b, []).append(self._index_batch_arrays(b, idxs))
        keys = sorted(groups)
        if self.loader.shuffle:
            keys = [keys[j] for j in np.random.default_rng(
                (self.loader.seed, epoch, 0xB)).permutation(len(keys))]
        for b in keys:
            rows = groups[b]
            yield (MegaBatch(b, self._p_store[b], self._m_store[b],
                             *(np.stack([r[i] for r in rows]) for i in range(5))),
                   [r[5] for r in rows])

    def __iter__(self):
        for b, idxs in self.loader.iter_index_batches():
            p_rows, m_rows, target, weight, pair_idx, n_edges = self._index_batch_arrays(b, idxs)
            # the real-edge count from the host, for the throughput meter
            self.last_batch_edges = n_edges
            yield StoreBatch(self._p_store[b], self._m_store[b], *(
                torch.from_numpy(a) for a in (p_rows, m_rows, target, weight, pair_idx)))
