"""Padded, statically shaped graph batches (counterpart of
caster_dta_tpu/data/graphs.py).

Every graph of a batch is padded to one ``(N_pad, E_pad)`` bucket: node arrays
are dense ``[B, N_pad, ...]``; edges are ``[B, E_pad]`` with per-graph local
indices, sorted by ``(dst, src)`` so aggregation is a sorted segment-sum
(ops/segment.py); padding edges carry ``dst = N_pad - 1`` and are masked.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class GraphBatch:
    """A batch of B graphs padded to N_pad nodes / E_pad edges each.
    ``node_v`` is ``[B, N, dv, 3]`` (``dv`` may be 0, as for molecules)."""

    node_s: torch.Tensor      # f32 [B, N, ds]
    node_v: torch.Tensor      # f32 [B, N, dv, 3]
    node_type: torch.Tensor   # i32 [B, N]
    node_mask: torch.Tensor   # bool [B, N]
    edge_src: torch.Tensor    # i32 [B, E] (local node index)
    edge_dst: torch.Tensor    # i32 [B, E] (sorted ascending; pad = N-1)
    edge_s: torch.Tensor      # f32 [B, E, es]
    edge_v: torch.Tensor      # f32 [B, E, ev, 3]
    edge_type: torch.Tensor   # i32 [B, E]
    edge_mask: torch.Tensor   # bool [B, E]

    def to(self, device) -> "GraphBatch":
        return GraphBatch(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})

    @property
    def batch_size(self) -> int:
        return self.node_s.shape[0]

    @property
    def n_pad(self) -> int:
        return self.node_s.shape[1]

    @property
    def e_pad(self) -> int:
        return self.edge_src.shape[1]

    @property
    def n_node(self) -> torch.Tensor:
        """Number of real nodes per graph, i32 [B]."""
        return self.node_mask.sum(dim=1).to(torch.int32)

    @property
    def n_edge(self) -> torch.Tensor:
        """Number of real edges per graph, i32 [B]."""
        return self.edge_mask.sum(dim=1).to(torch.int32)


def _as2d(x: np.ndarray | None, n: int) -> np.ndarray:
    if x is None:
        return np.zeros((n, 0), dtype=np.float32)
    x = np.asarray(x, dtype=np.float32)
    return x[:, None] if x.ndim == 1 else x


def pad_graph(node_s, node_v, edge_index, edge_s, edge_v, node_type, edge_type,
              n_pad: int, e_pad: int) -> dict:
    """Pad one graph to (n_pad, e_pad), sorting edges by (dst, src).

    edge_index is ``[2, E_real]`` rows (src, dst). Returns a dict of numpy
    arrays keyed like GraphBatch's fields, without the batch dim. Raises if
    the graph exceeds the pad sizes."""
    node_s = np.asarray(node_s, dtype=np.float32)
    n = node_s.shape[0]
    edge_index = np.asarray(edge_index)
    e = edge_index.shape[1]
    if n > n_pad:
        raise ValueError(f"graph has {n} nodes > n_pad={n_pad}")
    if e > e_pad:
        raise ValueError(f"graph has {e} edges > e_pad={e_pad}")

    node_v = np.zeros((n, 0, 3), np.float32) if node_v is None else np.asarray(node_v, np.float32)
    edge_v = np.zeros((e, 0, 3), np.float32) if edge_v is None else np.asarray(edge_v, np.float32)
    edge_s = _as2d(edge_s, e)

    # sorted by destination: the layout the segment kernels rely on
    src, dst = edge_index[0].astype(np.int32), edge_index[1].astype(np.int32)
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    edge_s, edge_v = edge_s[order], edge_v[order]
    edge_type = np.asarray(edge_type).reshape(-1)[order].astype(np.int32)

    out = {
        "node_s": np.zeros((n_pad, node_s.shape[1]), np.float32),
        "node_v": np.zeros((n_pad, node_v.shape[1], 3), np.float32),
        "node_type": np.zeros((n_pad,), np.int32),
        "node_mask": np.zeros((n_pad,), bool),
        "edge_src": np.zeros((e_pad,), np.int32),
        "edge_dst": np.full((e_pad,), max(n_pad - 1, 0), np.int32),
        "edge_s": np.zeros((e_pad, edge_s.shape[1]), np.float32),
        "edge_v": np.zeros((e_pad, edge_v.shape[1], 3), np.float32),
        "edge_type": np.zeros((e_pad,), np.int32),
        "edge_mask": np.zeros((e_pad,), bool),
    }
    out["node_s"][:n] = node_s
    out["node_v"][:n] = node_v
    out["node_type"][:n] = np.asarray(node_type).reshape(-1).astype(np.int32)
    out["node_mask"][:n] = True
    out["edge_src"][:e] = src
    out["edge_dst"][:e] = dst
    out["edge_s"][:e] = edge_s
    out["edge_v"][:e] = edge_v
    out["edge_type"][:e] = edge_type
    out["edge_mask"][:e] = True
    return out


def stack_graphs(padded: list[dict]) -> GraphBatch:
    """Stack pad_graph() outputs (all of one pad shape) into a CPU batch."""
    return GraphBatch(**{k: torch.from_numpy(np.stack([p[k] for p in padded]))
                         for k in padded[0]})
