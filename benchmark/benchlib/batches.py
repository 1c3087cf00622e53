"""The reference's own padded batches, made from the run's graph dicts.

The program decides which pairs share a batch and the bucket they are
padded to; the reference is told those two things and pads the graphs
itself, to the graphs' layout contract (nodes in order and zero-padded,
edges sorted by (dst, src) and masked after the real ones), so that a mask
of the explainer or of dropout lands on the same node or edge on both
sides."""
from __future__ import annotations

import numpy as np
import torch


def pad(graph: dict, n_pad: int, e_pad: int) -> dict:
    n, e = graph["n_nodes"], graph["n_edges"]
    src, dst = graph["edge_index"]
    order = np.lexsort((src, dst))
    nv = 0 if graph["node_v"] is None else graph["node_v"].shape[1]
    ev = 0 if graph["edge_v"] is None else graph["edge_v"].shape[1]
    out = {"node_s": np.zeros((n_pad, graph["node_s"].shape[1]), np.float32),
           "node_v": np.zeros((n_pad, nv, 3), np.float32),
           "node_type": np.zeros(n_pad, np.int32), "node_mask": np.zeros(n_pad, bool),
           "edge_src": np.zeros(e_pad, np.int32), "edge_dst": np.zeros(e_pad, np.int32),
           "edge_s": np.zeros((e_pad, graph["edge_s"].shape[1]), np.float32),
           "edge_v": np.zeros((e_pad, ev, 3), np.float32),
           "edge_type": np.zeros(e_pad, np.int32), "edge_mask": np.zeros(e_pad, bool)}
    out["node_s"][:n] = graph["node_s"]
    out["node_type"][:n] = graph["node_type"]
    out["node_mask"][:n] = True
    out["edge_src"][:e], out["edge_dst"][:e] = src[order], dst[order]
    out["edge_s"][:e] = graph["edge_s"][order]
    out["edge_type"][:e] = graph["edge_type"][order]
    out["edge_mask"][:e] = True
    if nv:
        out["node_v"][:n] = graph["node_v"]
    if ev:
        out["edge_v"][:e] = graph["edge_v"][order]
    return out


def stack(graphs: list, device) -> dict:
    return {k: torch.from_numpy(np.stack([g[k] for g in graphs])).to(device) for k in graphs[0]}


def reference_batch(traffic, pair_ids, bucket, device, targets=None, weight=None) -> dict:
    """The batch of ``pair_ids`` (one entry a row, padding rows included)
    padded to ``bucket`` = (N_pad, E_pad, A_pad, M_pad) -> protein and
    molecule tensors on ``device``, and the targets and weights when given."""
    n_p, e_p, n_m, e_m = bucket
    prots = [pad(traffic.proteins[traffic.pairs[i][0]], n_p, e_p) for i in pair_ids]
    mols = [pad(traffic.molecules[traffic.pairs[i][1]], n_m, e_m) for i in pair_ids]
    out = {"protein": stack(prots, device), "molecule": stack(mols, device)}
    if targets is not None:
        out["target"] = torch.as_tensor(np.asarray(targets, np.float32), device=device)
        out["weight"] = torch.as_tensor(np.asarray(weight, np.float32), device=device)
    return out


def fit_bucket(traffic, pair_ids) -> tuple:
    """The smallest bucket that holds ``pair_ids`` (for per-pair outputs,
    which padding does not change)."""
    p = [traffic.proteins[traffic.pairs[i][0]] for i in pair_ids]
    m = [traffic.molecules[traffic.pairs[i][1]] for i in pair_ids]
    return (max(g["n_nodes"] for g in p), max(g["n_edges"] for g in p),
            max(g["n_nodes"] for g in m), max(g["n_edges"] for g in m))
