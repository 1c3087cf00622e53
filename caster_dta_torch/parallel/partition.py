"""Edge-partitioned graph parallelism: one large protein graph across ranks
(counterpart of caster_dta_tpu/parallel/partition.py).

The reference bounds protein size instead of scaling it (3,000-residue cap,
dataset/load_data.py:218-222). Here a protein graph too large for the bucket
ladder is split over the ``gp`` ranks of a mesh (parallel/mesh.py), one
process per device, and message passing exchanges the boundary ("halo")
features before each conv layer.

- **Nodes** are block-partitioned: rank ``g`` of the gp group owns rows
  ``[g*Ns, (g+1)*Ns)``. Node-wise work (input GVPs, norms, residuals,
  feedforward, output head) needs nothing from the other ranks.
- **Edges** live with the rank that owns their destination, in an
  **interior block** (source local too) and a **boundary block** (source on
  another rank). Each block stays sorted by destination, so aggregation is
  the single-device sorted segment-sum, and degrees are exact: each edge
  lives on one rank, and 'mean' divides once by the combined degree.
- **Halo exchange**: before each conv layer every rank gathers the rows
  that its peers' boundary edges read (``send_idx``, kernel K2 on the card)
  and one ``all_to_all_single`` over the gp group delivers them
  (``_exchange_halo``). Only the boundary block needs them; the interior
  block runs first. The exchange is differentiable, so gradients flow back
  through it.
- The partitioned tower is the lbamodel tower with another forward
  (``PartitionedLBAProteinGNN`` subclasses ``VectorProteinGNN_LBAModel``),
  so the state dict, ``interop/from_jax.py`` and the JAX package's param
  tree apply unchanged.
- Planning is numpy, vectorized, and the JAX package's bit for bit
  (``partition_protein_graph``), with the same budget errors.

The joint model (``PartitionedJointGNN``) gathers the residue embeddings and
mask over gp and runs the molecule tower and the head on every gp member.
The gradient contract is JAX's ``pmean`` over gp: every member scales its
loss by ``1/G`` and the gradients are summed over the world; the gather's
backward sums the members' gradients of the gathered rows, so the redundant
head and molecule gradients come out exact.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from caster_dta_torch.data.graphs import GraphBatch
from caster_dta_torch.models.joint import JointGNN
from caster_dta_torch.models.protein import VectorProteinGNN_LBAModel
from caster_dta_torch.nn import gvp
from caster_dta_torch.nn.common import compute_dtype, dropout_shards, f32_precision
from caster_dta_torch.ops import segment
from caster_dta_torch.parallel.mesh import Mesh


@dataclass
class ShardedProteinGraph:
    """One protein graph partitioned over G shards (leading axis = shard), or
    B of them stacked (``stack_sharded``: leaves ``[B, G, ...]``), or one
    rank's part of a stacked batch (``local``: leaves ``[B, ...]``).

    Shapes: G shards, Ns nodes a shard, Ei interior and Eb boundary edges a
    shard, H halo slots a peer. Interior edges have both ends local
    (``int_src`` in [0, Ns)); boundary edges read remote sources through the
    halo rows (``bnd_src_ext`` indexes ``concat(local Ns rows, halo G*H
    rows)``). Both dst arrays are local and sorted ascending (pad Ns-1).
    ``send_idx[g, p, :]`` lists the local rows shard g sends peer p at each
    exchange (where ``send_mask`` is 1)."""

    node_s: torch.Tensor        # f32 [G, Ns, ds]
    node_v: torch.Tensor        # f32 [G, Ns, dv, 3]
    node_type: torch.Tensor     # i32 [G, Ns]
    node_mask: torch.Tensor     # bool [G, Ns]
    int_src: torch.Tensor       # i32 [G, Ei] local
    int_dst: torch.Tensor       # i32 [G, Ei] local, sorted; pad = Ns-1
    int_s: torch.Tensor         # f32 [G, Ei, es]
    int_v: torch.Tensor         # f32 [G, Ei, ev, 3]
    int_type: torch.Tensor      # i32 [G, Ei]
    int_mask: torch.Tensor      # bool [G, Ei]
    bnd_src_ext: torch.Tensor   # i32 [G, Eb] in [0, Ns + G*H)
    bnd_dst: torch.Tensor       # i32 [G, Eb] local, sorted; pad = Ns-1
    bnd_s: torch.Tensor         # f32 [G, Eb, es]
    bnd_v: torch.Tensor         # f32 [G, Eb, ev, 3]
    bnd_type: torch.Tensor      # i32 [G, Eb]
    bnd_mask: torch.Tensor      # bool [G, Eb]
    send_idx: torch.Tensor      # i32 [G, G, H] local node rows to send to peer
    send_mask: torch.Tensor     # f32 [G, G, H] 1.0 for real halo slots

    @property
    def n_shards(self) -> int:
        return self.node_s.shape[0]

    @property
    def nodes_per_shard(self) -> int:
        return self.node_s.shape[1]

    @property
    def halo_per_peer(self) -> int:
        return self.send_idx.shape[2]

    def local(self, gp_rank: int) -> "ShardedProteinGraph":
        """A stacked batch's shard ``gp_rank``: leaves ``[B, ...]``."""
        return _map(self, lambda a: a[:, gp_rank])

    def to(self, device) -> "ShardedProteinGraph":
        return _map(self, lambda a: a.to(device))


def _map(sh: ShardedProteinGraph, fn: Callable) -> ShardedProteinGraph:
    return ShardedProteinGraph(**{f.name: fn(getattr(sh, f.name))
                                  for f in dataclasses.fields(sh)})


def stack_sharded(graphs) -> ShardedProteinGraph:
    """Stack B ShardedProteinGraphs of the same budgets into ``[B, G, ...]``
    leaves (the batch-first layout the partitioned steps take)."""
    return ShardedProteinGraph(**{f.name: torch.stack([getattr(g, f.name) for g in graphs])
                                  for f in dataclasses.fields(graphs[0])})


def partition_protein_graph(
    node_s: np.ndarray,
    node_v: np.ndarray,
    edge_index: np.ndarray,     # [2, E] (src, dst) global, real edges only
    edge_s: np.ndarray,
    edge_v: np.ndarray,
    node_type: np.ndarray,
    edge_type: np.ndarray,
    n_shards: int,
    nodes_per_shard: Optional[int] = None,
    interior_edges_per_shard: Optional[int] = None,
    boundary_edges_per_shard: Optional[int] = None,
    halo_per_peer: Optional[int] = None,
) -> ShardedProteinGraph:
    """Host-side partition planning for one (unpadded) protein graph —
    fully vectorized (sort/bincount/unique/searchsorted; no per-edge Python).

    Pads node/edge/halo counts up to static per-shard budgets (computed from
    the graph when not given; give explicit budgets to share one compiled
    executable across the graphs of a bucket).
    """
    node_s = np.asarray(node_s, np.float32)
    n = node_s.shape[0]
    g_ = n_shards
    ns = nodes_per_shard or -(-n // g_)
    if ns * g_ < n:
        raise ValueError(f"nodes_per_shard {ns} too small for {n} nodes on {g_} shards")

    edge_index = np.asarray(edge_index)
    src, dst = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    edge_s = np.asarray(edge_s, np.float32)[order]
    edge_v = np.asarray(edge_v, np.float32)[order]
    edge_type = np.asarray(edge_type, np.int64)[order]

    owner = dst // ns                     # dst shard owns the edge
    src_owner = src // ns
    is_bnd = src_owner != owner

    e_int = np.bincount(owner[~is_bnd], minlength=g_)
    e_bnd = np.bincount(owner[is_bnd], minlength=g_)
    ei = interior_edges_per_shard or max(int(e_int.max()), 1)
    eb = boundary_edges_per_shard or max(int(e_bnd.max()), 1)
    if e_int.max() > ei:
        raise ValueError(f"interior_edges_per_shard {ei} too small "
                         f"(max {e_int.max()})")
    if e_bnd.max() > eb:
        raise ValueError(f"boundary_edges_per_shard {eb} too small "
                         f"(max {e_bnd.max()})")

    # ------------------------------------------------------- halo planning
    # unique (dst_shard g, src_shard h, src u) triples over boundary edges;
    # np.unique(axis=0) sorts lexicographically, so rows group by (g, h)
    # with u ascending inside each group.
    if is_bnd.any():
        triples = np.unique(np.stack(
            [owner[is_bnd], src_owner[is_bnd], src[is_bnd]], axis=1), axis=0)
        gh = triples[:, 0] * g_ + triples[:, 1]
        group_keys, group_starts, group_counts = np.unique(
            gh, return_index=True, return_counts=True)
        h_needed = int(group_counts.max())
    else:
        triples = np.zeros((0, 3), np.int64)
        group_keys = np.zeros(0, np.int64)
        group_starts = np.zeros(0, np.int64)
        group_counts = np.zeros(0, np.int64)
        h_needed = 0
    hh = halo_per_peer if halo_per_peer is not None else max(h_needed, 1)
    if h_needed > hh:
        raise ValueError(f"halo_per_peer {hh} too small (max {h_needed})")

    ds_, dv_ = node_s.shape[1], (np.asarray(node_v).shape[1] if node_v is not None else 0)
    node_v = (np.asarray(node_v, np.float32) if node_v is not None
              else np.zeros((n, 0, 3), np.float32))
    node_type = np.asarray(node_type, np.int64)

    out = dict(
        node_s=np.zeros((g_, ns, ds_), np.float32),
        node_v=np.zeros((g_, ns, dv_, 3), np.float32),
        node_type=np.zeros((g_, ns), np.int32),
        node_mask=np.zeros((g_, ns), bool),
        int_src=np.zeros((g_, ei), np.int32),
        int_dst=np.full((g_, ei), ns - 1, np.int32),
        int_s=np.zeros((g_, ei, edge_s.shape[1]), np.float32),
        int_v=np.zeros((g_, ei) + edge_v.shape[1:], np.float32),
        int_type=np.zeros((g_, ei), np.int32),
        int_mask=np.zeros((g_, ei), bool),
        bnd_src_ext=np.zeros((g_, eb), np.int32),
        bnd_dst=np.full((g_, eb), ns - 1, np.int32),
        bnd_s=np.zeros((g_, eb, edge_s.shape[1]), np.float32),
        bnd_v=np.zeros((g_, eb) + edge_v.shape[1:], np.float32),
        bnd_type=np.zeros((g_, eb), np.int32),
        bnd_mask=np.zeros((g_, eb), bool),
        send_idx=np.zeros((g_, g_, hh), np.int32),
        send_mask=np.zeros((g_, g_, hh), np.float32),
    )

    # nodes: one reshape-style block copy per shard
    for gsh in range(g_):
        lo, hi = gsh * ns, min((gsh + 1) * ns, n)
        cnt = hi - lo
        if cnt > 0:
            out["node_s"][gsh, :cnt] = node_s[lo:hi]
            out["node_v"][gsh, :cnt] = node_v[lo:hi]
            out["node_type"][gsh, :cnt] = node_type[lo:hi]
            out["node_mask"][gsh, :cnt] = True

    # send lists: slot p of (owner h, reader g) = p-th smallest needed id
    slot_of_triple = np.zeros(len(triples), np.int64)
    for k, start, cnt in zip(group_keys, group_starts, group_counts):
        slot_of_triple[start:start + cnt] = np.arange(cnt)
        gsh, h = int(k) // g_, int(k) % g_
        ids = triples[start:start + cnt, 2]
        out["send_idx"][h, gsh, :cnt] = ids - h * ns
        out["send_mask"][h, gsh, :cnt] = 1.0

    # boundary src -> extended index ns + h*H + slot, via a lex-sorted lookup
    # of (g, h, u) into the triples table
    if is_bnd.any():
        b_g, b_h, b_u = owner[is_bnd], src_owner[is_bnd], src[is_bnd]
        key_all = (triples[:, 0] * g_ + triples[:, 1]) * (n + 1) + triples[:, 2]
        key_q = (b_g * g_ + b_h) * (n + 1) + b_u
        pos = np.searchsorted(key_all, key_q)
        bnd_ext_all = ns + b_h * hh + slot_of_triple[pos]

    # per-shard edge block fill: boolean masks keep dst-sorted order
    pos_in_shard = np.empty(len(dst), np.int64)
    for gsh in range(g_):
        sel_i = np.nonzero((owner == gsh) & ~is_bnd)[0]
        out["int_src"][gsh, :len(sel_i)] = src[sel_i] - gsh * ns
        out["int_dst"][gsh, :len(sel_i)] = dst[sel_i] - gsh * ns
        out["int_s"][gsh, :len(sel_i)] = edge_s[sel_i]
        out["int_v"][gsh, :len(sel_i)] = edge_v[sel_i]
        out["int_type"][gsh, :len(sel_i)] = edge_type[sel_i]
        out["int_mask"][gsh, :len(sel_i)] = True

        sel_b = np.nonzero((owner == gsh) & is_bnd)[0]
        if len(sel_b):
            bnd_positions = np.nonzero((b_g == gsh))[0] if is_bnd.any() else []
            out["bnd_src_ext"][gsh, :len(sel_b)] = bnd_ext_all[bnd_positions]
            out["bnd_dst"][gsh, :len(sel_b)] = dst[sel_b] - gsh * ns
            out["bnd_s"][gsh, :len(sel_b)] = edge_s[sel_b]
            out["bnd_v"][gsh, :len(sel_b)] = edge_v[sel_b]
            out["bnd_type"][gsh, :len(sel_b)] = edge_type[sel_b]
            out["bnd_mask"][gsh, :len(sel_b)] = True

    return ShardedProteinGraph(**{k: torch.from_numpy(v) for k, v in out.items()})


def _exchange_halo(feat: torch.Tensor, send_idx: torch.Tensor, send_mask: torch.Tensor,
                   mesh: Mesh) -> torch.Tensor:
    """One halo exchange over the gp group, batched over pairs.

    feat [B, Ns, F] this rank's rows; send_idx/send_mask [B, G, H]. Returns
    the halo rows [B, G*H, F]: rows ``h*H:(h+1)*H`` are what rank h of the
    gp group sent (its rows this rank's boundary edges read; masked slots 0).
    """
    b, g, h = send_idx.shape
    buf = segment.gather_nodes(feat, send_idx.reshape(b, g * h))      # K2 on the card
    buf = buf.reshape(b, g, h, -1) * send_mask[..., None].to(buf.dtype)
    # part p of the leading axis goes to peer p; part q of the result came
    # from peer q
    recv = mesh.all_to_all_grad(buf.transpose(0, 1), "gp")
    return recv.transpose(0, 1).reshape(b, g * h, -1)


def halo_bytes(sh: ShardedProteinGraph, width: int, itemsize: int = 4) -> int:
    """Bytes a rank sends at one exchange of rows ``width`` wide, from its
    shard ``sh`` (``ShardedProteinGraph.local``: send_idx [B, G, H]): every
    slot, real or masked, as the all-to-all moves them, its own part
    included."""
    return sh.send_idx.numel() * width * itemsize


class PartitionedLBAProteinGNN(VectorProteinGNN_LBAModel):
    """``VectorProteinGNN_LBAModel`` running a graph partitioned over the gp
    group of ``mesh``: ``forward(sh, mesh)`` takes this rank's shard (leaves
    ``[B, ...]``, ``ShardedProteinGraph.local``) and returns its rows of the
    per-residue scalars ``[B, Ns, out]``.

    The parameters and their names are the lbamodel tower's (it is a
    subclass with another forward). Each conv layer exchanges the halo, runs
    the interior block and then the boundary block (GVPConvLayer's
    ``boundary``). Dropout masks are global-canonical over the node rows
    (``shard_rows``), so training with dropout is the single-device model's."""

    def forward(self, sh: ShardedProteinGraph, mesh: Mesh,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = (torch.cat([self.ntype_embedding(sh.node_type), sh.node_s], dim=-1), sh.node_v)
        # both edge blocks through the same input GVP and norm, each in its
        # own shape
        ei = (torch.cat([self.etype_embedding(sh.int_type), sh.int_s], dim=-1), sh.int_v)
        eb = (torch.cat([self.etype_embedding(sh.bnd_type), sh.bnd_s], dim=-1), sh.bnd_v)
        for layer in self.gvp_node:
            x = layer(x)
        for layer in self.gvp_edge:
            ei, eb = layer(ei), layer(eb)
        shard_rows = (mesh.gp_rank, mesh.gp)
        for conv in self.conv_list:
            nv = x[1].shape[-2]
            halo_s, halo_v = gvp.split_sv(
                _exchange_halo(gvp.merge_sv(*x), sh.send_idx, sh.send_mask, mesh), nv)
            x_ext = (torch.cat([x[0], halo_s], dim=1), torch.cat([x[1], halo_v], dim=1))
            x = conv(x, sh.int_src, sh.int_dst, sh.int_mask, ei, generator=generator,
                     boundary=(x_ext, sh.bnd_src_ext, sh.bnd_dst, sh.bnd_mask, eb),
                     shard_rows=shard_rows)
        s, _ = self.gvp_to_scalar(self.gvp_norm_before_scalar(x))
        return s


class PartitionedJointGNN(JointGNN):
    """JointGNN whose protein tower runs edge-partitioned over the gp group:
    ``forward(sharded, molecule, mesh)`` takes this rank's shard of B pairs
    (leaves ``[B, ...]``) and the B molecules, gathers the residue
    embeddings and mask over gp into ``[B, G*Ns, D]``, and runs the molecule
    tower and the head on every gp member. The batch is this dp row's share,
    so dropout is global-canonical over dp (rows) and, in the tower, over gp
    (node rows). The parameters are JointGNN's."""

    def forward(self, sharded: ShardedProteinGraph, molecule: GraphBatch, mesh: Mesh,
                return_attention: bool = True, generator: Optional[torch.Generator] = None):
        tower = self.protein_gnn.gnn_model
        if not isinstance(tower, VectorProteinGNN_LBAModel):
            raise NotImplementedError("partitioned protein tower supports base_conv='lbamodel'")
        with dropout_shards({0: (mesh.dp_rank, mesh.n_dp)} if mesh.n_dp > 1 else {}):
            res_local = PartitionedLBAProteinGNN.forward(tower, sharded, mesh, generator)
            residue = mesh.gather_grad(res_local, "gp", dim=1)           # [B, G*Ns, D]
            mask = mesh.gather(sharded.node_mask.to(torch.uint8), "gp", dim=1).bool()
            atom = self.molecule_gnn.gnn_model(molecule, generator=generator)
            return self.head(residue, atom, mask, molecule.node_mask, return_attention,
                             generator)


def from_joint(model: JointGNN) -> PartitionedJointGNN:
    """The partitioned twin of a JointGNN: the same modules and parameters,
    shared, not copied (a step on either trains both)."""
    twin = PartitionedJointGNN.__new__(PartitionedJointGNN)
    twin.__dict__ = model.__dict__
    return twin


def _batched(sh: ShardedProteinGraph) -> ShardedProteinGraph:
    return _map(sh, lambda a: a[None])


def run_partitioned(model: VectorProteinGNN_LBAModel, sharded: ShardedProteinGraph,
                    mesh: Mesh, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The partitioned tower on ONE graph (leaves ``[G, ...]``) over the gp
    group -> per-residue scalars ``[G*Ns, out]`` in global node order, on
    every rank (this rank's rows computed here, the rest gathered)."""
    local = _batched(sharded).local(mesh.gp_rank).to(mesh.device)
    out = PartitionedLBAProteinGNN.forward(model, local, mesh, generator)     # [1, Ns, out]
    return mesh.gather_grad(out, "gp", dim=1)[0]


def run_partitioned_joint(model: JointGNN, sharded: ShardedProteinGraph,
                          molecule: GraphBatch, mesh: Mesh,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Forward pairs whose proteins are partitioned over gp: ``sharded`` is one
    graph (leaves ``[G, ...]``) or B stacked (``[B, G, ...]``), ``molecule``
    their B molecules -> score [B, 1], on every rank of the gp group."""
    if sharded.node_s.dim() == 3:
        sharded = _batched(sharded)
    local = sharded.local(mesh.gp_rank).to(mesh.device)
    score, _ = from_joint(model)(local, molecule.to(mesh.device), mesh, return_attention=False,
                                 generator=generator)
    return score


def local_batch(batch, mesh: Mesh) -> tuple:
    """This rank's part of a PartitionedPairBatch on its device: the dp row's
    pairs, the gp rank's shard -> (sharded, molecule, target, weight)."""
    from caster_dta_torch.parallel.mesh import shard_batch

    mine = shard_batch(batch, mesh, "dp")
    dev = mesh.device
    return (mine.sharded.local(mesh.gp_rank).to(dev), mine.molecule.to(dev),
            mine.target.to(dev), mine.weight.to(dev))


def partitioned_train_step(model: JointGNN, optimizer: torch.optim.Optimizer, mesh: Mesh):
    """A deterministic train step (dropout off) over the ``dp x gp`` mesh:
    ``step(sharded [B, G, ...], molecule [B], target [B]) -> loss``. The loss
    is the mean squared error over the B pairs (the dp rows' local means
    averaged, JAX's pmean over dp); each member's loss is scaled by 1/G and
    the gradients are summed over the world, JAX's pmean over gp. Training
    inside ``fit`` uses ``make_partitioned_fit_steps``."""
    from caster_dta_torch.data.batching import PartitionedPairBatch

    twin = from_joint(model)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(sharded, molecule, target):
        pairs = PartitionedPairBatch(sharded, molecule, target, torch.ones_like(target),
                                     torch.arange(len(target), dtype=torch.int32))
        sh, mol, t, _ = local_batch(pairs, mesh)
        was = model.training
        model.train(False)
        try:
            score, _ = twin(sh, mol, mesh, return_attention=False)
        finally:
            model.train(was)
        err = torch.mean((score[:, 0] - t) ** 2) / mesh.n_dp
        grads = torch.autograd.grad(err / mesh.gp, params)
        *grads, loss = mesh.all_reduce_grads(list(grads) + [err.detach().reshape(1)])
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        for p in params:
            p.grad = None
        return loss[0] / mesh.gp

    return step


def make_partitioned_fit_steps(model: JointGNN, mesh: Mesh, apply_grads: Callable,
                               generator: Optional[torch.Generator] = None,
                               dtype: Optional[torch.dtype] = None):
    """(train_step, eval_step) for ``fit``'s partitioned sub-epochs, with the
    JAX package's step contract.

    ``train_step(batch, lr) -> (loss, pred [B])`` and ``eval_step(batch) ->
    pred [B]`` take a data/batching.py PartitionedPairBatch (sharded leaves
    ``[B, G, ...]``, molecules ``[B]``, targets and weights ``[B]``) and
    return the whole batch's values on every rank. The loss is
    ``sum(w (pred - t)^2) / max(sum(w), 1)`` with both sums over the dp group
    (JAX's psum) before the division; every member scales it by 1/G and the
    gradients are summed over the world, then ``apply_grads(grads, lr)``
    (the trainer's accumulation, clipping and optimizer) runs. Padded pairs
    carry weight 0. Dropout draws from ``generator`` with global-canonical
    masks, so the step is the single-device step on the same batch. Steps
    run eagerly, in the compute dtype ``dtype``."""
    twin = from_joint(model)
    params = [p for p in model.parameters() if p.requires_grad]

    def forward(sh, mol, gen):
        with f32_precision(), compute_dtype(dtype):
            score, _ = twin(sh, mol, mesh, return_attention=False, generator=gen)
        return score[:, 0].to(torch.float32)

    def train_step(batch, lr):
        sh, mol, t, w = local_batch(batch, mesh)
        model.train(True)
        with f32_precision():
            pred = forward(sh, mol, generator)
            den = mesh.all_reduce(w.sum(), "dp")
            loss = torch.sum(w * (pred - t) ** 2) / torch.clamp(den, min=1.0)
            grads = torch.autograd.grad(loss / mesh.gp, params)
            *grads, loss = mesh.all_reduce_grads(list(grads) + [loss.detach().reshape(1)])
            apply_grads(grads, lr)
        return loss[0] / mesh.gp, mesh.gather(pred.detach(), "dp")

    @torch.no_grad()
    def eval_step(batch):
        sh, mol, _, _ = local_batch(batch, mesh)
        model.train(False)
        return mesh.gather(forward(sh, mol, None), "dp")

    return train_step, eval_step
