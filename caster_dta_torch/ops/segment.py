"""Segment (gather/scatter) ops over padded, dst-sorted edge lists.

Counterpart of caster_dta_tpu/ops/segment.py, with the same dispatch points:
a CUDA tensor goes to the hand-written kernels of ops/cuda_segment.py (K2 for
the row gather, K1 for the sorted segment-sum, K3 for the gather's backward),
a CPU tensor to their plain PyTorch versions (``index_select``,
``index_add_``).

Both ops are autograd Functions with the JAX package's backward formulas
(``_gather_rows_seg_bwd`` and ``pallas_segment._bwd``), on either device:

* gather: the backward is a K3 scatter-add of the cotangent by the same
  index, accumulated in f32 and cast back to the cotangent's dtype;
* segment_sum: the backward casts the f32 cotangent to the message dtype
  first, gathers it by ``dst`` with K2 and zeroes the masked edges.

Indices and masks get no gradient.

Layout contract (data/graphs.py): the edges of each graph are sorted by
destination node; padding edges point at ``dst = N-1`` and are masked.

``segment_max`` is computed as the JAX package computes it, outside any
kernel (there ``jax.ops.segment_max``): one ``scatter_reduce`` of the masked
rows over the merged ids ``b * N + dst``, on either device. Its gradient is
torch's, which splits a row's cotangent evenly among the messages that tie
for its max, as XLA's scatter-max JVP does. ``segment_softmax`` runs its
per-edge gathers through K2 and its denominators through K1.
"""
from __future__ import annotations

import torch

from caster_dta_torch.ops import cuda_segment


class _GatherRows(torch.autograd.Function):
    """table [B, N, F], idx [B, E] -> [B, E, F] (K2); backward K3."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_nodes = table.shape[1]
        return cuda_segment.gather_rows(table, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        grad = cuda_segment.scatter_rows(ct.contiguous(), idx, ctx.num_nodes)
        return grad.to(ct.dtype), None


class _SegmentSum(torch.autograd.Function):
    """msgs [B, E, F], dst [B, E] sorted, mask [B, E] -> [B, N, F] f32 (K1);
    backward a K2 gather of the cotangent by dst, masked."""

    @staticmethod
    def forward(ctx, msgs, dst, mask, num_nodes):
        ctx.save_for_backward(dst, mask)
        ctx.msg_dtype = msgs.dtype
        return cuda_segment.segment_sum_sorted(msgs, dst, mask, num_nodes)

    @staticmethod
    def backward(ctx, g):
        dst, mask = ctx.saved_tensors
        # cast to the message dtype BEFORE the gather, as the JAX VJP does
        grad = cuda_segment.gather_rows(g.to(ctx.msg_dtype).contiguous(), dst)
        grad = torch.where(mask[..., None], grad, torch.zeros((), dtype=grad.dtype,
                                                               device=grad.device))
        return grad, None, None, None


def gather_nodes(node_feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """node_feat [B, N, ...], idx int32 [B, E] -> [B, E, ...]: one row gather
    over the flattened trailing dims."""
    b, n = node_feat.shape[:2]
    trailing = node_feat.shape[2:]
    flat = node_feat.reshape(b, n, -1).contiguous()
    out = _GatherRows.apply(flat, idx.contiguous())
    return out.reshape(idx.shape + trailing)


def segment_sum(messages: torch.Tensor, dst: torch.Tensor, edge_mask: torch.Tensor,
                num_nodes: int) -> torch.Tensor:
    """Sum per-edge messages [B, E, ...] into destination nodes -> [B, N, ...].
    dst int32 [B, E] sorted per graph; edge_mask bool [B, E]. The sum is taken
    in f32 and cast back to the message dtype."""
    b, e = dst.shape
    trailing = messages.shape[2:]
    flat = messages.reshape(b, e, -1).contiguous()
    out = _SegmentSum.apply(flat, dst.contiguous(), edge_mask.contiguous(), num_nodes)
    return out.reshape((b, num_nodes) + trailing).to(messages.dtype)


def segment_degree(dst: torch.Tensor, edge_mask: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Count of real incoming edges per node, f32 [B, N]."""
    return segment_sum(edge_mask.to(torch.float32)[..., None], dst, edge_mask, num_nodes)[..., 0]


def segment_mean(messages: torch.Tensor, dst: torch.Tensor, edge_mask: torch.Tensor,
                 num_nodes: int) -> torch.Tensor:
    """Mean of the real incoming messages per node (padding never counts)."""
    total = segment_sum(messages, dst, edge_mask, num_nodes)
    deg = segment_degree(dst, edge_mask, num_nodes).clamp(min=1.0)
    return total / deg.reshape(deg.shape + (1,) * (total.dim() - 2))


def segment_max(messages: torch.Tensor, dst: torch.Tensor, edge_mask: torch.Tensor,
                num_nodes: int, fill: float = 0.0) -> torch.Tensor:
    """Max of the real incoming messages per node; a node with no real edge
    (its max not finite) gets ``fill``. The rows start at -inf, so only a
    row that no real message reaches can tie with its start value."""
    b, e = dst.shape
    trailing = messages.shape[2:]
    neg = torch.full((), float("-inf"), dtype=messages.dtype, device=messages.device)
    flat = torch.where(edge_mask.reshape((b, e) + (1,) * len(trailing)), messages, neg)
    flat = flat.reshape(b * e, -1)
    ids = (dst.long() + num_nodes * torch.arange(b, device=dst.device)[:, None]).reshape(-1, 1)
    start = torch.full((b * num_nodes, flat.shape[1]), float("-inf"), dtype=messages.dtype,
                       device=messages.device)
    out = start.scatter_reduce(0, ids.expand_as(flat), flat, "amax", include_self=False)
    out = torch.where(torch.isfinite(out), out, torch.full((), fill, dtype=out.dtype,
                                                           device=out.device))
    return out.reshape((b, num_nodes) + trailing)


def segment_softmax(logits: torch.Tensor, dst: torch.Tensor, edge_mask: torch.Tensor,
                    num_nodes: int) -> torch.Tensor:
    """Softmax of per-edge logits [B, E, H] over the edges of each
    destination, stable by the row max (not detached, as in JAX); masked
    edges get weight exactly 0 and the denominator is clamped at 1e-16."""
    m = segment_max(logits, dst, edge_mask, num_nodes, fill=0.0)
    exp = torch.where(edge_mask[..., None], torch.exp(logits - gather_nodes(m, dst)),
                      torch.zeros((), dtype=logits.dtype, device=logits.device))
    denom = segment_sum(exp, dst, edge_mask, num_nodes)
    return exp / torch.clamp(gather_nodes(denom, dst), min=1e-16)


def aggregate(messages: torch.Tensor, dst: torch.Tensor, edge_mask: torch.Tensor,
              num_nodes: int, mode: str) -> torch.Tensor:
    """Dispatch on aggregation mode ('sum'/'add', 'mean' or 'max')."""
    if mode in ("sum", "add"):
        return segment_sum(messages, dst, edge_mask, num_nodes)
    if mode == "mean":
        return segment_mean(messages, dst, edge_mask, num_nodes)
    if mode == "max":
        return segment_max(messages, dst, edge_mask, num_nodes)
    raise ValueError(f"unknown aggregation mode: {mode!r}")
