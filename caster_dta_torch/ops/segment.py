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
``segment_max`` and ``segment_softmax`` are not on the trained path yet.
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


def aggregate(messages: torch.Tensor, dst: torch.Tensor, edge_mask: torch.Tensor,
              num_nodes: int, mode: str) -> torch.Tensor:
    """Dispatch on aggregation mode ('sum'/'add' or 'mean')."""
    if mode in ("sum", "add"):
        return segment_sum(messages, dst, edge_mask, num_nodes)
    if mode == "mean":
        return segment_mean(messages, dst, edge_mask, num_nodes)
    if mode == "max":
        raise NotImplementedError("segment_max is not ported yet")
    raise ValueError(f"unknown aggregation mode: {mode!r}")
