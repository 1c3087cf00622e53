"""Scalar graph convolutions over padded batches (counterpart of
caster_dta_tpu/nn/conv.py): GINE, GATv2 and HEAT.

GINEConv and GATv2Conv take the state-dict names of the PyG operators their
JAX counterparts cite, whose leaves they match one for one. HEATConv takes
the JAX module's names: its attention (a linear layer to H x C, then a
per-head vector) is not PyG's. The attention convs' softmax runs through
ops/segment.py (K2 for the per-edge gathers, K1 for the sums), and their
attention dropout draws from the generator the caller passes.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from caster_dta_torch.nn.common import MLP, Dense, dropout, leaky_relu, uniform_
from caster_dta_torch.ops import segment


def _glorot(shape: tuple, generator: Optional[torch.Generator]) -> nn.Parameter:
    """Glorot-uniform over the last two dims, as flax's glorot_uniform and
    PyG's glorot give a [..., H, C] attention vector."""
    t = torch.empty(shape)
    uniform_(t, math.sqrt(6.0 / (shape[-2] + shape[-1])), generator)
    return nn.Parameter(t)


def _heads_out(out: torch.Tensor, concat: bool) -> torch.Tensor:
    """[..., H, C] -> [..., H C] (concat) or the head mean [..., C]."""
    return out.reshape(out.shape[:-2] + (-1,)) if concat else out.mean(dim=-2)


class GINEConv(nn.Module):
    """GIN with edge features: out = MLP((1+eps)*x_i + aggr_j ReLU(x_j + W_e e_ij)),
    MLP([in, out, out]). Names follow PyG: ``eps``, ``lin``, ``nn.lins.{i}``."""

    def __init__(self, in_channels: int, out_channels: int, edge_dim: int, act="relu",
                 train_eps: bool = True, aggr: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aggr = aggr
        if train_eps:
            self.eps = nn.Parameter(torch.zeros(1))
        else:
            self.register_buffer("eps", torch.zeros(1))
        self.lin = Dense(edge_dim, in_channels, generator=generator)
        self.nn = MLP((in_channels, out_channels, out_channels), act=act, generator=generator)

    def forward(self, x, edge_src, edge_dst, edge_mask, edge_attr):
        x_j = segment.gather_nodes(x, edge_src)
        msg = F.relu(x_j + self.lin(edge_attr))
        agg = segment.aggregate(msg, edge_dst, edge_mask, x.shape[1], self.aggr)
        return self.nn((1.0 + self.eps) * x + agg)


class GATv2Conv(nn.Module):
    """pyg.nn.GATv2Conv with edge features and without self-loops:
    alpha_ij = softmax_j(att . LeakyReLU(lin_l x_i + lin_r x_j + lin_edge e_ij))
    per head, out_i = aggr_j alpha_ij lin_r x_j, heads concatenated or
    averaged, then the bias. ``edge_dim`` None: no edge term."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2, dropout: float = 0.0,
                 aggr: str = "sum", edge_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.heads, self.out_channels, self.concat = heads, out_channels, concat
        self.negative_slope, self.dropout, self.aggr = negative_slope, dropout, aggr
        self.lin_l = Dense(in_channels, heads * out_channels, generator=g)
        self.lin_r = Dense(in_channels, heads * out_channels, generator=g)
        self.lin_edge = (Dense(edge_dim, heads * out_channels, bias=False, generator=g)
                         if edge_dim is not None else None)
        self.att = _glorot((1, heads, out_channels), g)
        self.bias = nn.Parameter(torch.zeros(heads * out_channels if concat else out_channels))

    @property
    def out_dim(self) -> int:
        return self.heads * self.out_channels if self.concat else self.out_channels

    def forward(self, x, edge_src, edge_dst, edge_mask, edge_attr=None,
                generator: Optional[torch.Generator] = None):
        h, c, n = self.heads, self.out_channels, x.shape[1]
        x_l = self.lin_l(x).reshape(x.shape[:-1] + (h, c))
        x_r = self.lin_r(x).reshape(x.shape[:-1] + (h, c))
        xj = segment.gather_nodes(x_r, edge_src)                 # x_j: lin_r at the source
        z = segment.gather_nodes(x_l, edge_dst) + xj             # x_i: lin_l at the destination
        if edge_attr is not None and self.lin_edge is not None:
            z = z + self.lin_edge(edge_attr).reshape(edge_attr.shape[:-1] + (h, c))
        z = leaky_relu(z, self.negative_slope)
        alpha = segment.segment_softmax((z * self.att).sum(-1), edge_dst, edge_mask, n)
        alpha = dropout(alpha, self.dropout, self.training, generator)
        # the weights sum to 1 per destination; PyG applies ``aggr`` on top
        out = segment.aggregate(xj * alpha[..., None], edge_dst, edge_mask, n, self.aggr)
        return _heads_out(out, self.concat) + self.bias


class HEATConv(nn.Module):
    """Heterogeneous edge-attribute transformer conv (pyg.nn.HEATConv as the
    JAX package writes it): a per-node-type projection ``hetero_kernel``,
    the ReLU of an edge-type embedding and a bias-free projection of the edge
    attributes drive GATv2-style attention through ``att_lin`` and ``att``;
    the messages are the projected source rows, weighted per head.

    The per-type projection is one matmul of the rows against every type's
    kernel ([B, N, T, C]) and a select of each row's type, instead of JAX's
    gather of a kernel per row ([B, N, in, C]): T x C floats a row, not
    in x C, and the same dot products."""

    def __init__(self, in_channels: int, out_channels: int, num_node_types: int,
                 num_edge_types: int, edge_type_emb_dim: int, edge_dim: int,
                 edge_attr_emb_dim: int, heads: int = 1, concat: bool = True,
                 negative_slope: float = 0.2, dropout: float = 0.0, aggr: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.heads, self.out_channels, self.concat = heads, out_channels, concat
        self.negative_slope, self.dropout, self.aggr = negative_slope, dropout, aggr
        self.hetero_kernel = _glorot((num_node_types, in_channels, out_channels), g)
        self.hetero_bias = nn.Parameter(torch.zeros(num_node_types, out_channels))
        emb = torch.empty(num_edge_types, edge_type_emb_dim)
        with torch.no_grad():
            emb.normal_(0.0, 1.0, generator=g)
        self.edge_type_emb = nn.Embedding(num_edge_types, edge_type_emb_dim, _weight=emb)
        self.edge_attr_emb = Dense(edge_dim, edge_attr_emb_dim, bias=False, generator=g)
        self.att_lin = Dense(2 * out_channels + edge_type_emb_dim + edge_attr_emb_dim,
                             heads * out_channels, generator=g)
        self.att = _glorot((1, 1, heads, out_channels), g)

    @property
    def out_dim(self) -> int:
        return self.heads * self.out_channels if self.concat else self.out_channels

    def forward(self, x, edge_src, edge_dst, edge_mask, node_type, edge_type, edge_attr,
                generator: Optional[torch.Generator] = None):
        h, c, n = self.heads, self.out_channels, x.shape[1]
        t, d_in, _ = self.hetero_kernel.shape
        dt = torch.promote_types(x.dtype, self.hetero_kernel.dtype)
        # every type's projection and bias, then each row's own: the bias is
        # added before the select (the same sums as after it), so its
        # gradient is a reduction, not an accumulating index_put
        every = (x.to(dt) @ self.hetero_kernel.to(dt).permute(1, 0, 2).reshape(d_in, t * c)
                 + self.hetero_bias.to(dt).reshape(t * c))
        # a type past the last reads the last type's weights, as JAX's
        # kernels[node_type] gather clamps its index
        types = torch.clamp(node_type.long(), 0, t - 1)
        sel = types[..., None, None].expand(types.shape + (1, c))
        xp = every.reshape(x.shape[:-1] + (t, c)).gather(-2, sel)[..., 0, :]
        ete = F.relu(self.edge_type_emb(edge_type.long()))
        eae = self.edge_attr_emb(edge_attr)
        xj = segment.gather_nodes(xp, edge_src)
        # torch.cat promotes a bf16 eae to f32, as jnp.concatenate does
        z = self.att_lin(torch.cat([segment.gather_nodes(xp, edge_dst), xj, ete, eae], dim=-1))
        z = leaky_relu(z.reshape(z.shape[:-1] + (h, c)), self.negative_slope)
        alpha = segment.segment_softmax((z * self.att).sum(-1), edge_dst, edge_mask, n)
        alpha = dropout(alpha, self.dropout, self.training, generator)
        msg = xj[..., None, :] * alpha[..., None]                    # [B, E, H, C]
        out = segment.aggregate(msg, edge_dst, edge_mask, n, self.aggr)
        return _heads_out(out, self.concat)
