"""Scalar graph convolutions over padded batches (counterpart of
caster_dta_tpu/nn/conv.py): GINE, GIN, GATv2, GAT, GATE (AttentiveFP's first
conv), torch's GRUCell, HEAT and PNA.

GINEConv, GINConv, GATv2Conv and GATConv take the state-dict names of the
PyG operators their JAX counterparts cite, whose leaves they match one for
one (``lin`` of GATConv carries the JAX module's bias). GRUCell takes
torch.nn.GRUCell's names, the JAX module's two Dense layers split into
weight and bias. PNAConv takes pyg.nn.PNAConv's names (``edge_encoder``,
``pre_nns.{t}.0``, ``post_nns.{t}.0``, ``lin``). GATEConv takes PyG's names
where PyG's operator has the piece (``lin1``, ``lin2``, ``att_l``, ``att_r``,
``bias``) and the JAX name ``lin_dst`` for the projection PyG does not have;
HEATConv takes the JAX module's names: its attention (a linear layer to
H x C, then a per-head vector) is not PyG's. The attention convs' softmax
runs through ops/segment.py (K2 for the per-edge gathers, K1 for the sums),
and their attention dropout draws from the generator the caller passes.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from caster_dta_torch.nn.common import MLP, Dense, dropout, leaky_relu, linear, uniform_
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
        return self.nn((1.0 + _gin_eps(self.eps, x)) * x + agg)


def _gin_eps(eps: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A trained eps as it is; a fixed one (a buffer of zeros, as PyG keeps
    it) in x's dtype, as JAX's ``jnp.zeros((1,), x.dtype)``."""
    return eps if isinstance(eps, nn.Parameter) else eps.to(x.dtype)


class GINConv(nn.Module):
    """GIN without edge features: out = MLP((1+eps)*x_i + aggr_j x_j),
    MLP([in, out, out]). Names follow PyG: ``eps``, ``nn.lins.{i}``."""

    def __init__(self, in_channels: int, out_channels: int, act="relu",
                 train_eps: bool = True, aggr: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aggr = aggr
        if train_eps:
            self.eps = nn.Parameter(torch.zeros(1))
        else:
            self.register_buffer("eps", torch.zeros(1))
        self.nn = MLP((in_channels, out_channels, out_channels), act=act, generator=generator)

    def forward(self, x, edge_src, edge_dst, edge_mask):
        agg = segment.aggregate(segment.gather_nodes(x, edge_src), edge_dst, edge_mask,
                                x.shape[1], self.aggr)
        return self.nn((1.0 + _gin_eps(self.eps, x)) * x + agg)


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


class GATConv(nn.Module):
    """pyg.nn.GATConv (v1, AttentiveFP's later convs) as the JAX package
    writes it, without self-loops: xw = lin x, alpha_ij = softmax_j(
    LeakyReLU(att_src . xw_j + att_dst . xw_i)) per head, out_i = sum_j
    alpha_ij xw_j, heads concatenated or averaged, then the bias. ``lin``
    has a bias, as the JAX module's Dense does."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.heads, self.out_channels, self.concat = heads, out_channels, concat
        self.negative_slope, self.dropout = negative_slope, dropout
        self.lin = Dense(in_channels, heads * out_channels, generator=g)
        self.att_src = _glorot((1, heads, out_channels), g)
        self.att_dst = _glorot((1, heads, out_channels), g)
        self.bias = nn.Parameter(torch.zeros(heads * out_channels if concat else out_channels))

    @property
    def out_dim(self) -> int:
        return self.heads * self.out_channels if self.concat else self.out_channels

    def forward(self, x, edge_src, edge_dst, edge_mask,
                generator: Optional[torch.Generator] = None):
        h, c, n = self.heads, self.out_channels, x.shape[1]
        xw = self.lin(x).reshape(x.shape[:-1] + (h, c))
        a_src = (xw * self.att_src).sum(-1)                          # [B, N, H]
        a_dst = (xw * self.att_dst).sum(-1)
        logits = segment.gather_nodes(a_src, edge_src) + segment.gather_nodes(a_dst, edge_dst)
        alpha = segment.segment_softmax(leaky_relu(logits, self.negative_slope), edge_dst,
                                        edge_mask, n)
        alpha = dropout(alpha, self.dropout, self.training, generator)
        xj = segment.gather_nodes(xw, edge_src)
        out = segment.segment_sum(xj * alpha[..., None], edge_dst, edge_mask, n)
        return _heads_out(out, self.concat) + self.bias


class GATEConv(nn.Module):
    """AttentiveFP's first conv (pyg.nn.models.attentive_fp.GATEConv) as the
    JAX package writes it: with xe_j = [x_j || e_ij],
    a_j = LeakyReLU(att_l . ReLU(lin1 xe_j)) per edge,
    a_i = LeakyReLU(att_r . lin_dst x_i) per node, both slopes 0.2;
    alpha = softmax_j(a_j + a_i); out_i = sum_j alpha_ij lin2 xe_j + bias.
    ``att_l`` and ``att_r`` are PyG's [1, C]."""

    def __init__(self, in_channels: int, out_channels: int, edge_dim: int,
                 dropout: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, c = generator, out_channels
        self.dropout = dropout
        self.lin1 = Dense(in_channels + edge_dim, c, bias=False, generator=g)
        self.att_l = _glorot((1, c), g)
        self.att_r = _glorot((1, c), g)
        self.lin_dst = Dense(in_channels, c, bias=False, generator=g)
        self.lin2 = Dense(in_channels + edge_dim, c, bias=False, generator=g)
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, edge_src, edge_dst, edge_mask, edge_attr,
                generator: Optional[torch.Generator] = None):
        n = x.shape[1]
        # torch.cat promotes a bf16 x_j to f32, as jnp.concatenate does
        xe = torch.cat([segment.gather_nodes(x, edge_src), edge_attr], dim=-1)
        a_j = leaky_relu((F.relu(self.lin1(xe)) * self.att_l).sum(-1), 0.2)
        a_i = leaky_relu((self.lin_dst(x) * self.att_r).sum(-1), 0.2)
        a_i = segment.gather_nodes(a_i[..., None], edge_dst)[..., 0]
        alpha = segment.segment_softmax((a_j + a_i)[..., None], edge_dst, edge_mask, n)[..., 0]
        alpha = dropout(alpha, self.dropout, self.training, generator)
        out = segment.segment_sum(self.lin2(xe) * alpha[..., None], edge_dst, edge_mask, n)
        return out + self.bias


class GRUCell(nn.Module):
    """torch.nn.GRUCell's parameters (``weight_ih`` [3H, in], ``weight_hh``
    [3H, H], ``bias_ih``, ``bias_hh``; gates r, z, n; its init) computed by
    the port's ``linear``, so the bf16 policy applies as to JAX's two Dense
    layers: n = tanh(i_n + r * h_n), where h_n holds b_hn;
    h' = (1 - z) * n + z * h."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden_size)
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.bias_ih = nn.Parameter(torch.empty(3 * hidden_size))
        self.bias_hh = nn.Parameter(torch.empty(3 * hidden_size))
        for t in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh):
            uniform_(t, bound, generator)

    def forward(self, inp: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        i_r, i_z, i_n = linear(inp, self.weight_ih, self.bias_ih).chunk(3, dim=-1)
        h_r, h_z, h_n = linear(h, self.weight_hh, self.bias_hh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


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


class PNAConv(nn.Module):
    """pyg.nn.PNAConv with towers and divide_input=False, as the JAX package
    writes it (``_PNAConv``, without PyG's final MLP): per tower t,
    m = pre_nns[t]([x_i || x_j || edge_encoder e_ij]); each aggregator of m
    over the real in-edges (mean, min, max, std, sum) under each scaler
    (identity, amplification log(d+1)/delta, attenuation
    delta/max(log(d+1), 1e-5)); post_nns[t]([x || scaled...]); the towers
    concatenated through ``lin``. ``delta`` is a Python float, computed in
    float64 by the tower, as JAX's.

    The conv's in-degree is taken once (K1) and serves every mean; the JAX
    package asks for it in each ``segment_mean`` and XLA computes it once.
    min is -segment_max(-m); std is sqrt(max(mean(m^2) - mean(m)^2, 0) +
    1e-5) with ``torch.maximum``, whose gradient at a tie is 0.5, as
    jnp.maximum's (a node with one in-edge is such a tie)."""

    def __init__(self, in_channels: int, out_channels: int, edge_dim: int,
                 aggregators: tuple, scalers: tuple, towers: int, delta: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, f_in = generator, in_channels
        f_out = out_channels // towers
        for a in aggregators:
            if a not in ("mean", "min", "max", "std", "sum", "add"):
                raise ValueError(f"unknown PNA aggregator {a}")
        for sc in scalers:
            if sc not in ("identity", "amplification", "attenuation"):
                raise ValueError(f"unknown PNA scaler {sc}")
        self.aggregators, self.scalers, self.delta = tuple(aggregators), tuple(scalers), delta
        self.edge_encoder = Dense(edge_dim, f_in, generator=g)
        self.pre_nns = nn.ModuleList(nn.Sequential(Dense(3 * f_in, f_in, generator=g))
                                     for _ in range(towers))
        n_cat = (1 + len(aggregators) * len(scalers)) * f_in
        self.post_nns = nn.ModuleList(nn.Sequential(Dense(n_cat, f_out, generator=g))
                                      for _ in range(towers))
        self.lin = Dense(f_out * towers, out_channels, generator=g)

    def forward(self, x, edge_src, edge_dst, edge_mask, edge_attr):
        n = x.shape[1]
        h = torch.cat([segment.gather_nodes(x, edge_dst), segment.gather_nodes(x, edge_src),
                       self.edge_encoder(edge_attr)], dim=-1)
        deg = segment.segment_degree(edge_dst, edge_mask, n)         # [B, N]
        log_deg = torch.log(deg + 1.0)[..., None]
        deg = deg.clamp(min=1.0)[..., None]

        def mean(v):   # segment_mean with the conv's degree
            return segment.segment_sum(v, edge_dst, edge_mask, n) / deg

        outs = []
        for pre, post in zip(self.pre_nns, self.post_nns):
            m = pre(h)
            avg = mean(m)
            aggs = []
            for a in self.aggregators:
                if a == "mean":
                    aggs.append(avg)
                elif a == "min":
                    aggs.append(-segment.segment_max(-m, edge_dst, edge_mask, n))
                elif a == "max":
                    aggs.append(segment.segment_max(m, edge_dst, edge_mask, n))
                elif a == "std":
                    var = mean(m * m) - avg * avg
                    aggs.append(torch.sqrt(torch.maximum(var, var.new_zeros(())) + 1e-5))
                else:
                    aggs.append(segment.segment_sum(m, edge_dst, edge_mask, n))
            scaled = []
            for sc in self.scalers:
                for agg in aggs:
                    if sc == "identity":
                        scaled.append(agg)
                    elif sc == "amplification":
                        scaled.append(agg * (log_deg / self.delta))
                    else:
                        scaled.append(agg * (self.delta / torch.clamp(log_deg, min=1e-5)))
            outs.append(post(torch.cat([x] + scaled, dim=-1)))
        return self.lin(torch.cat(outs, dim=-1))
