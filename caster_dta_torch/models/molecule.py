"""Molecule towers (counterpart of caster_dta_tpu/models/molecule.py). The
trained config is ``base_conv='gine'``: a stack of GINEConvs. ``gatv2``
(the JAX package's HomoMoleculeGNN_GAT, with no self-loops inserted) and
``heat`` are the scalar towers of models/scalar_gnns.py; ``gin``,
``attentivefp``, ``gps`` and ``pna`` are here. Each tower's ``out_dim`` is
the width of the rows it returns.

Names: a tower's convs are ``conv_list.{i}`` (the reference's name), each
with its operator's names (nn/conv.py); AttentiveFP's GRU cells are
``gru_list.{i}`` and its projections the JAX names ``lin1`` and ``lin2``; a
GPS layer ``layers.{i}`` holds the JAX leaves of ``conv_{i}_*`` without
that prefix (``local``, ``norm1``-``norm3``, ``attn_in``, ``attn`` with
torch.nn.MultiheadAttention's names, ``ff``), beside ``pe_norm`` and
``pe_lin``."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from caster_dta_torch.data.graphs import GraphBatch
from caster_dta_torch.models.common import TypeEmbedding, build_tower
from caster_dta_torch.models.scalar_gnns import GATv2GNN, HEATGNN
from caster_dta_torch.nn.attention import MultiheadAttention
from caster_dta_torch.nn.common import (MLP, Dense, LayerNorm, apply_act, dropout, leaky_relu,
                                        select_activation)
from caster_dta_torch.nn.conv import GATConv, GATEConv, GINConv, GINEConv, GRUCell, PNAConv
from caster_dta_torch.nn.norm import MaskedBatchNorm


class _BaseMolecule(nn.Module):
    """Type embeddings and layer widths shared by the molecule towers."""

    def __init__(self, in_channels: int, edge_dim: int, num_ntypes: int, num_etypes: int,
                 ntype_emb_dim: Optional[int] = None, etype_emb_dim: Optional[int] = None,
                 num_convs: int = 1, hidden_channels: Optional[int] = None,
                 out_channels: int = 8, dropout_rate: float = 0.2,
                 activation: str = "relu", aggr: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_convs, self.dropout_rate, self.aggr = num_convs, dropout_rate, aggr
        self.act = select_activation(activation)
        self.ntype_embedding = TypeEmbedding(num_ntypes, ntype_emb_dim, generator=generator)
        self.etype_embedding = TypeEmbedding(num_etypes, etype_emb_dim, generator=generator)
        hidden = hidden_channels if hidden_channels is not None else out_channels
        self.hidden, self.out_dim = hidden, out_channels
        self.dims = ([in_channels + self.ntype_embedding.out_dim]
                     + [hidden] * (num_convs - 1) + [out_channels])
        self.edge_in = edge_dim + self.etype_embedding.out_dim

    def _embed_types_and_cat(self, g: GraphBatch):
        x = torch.cat([self.ntype_embedding(g.node_type), g.node_s], dim=-1)
        e = torch.cat([self.etype_embedding(g.edge_type), g.edge_s], dim=-1)
        return x, e


class HomoMoleculeGNN_GINE(_BaseMolecule):
    """Stack of GINEConvs: [B, N] atoms -> [B, N, out]."""

    def __init__(self, in_channels: int, edge_dim: int, num_ntypes: int, num_etypes: int,
                 ntype_emb_dim: Optional[int] = None, etype_emb_dim: Optional[int] = None,
                 num_convs: int = 1, hidden_channels: Optional[int] = None,
                 out_channels: int = 8, dropout_rate: float = 0.2,
                 activation: str = "relu", aggr: str = "sum", gin_trainable_eps: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, edge_dim, num_ntypes, num_etypes, ntype_emb_dim,
                         etype_emb_dim, num_convs, hidden_channels, out_channels,
                         dropout_rate, activation, aggr, generator)
        self.conv_list = nn.ModuleList(
            GINEConv(self.dims[i], self.dims[i + 1], self.edge_in, act=activation,
                     train_eps=gin_trainable_eps, aggr=aggr, generator=generator)
            for i in range(num_convs))

    def forward(self, g: GraphBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, e = self._embed_types_and_cat(g)
        for i, conv in enumerate(self.conv_list):
            x = apply_act(self.act, conv(x, g.edge_src, g.edge_dst, g.edge_mask, e))
            if i < self.num_convs - 1:
                x = dropout(x, self.dropout_rate, self.training, generator)
        return x


class HomoMoleculeGNN_GIN(_BaseMolecule):
    """Stack of GINConvs on the embedded node types and features (the edge
    features are not used): [B, N] atoms -> [B, N, out]."""

    def __init__(self, in_channels: int, edge_dim: int, num_ntypes: int, num_etypes: int,
                 ntype_emb_dim: Optional[int] = None, etype_emb_dim: Optional[int] = None,
                 num_convs: int = 1, hidden_channels: Optional[int] = None,
                 out_channels: int = 8, dropout_rate: float = 0.2,
                 activation: str = "relu", aggr: str = "sum", gin_trainable_eps: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, edge_dim, num_ntypes, num_etypes, ntype_emb_dim,
                         etype_emb_dim, num_convs, hidden_channels, out_channels,
                         dropout_rate, activation, aggr, generator)
        self.conv_list = nn.ModuleList(
            GINConv(self.dims[i], self.dims[i + 1], act=activation,
                    train_eps=gin_trainable_eps, aggr=aggr, generator=generator)
            for i in range(num_convs))

    def forward(self, g: GraphBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, _ = self._embed_types_and_cat(g)
        for i, conv in enumerate(self.conv_list):
            x = apply_act(self.act, conv(x, g.edge_src, g.edge_dst, g.edge_mask))
            if i < self.num_convs - 1:
                x = dropout(x, self.dropout_rate, self.training, generator)
        return x


class HomoMoleculeGNN_AttentiveFP(_BaseMolecule):
    """AttentiveFP's atom embedder: leaky_relu(lin1, 0.01); GATEConv, elu,
    dropout, relu(GRU); (GATConv with slope 0.01, elu, dropout, relu(GRU))
    ``num_convs - 1`` times; lin2 and the activation. Every width is the
    hidden one until lin2; the convs' attention dropout is ``dropout_rate``."""

    def __init__(self, in_channels: int, edge_dim: int, num_ntypes: int, num_etypes: int,
                 ntype_emb_dim: Optional[int] = None, etype_emb_dim: Optional[int] = None,
                 num_convs: int = 1, hidden_channels: Optional[int] = None,
                 out_channels: int = 8, dropout_rate: float = 0.2,
                 activation: str = "relu", aggr: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, edge_dim, num_ntypes, num_etypes, ntype_emb_dim,
                         etype_emb_dim, num_convs, hidden_channels, out_channels,
                         dropout_rate, activation, aggr, generator)
        g, hidden = generator, self.hidden
        self.lin1 = Dense(self.dims[0], hidden, generator=g)
        self.conv_list = nn.ModuleList(
            [GATEConv(hidden, hidden, self.edge_in, dropout=dropout_rate, generator=g)]
            + [GATConv(hidden, hidden, dropout=dropout_rate, negative_slope=0.01, generator=g)
               for _ in range(num_convs - 1)])
        self.gru_list = nn.ModuleList(GRUCell(hidden, hidden, generator=g)
                                      for _ in range(num_convs))
        self.lin2 = Dense(hidden, out_channels, generator=g)

    def forward(self, g: GraphBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, e = self._embed_types_and_cat(g)
        x = leaky_relu(self.lin1(x), 0.01)
        for i, (conv, gru) in enumerate(zip(self.conv_list, self.gru_list)):
            edge = (e,) if i == 0 else ()
            x_h = F.elu(conv(x, g.edge_src, g.edge_dst, g.edge_mask, *edge, generator=generator))
            x_h = dropout(x_h, self.dropout_rate, self.training, generator)
            x = F.relu(gru(x_h, x))
        return apply_act(self.act, self.lin2(x))


def random_walk_pe(g: GraphBatch, n_walks: int = 20) -> torch.Tensor:
    """Random-walk positional encodings [B, N, n_walks]: the dense per-graph
    adjacency (the real edges' count at (src, dst), a multi-edge summed; one
    ``scatter_add_``, its sums of 0s and 1s exact in any order),
    each row divided by its out-degree clamped at 1, and pe[..., k] the
    diagonal of its (k+1)-th power: f32 ``bmm``s (IEEE under the caller's
    ``f32_precision`` on the card, as JAX's einsum on the CPU)."""
    b, n = g.node_type.shape
    cells = g.edge_src.long() * n + g.edge_dst.long()
    adj = torch.zeros(b, n * n, dtype=torch.float32, device=cells.device)
    adj = adj.scatter_add_(1, cells, g.edge_mask.to(torch.float32)).reshape(b, n, n)
    adj = adj / torch.clamp(adj.sum(dim=2, keepdim=True), min=1.0)
    p, pes = adj, []
    for k in range(n_walks):
        pes.append(torch.diagonal(p, dim1=1, dim2=2))
        if k < n_walks - 1:
            p = torch.bmm(p, adj)
    return torch.stack(pes, dim=-1)


class _GPSLayer(nn.Module):
    """One GPS layer: a local GINEConv (train_eps off, sum; the residual only
    where the widths match, the JAX package's divergence from PyG) and
    LayerNorm, beside global self-attention (4 heads, over the real nodes;
    ``attn_in`` projects x only where the widths differ) with its residual
    and LayerNorm; their sum through the FF MLP(d, 2d, d), its residual and
    LayerNorm. LayerNorms with eps 1e-5."""

    def __init__(self, d_in: int, d_out: int, edge_dim: int, attn_dropout: float,
                 generator: Optional[torch.Generator]):
        super().__init__()
        g = generator
        self.residual = d_in == d_out
        self.local = GINEConv(d_in, d_out, edge_dim, act="relu", train_eps=False, aggr="sum",
                              generator=g)
        self.norm1 = LayerNorm(d_out, eps=1e-5)
        self.attn_in = None if self.residual else Dense(d_in, d_out, generator=g)
        self.attn = MultiheadAttention(d_out, 4, dropout=attn_dropout, generator=g)
        self.norm2 = LayerNorm(d_out, eps=1e-5)
        self.ff = MLP((d_out, 2 * d_out, d_out), act="relu", generator=g)
        self.norm3 = LayerNorm(d_out, eps=1e-5)

    def forward(self, x, g: GraphBatch, e, generator: Optional[torch.Generator] = None):
        h_local = self.local(x, g.edge_src, g.edge_dst, g.edge_mask, e)
        if self.residual:
            h_local = h_local + x
        h_local = self.norm1(h_local)
        q = x if self.attn_in is None else self.attn_in(x)
        h_attn, _ = self.attn(q, q, q, key_padding_mask=~g.node_mask, generator=generator)
        h = h_local + self.norm2(h_attn + q)
        return self.norm3(h + self.ff(h))


class HomoMoleculeGNN_GPS(_BaseMolecule):
    """GraphGPS-style tower: the random-walk PE (20 walks) through
    MaskedBatchNorm(20) over the real nodes and ``pe_lin`` to ``pe_dim``,
    concatenated to the embedded features, then ``num_convs`` GPS layers;
    no activation after the last, as in JAX. The attention dropout is
    ``attn_kwargs['dropout']`` (0.5 without it). Serving uses the norm's
    running statistics; the Trainer refuses the tower, as the JAX Trainer's
    first step fails on it."""

    def __init__(self, in_channels: int, edge_dim: int, num_ntypes: int, num_etypes: int,
                 ntype_emb_dim: Optional[int] = None, etype_emb_dim: Optional[int] = None,
                 num_convs: int = 1, hidden_channels: Optional[int] = None,
                 out_channels: int = 8, dropout_rate: float = 0.2,
                 activation: str = "relu", aggr: str = "sum", pe_dim: int = 8,
                 attn_kwargs: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, edge_dim, num_ntypes, num_etypes, ntype_emb_dim,
                         etype_emb_dim, num_convs, hidden_channels, out_channels,
                         dropout_rate, activation, aggr, generator)
        g = generator
        self.pe_norm = MaskedBatchNorm(20)
        self.pe_lin = Dense(20, pe_dim, generator=g)
        dims = [self.dims[0] + pe_dim] + self.dims[1:]
        attn_dropout = (attn_kwargs or {}).get("dropout", 0.5)
        self.layers = nn.ModuleList(_GPSLayer(dims[i], dims[i + 1], self.edge_in, attn_dropout, g)
                                    for i in range(num_convs))

    def forward(self, g: GraphBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, e = self._embed_types_and_cat(g)
        pe = self.pe_lin(self.pe_norm(random_walk_pe(g, 20), mask=g.node_mask))
        x = torch.cat([x, pe], dim=-1)
        for layer in self.layers:
            x = layer(x, g, e, generator)
        return x


def pna_delta(degree_hist) -> float:
    """PyG's delta, the mean of log(deg + 1) under the in-degree histogram,
    in float64 as the JAX package computes it."""
    hist = np.asarray(degree_hist, np.float64)
    degs = np.arange(len(hist))
    return float((np.log(degs + 1) * hist).sum() / max(hist.sum(), 1.0))


class HomoMoleculeGNN_PNA(_BaseMolecule):
    """Stack of PNAConvs with the tower's activation (and dropout between
    convs). ``degree_hist``: the in-degree histogram of the training set,
    which delta comes from."""

    def __init__(self, in_channels: int, edge_dim: int, num_ntypes: int, num_etypes: int,
                 ntype_emb_dim: Optional[int] = None, etype_emb_dim: Optional[int] = None,
                 num_convs: int = 1, hidden_channels: Optional[int] = None,
                 out_channels: int = 8, dropout_rate: float = 0.2,
                 activation: str = "relu", aggr: str = "sum",
                 degree_hist: Optional[tuple] = None,
                 aggregators: tuple = ("mean", "min", "max", "std"),
                 scalers: tuple = ("identity", "amplification", "attenuation"),
                 towers: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, edge_dim, num_ntypes, num_etypes, ntype_emb_dim,
                         etype_emb_dim, num_convs, hidden_channels, out_channels,
                         dropout_rate, activation, aggr, generator)
        if degree_hist is None:
            raise ValueError("the PNA tower needs degree_hist, the training set's in-degree "
                             "histogram")
        self.delta = pna_delta(degree_hist)
        self.conv_list = nn.ModuleList(
            PNAConv(self.dims[i], self.dims[i + 1], self.edge_in, aggregators, scalers, towers,
                    self.delta, generator=generator)
            for i in range(num_convs))

    def forward(self, g: GraphBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, e = self._embed_types_and_cat(g)
        for i, conv in enumerate(self.conv_list):
            x = apply_act(self.act, conv(x, g.edge_src, g.edge_dst, g.edge_mask, e))
            if i < self.num_convs - 1:
                x = dropout(x, self.dropout_rate, self.training, generator)
        return x


MOLECULE_MODELS = {
    "gatv2": GATv2GNN,
    "gine": HomoMoleculeGNN_GINE,
    "gin": HomoMoleculeGNN_GIN,
    "gps": HomoMoleculeGNN_GPS,
    "pna": HomoMoleculeGNN_PNA,
    "attentivefp": HomoMoleculeGNN_AttentiveFP,
    "heat": HEATGNN,
}


def make_molecule_gnn(base_conv: str = "gine", generator: Optional[torch.Generator] = None,
                      **kwargs) -> nn.Module:
    """Build a tower from its model_kwargs.json entry; keys the tower does not
    take are ignored, as in the JAX package."""
    base_conv = base_conv.lower()
    if base_conv not in MOLECULE_MODELS:
        raise ValueError(f"unknown molecule base_conv: {base_conv!r}")
    return build_tower(MOLECULE_MODELS[base_conv], generator, kwargs)
