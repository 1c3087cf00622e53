"""The scalar GATv2 and HEAT towers (counterpart of caster_dta_tpu/models/
scalar_gnns.py and of the JAX package's ``HomoMoleculeGNN_GAT`` and
``HeteroMoleculeGNN_HEAT``). The JAX package's protein and molecule versions
of each compute one function with the same fields, defaults and parameter
tree, so each is one class here, registered under its name in both
``make_protein_gnn`` and ``make_molecule_gnn``.

Each conv's input width is the previous conv's output width, which is
``heads x`` the listed one when ``concat`` is on (flax infers it; here
``out_dim`` carries it). Dropout runs between convs only, drawn from the
caller's generator, as the convs' attention dropout is.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from caster_dta_torch.data.graphs import GraphBatch
from caster_dta_torch.models.common import TypeEmbedding
from caster_dta_torch.nn.common import apply_act, dropout, select_activation
from caster_dta_torch.nn.conv import GATv2Conv, HEATConv


class _ScalarTower(nn.Module):
    def __init__(self, num_convs: int, hidden_channels: Optional[int], out_channels: int,
                 dropout_rate: float, activation: str):
        super().__init__()
        self.num_convs, self.dropout_rate = num_convs, dropout_rate
        self.act = select_activation(activation)
        hidden = hidden_channels if hidden_channels is not None else out_channels
        self.widths = [hidden] * (num_convs - 1) + [out_channels]

    @property
    def out_dim(self) -> int:
        return self.conv_list[-1].out_dim

    def _between(self, i: int, x: torch.Tensor, generator) -> torch.Tensor:
        x = apply_act(self.act, x)
        if i < self.num_convs - 1:
            x = dropout(x, self.dropout_rate, self.training, generator)
        return x


class GATv2GNN(_ScalarTower):
    """Node and edge type embeddings (one-hot when ``*_emb_dim`` is None)
    concatenated onto the features, then ``num_convs`` GATv2Convs with edge
    features: [B, N] -> [B, N, out_dim]."""

    def __init__(self, in_channels: int, edge_dim: int, num_ntypes: int, num_etypes: int,
                 ntype_emb_dim: Optional[int] = None, etype_emb_dim: Optional[int] = None,
                 num_convs: int = 1, hidden_channels: Optional[int] = None,
                 out_channels: int = 8, dropout_rate: float = 0.2, activation: str = "relu",
                 aggr: str = "sum", concat: bool = False, heads: int = 2,
                 conv_dropout: float = 0.0, conv_neg_slope: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_convs, hidden_channels, out_channels, dropout_rate, activation)
        g = generator
        self.ntype_embedding = TypeEmbedding(num_ntypes, ntype_emb_dim, generator=g)
        self.etype_embedding = TypeEmbedding(num_etypes, etype_emb_dim, generator=g)
        width = in_channels + self.ntype_embedding.out_dim
        self.conv_list = nn.ModuleList()
        for c in self.widths:
            conv = GATv2Conv(width, c, heads=heads, concat=concat, negative_slope=conv_neg_slope,
                             dropout=conv_dropout, aggr=aggr,
                             edge_dim=edge_dim + self.etype_embedding.out_dim, generator=g)
            self.conv_list.append(conv)
            width = conv.out_dim

    def forward(self, g: GraphBatch, generator: Optional[torch.Generator] = None):
        x = torch.cat([self.ntype_embedding(g.node_type), g.node_s], dim=-1)
        e = torch.cat([self.etype_embedding(g.edge_type), g.edge_s], dim=-1)
        for i, conv in enumerate(self.conv_list):
            x = conv(x, g.edge_src, g.edge_dst, g.edge_mask, e, generator=generator)
            x = self._between(i, x, generator)
        return x


class HEATGNN(_ScalarTower):
    """``num_convs`` HEATConvs on the raw node features (node types enter
    through the per-type projection, edge types through the conv's own
    embedding, of width ``etype_emb_dim`` or ``num_etypes``): [B, N] ->
    [B, N, out_dim]."""

    def __init__(self, in_channels: int, edge_dim: int, num_ntypes: int, num_etypes: int,
                 ntype_emb_dim: Optional[int] = None, etype_emb_dim: Optional[int] = None,
                 num_convs: int = 1, hidden_channels: Optional[int] = None,
                 out_channels: int = 8, dropout_rate: float = 0.2, activation: str = "relu",
                 eattr_emb_dim: int = 8, aggr: str = "sum", concat: bool = True,
                 heads: int = 2, conv_dropout: float = 0.0, conv_neg_slope: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_convs, hidden_channels, out_channels, dropout_rate, activation)
        etype_dim = num_etypes if etype_emb_dim is None else etype_emb_dim
        width = in_channels
        self.conv_list = nn.ModuleList()
        for c in self.widths:
            conv = HEATConv(width, c, num_node_types=num_ntypes, num_edge_types=num_etypes,
                            edge_type_emb_dim=etype_dim, edge_dim=edge_dim,
                            edge_attr_emb_dim=eattr_emb_dim, heads=heads, concat=concat,
                            negative_slope=conv_neg_slope, dropout=conv_dropout, aggr=aggr,
                            generator=generator)
            self.conv_list.append(conv)
            width = conv.out_dim

    def forward(self, g: GraphBatch, generator: Optional[torch.Generator] = None):
        x = g.node_s
        for i, conv in enumerate(self.conv_list):
            x = conv(x, g.edge_src, g.edge_dst, g.edge_mask, g.node_type, g.edge_type,
                     g.edge_s, generator=generator)
            x = self._between(i, x, generator)
        return x
