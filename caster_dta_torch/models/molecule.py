"""Molecule tower (counterpart of caster_dta_tpu/models/molecule.py). The
trained config is ``base_conv='gine'``: a stack of GINEConvs."""
from __future__ import annotations

import inspect
from typing import Optional

import torch
from torch import nn

from caster_dta_torch.data.graphs import GraphBatch
from caster_dta_torch.models.common import TypeEmbedding
from caster_dta_torch.nn.common import apply_act, dropout, select_activation
from caster_dta_torch.nn.conv import GINEConv


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


def make_molecule_gnn(base_conv: str = "gine", generator: Optional[torch.Generator] = None,
                      **kwargs) -> nn.Module:
    """Build a tower from its model_kwargs.json entry; keys the tower does not
    take are ignored, as in the JAX package."""
    if base_conv.lower() != "gine":
        raise NotImplementedError(f"molecule base_conv {base_conv!r} is not ported yet")
    known = inspect.signature(HomoMoleculeGNN_GINE).parameters
    return HomoMoleculeGNN_GINE(generator=generator,
                                **{k: v for k, v in kwargs.items() if k in known})
