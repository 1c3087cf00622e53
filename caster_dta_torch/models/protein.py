"""Protein tower (counterpart of caster_dta_tpu/models/protein.py). The
trained config is ``base_conv='lbamodel'``: input GVP + LayerNorm blocks,
``num_convs`` GVPConvLayers, a final LayerNorm + GVP down to per-residue
scalars."""
from __future__ import annotations

import inspect
from typing import Optional, Tuple, Union

import torch
from torch import nn

from caster_dta_torch.data.graphs import GraphBatch
from caster_dta_torch.models.common import TypeEmbedding
from caster_dta_torch.nn import gvp

Dims = Tuple[int, int]


def _as_dims(x: Union[int, Tuple[int, int], list]) -> Dims:
    """int -> (x, 0)."""
    return (x, 0) if isinstance(x, int) else tuple(x)


class VectorProteinGNN_LBAModel(nn.Module):
    """GVP-GNN protein tower: [B, N] residues -> [B, N, out] scalars."""

    def __init__(self, in_channels, edge_dim, num_ntypes: int, num_etypes: int,
                 ntype_emb_dim: Optional[int] = None, etype_emb_dim: Optional[int] = None,
                 num_convs: int = 1, hidden_channels=None, out_channels=8,
                 dropout_rate: float = 0.2, activation: str = "relu",
                 edge_hidden_channels=(32, 1), aggr: str = "mean",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        hidden = _as_dims(hidden_channels if hidden_channels is not None else out_channels)
        out_dims = _as_dims(out_channels)
        edge_hidden = _as_dims(edge_hidden_channels)
        in_s, in_v = _as_dims(in_channels)
        e_s, e_v = _as_dims(edge_dim)
        self.ntype_embedding = TypeEmbedding(num_ntypes, ntype_emb_dim, generator=g)
        self.etype_embedding = TypeEmbedding(num_etypes, etype_emb_dim, generator=g)
        node_in = (in_s + self.ntype_embedding.out_dim, in_v)
        edge_in = (e_s + self.etype_embedding.out_dim, e_v)
        plain = (None, None)
        self.gvp_node = nn.Sequential(
            gvp.GVP(node_in, hidden, activations=plain, vector_gate=True, generator=g),
            gvp.GVPLayerNorm(hidden))
        self.gvp_edge = nn.Sequential(
            gvp.GVP(edge_in, edge_hidden, activations=plain, vector_gate=True, generator=g),
            gvp.GVPLayerNorm(edge_hidden))
        self.conv_list = nn.ModuleList(
            gvp.GVPConvLayer(hidden, edge_hidden, drop_rate=dropout_rate,
                             activations=("relu", None), vector_gate=True, aggr=aggr,
                             generator=g)
            for _ in range(num_convs))
        self.gvp_norm_before_scalar = gvp.GVPLayerNorm(hidden)
        self.gvp_to_scalar = gvp.GVP(hidden, out_dims, activations=("relu", None),
                                     vector_gate=True, generator=g)

    def forward(self, g: GraphBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = (torch.cat([self.ntype_embedding(g.node_type), g.node_s], dim=-1), g.node_v)
        eattr = (torch.cat([self.etype_embedding(g.edge_type), g.edge_s], dim=-1), g.edge_v)
        for layer in self.gvp_node:
            x = layer(x)
        for layer in self.gvp_edge:
            eattr = layer(eattr)
        for conv in self.conv_list:
            x = conv(x, g.edge_src, g.edge_dst, g.edge_mask, eattr, generator=generator)
        s, _ = self.gvp_to_scalar(self.gvp_norm_before_scalar(x))
        return s


def make_protein_gnn(base_conv: str = "lbamodel", generator: Optional[torch.Generator] = None,
                     **kwargs) -> nn.Module:
    """Build a tower from its model_kwargs.json entry; keys the tower does not
    take are ignored, as in the JAX package."""
    if base_conv != "lbamodel":
        raise NotImplementedError(f"protein base_conv {base_conv!r} is not ported yet")
    known = inspect.signature(VectorProteinGNN_LBAModel).parameters
    return VectorProteinGNN_LBAModel(generator=generator,
                                     **{k: v for k, v in kwargs.items() if k in known})
