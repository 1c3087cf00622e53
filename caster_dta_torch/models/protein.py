"""Protein towers (counterpart of caster_dta_tpu/models/protein.py). The
trained config is ``base_conv='lbamodel'``: input GVP + LayerNorm blocks,
``num_convs`` GVPConvLayers, a final LayerNorm + GVP down to per-residue
scalars. ``pocketminer`` and ``cpdmodel`` are the other GVP towers;
``gatv2`` and ``heat`` the scalar ones (models/scalar_gnns.py). Each tower's
``out_dim`` is the width of the rows it returns."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from caster_dta_torch.data.graphs import GraphBatch
from caster_dta_torch.models.common import TypeEmbedding, build_tower
from caster_dta_torch.models.scalar_gnns import GATv2GNN, HEATGNN
from caster_dta_torch.nn import gvp
from caster_dta_torch.ops import segment

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
        self.out_dim = out_dims[0]

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


class VectorProteinGNN_PocketMiner(nn.Module):
    """PocketMiner-style GVP tower: optional initial GVP + LayerNorm
    projections of the node and edge features, the type embeddings, then
    LayerNorm *before* the input GVPs (the reverse of LBA), ``num_convs``
    GVPConvLayers with activations (None, None) and no vector gate, a final
    LayerNorm + GVP."""

    def __init__(self, in_channels, edge_dim, num_ntypes: int, num_etypes: int,
                 ntype_emb_dim: Optional[int] = None, etype_emb_dim: Optional[int] = None,
                 num_convs: int = 1, hidden_channels=None, out_channels=8,
                 dropout_rate: float = 0.2, activation: str = "relu",
                 edge_hidden_channels=(32, 1), initial_node_project_channels=None,
                 initial_edge_project_channels=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        plain = (None, None)
        hidden = _as_dims(hidden_channels if hidden_channels is not None else out_channels)
        out_dims = _as_dims(out_channels)
        edge_hidden = _as_dims(edge_hidden_channels)
        node_in, edge_in = _as_dims(in_channels), _as_dims(edge_dim)
        self.initial_node_proj = self.initial_edge_proj = None
        if initial_node_project_channels is not None:
            proj = tuple(initial_node_project_channels)
            self.initial_node_proj = nn.Sequential(
                gvp.GVP(node_in, proj, activations=plain, generator=g), gvp.GVPLayerNorm(proj))
            node_in = proj
        if initial_edge_project_channels is not None:
            proj = tuple(initial_edge_project_channels)
            self.initial_edge_proj = nn.Sequential(
                gvp.GVP(edge_in, proj, activations=plain, generator=g), gvp.GVPLayerNorm(proj))
            edge_in = proj
        self.ntype_embedding = TypeEmbedding(num_ntypes, ntype_emb_dim, generator=g)
        self.etype_embedding = TypeEmbedding(num_etypes, etype_emb_dim, generator=g)
        node_in = (node_in[0] + self.ntype_embedding.out_dim, node_in[1])
        edge_in = (edge_in[0] + self.etype_embedding.out_dim, edge_in[1])
        self.gvp_node = nn.Sequential(gvp.GVPLayerNorm(node_in),
                                      gvp.GVP(node_in, hidden, activations=plain, generator=g))
        self.gvp_edge = nn.Sequential(gvp.GVPLayerNorm(edge_in),
                                      gvp.GVP(edge_in, edge_hidden, activations=plain,
                                              generator=g))
        self.conv_list = nn.ModuleList(
            gvp.GVPConvLayer(hidden, edge_hidden, drop_rate=dropout_rate, activations=plain,
                             generator=g)
            for _ in range(num_convs))
        self.gvp_norm_before_scalar = gvp.GVPLayerNorm(hidden)
        self.gvp_to_scalar = gvp.GVP(hidden, out_dims, activations=plain, generator=g)
        self.out_dim = out_dims[0]

    def forward(self, g: GraphBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, eattr = (g.node_s, g.node_v), (g.edge_s, g.edge_v)
        if self.initial_node_proj is not None:
            x = self.initial_node_proj(x)
        if self.initial_edge_proj is not None:
            eattr = self.initial_edge_proj(eattr)
        x = (torch.cat([self.ntype_embedding(g.node_type), x[0]], dim=-1), x[1])
        eattr = (torch.cat([self.etype_embedding(g.edge_type), eattr[0]], dim=-1), eattr[1])
        x = self.gvp_node(x)
        eattr = self.gvp_edge(eattr)
        for conv in self.conv_list:
            x = conv(x, g.edge_src, g.edge_dst, g.edge_mask, eattr, generator=generator)
        s, _ = self.gvp_to_scalar(self.gvp_norm_before_scalar(x))
        return s


class VectorProteinGNN_CPDModel(nn.Module):
    """CPD-style encoder/decoder GVP tower: the edge types embedded up front,
    input GVP + LayerNorm blocks ``W_v``/``W_e``, ``num_convs`` encoder
    layers (aggr mean), then ``num_convs`` autoregressive decoder layers
    whose edges carry the source node's type embedding, zeroed where
    src >= dst, and messages from the encoder's output on those edges; then
    ``W_out`` with no LayerNorm."""

    def __init__(self, in_channels, edge_dim, num_ntypes: int, num_etypes: int,
                 ntype_emb_dim: Optional[int] = None, etype_emb_dim: Optional[int] = None,
                 num_convs: int = 1, hidden_channels=None, out_channels=8,
                 dropout_rate: float = 0.2, activation: str = "relu",
                 edge_hidden_channels=(32, 1), generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        plain = (None, None)
        hidden = _as_dims(hidden_channels if hidden_channels is not None else out_channels)
        out_dims = _as_dims(out_channels)
        edge_hidden = _as_dims(edge_hidden_channels)
        e_s, e_v = _as_dims(edge_dim)
        self.ntype_embedding = TypeEmbedding(num_ntypes, ntype_emb_dim, generator=g)
        self.etype_embedding = TypeEmbedding(num_etypes, etype_emb_dim, generator=g)
        self.W_v = nn.Sequential(gvp.GVP(_as_dims(in_channels), hidden, activations=plain,
                                         generator=g), gvp.GVPLayerNorm(hidden))
        self.W_e = nn.Sequential(gvp.GVP((e_s + self.etype_embedding.out_dim, e_v), edge_hidden,
                                         activations=plain, generator=g),
                                 gvp.GVPLayerNorm(edge_hidden))
        self.encoder_layers = nn.ModuleList(
            gvp.GVPConvLayer(hidden, edge_hidden, drop_rate=dropout_rate, generator=g)
            for _ in range(num_convs))
        decoder_edges = (edge_hidden[0] + self.ntype_embedding.out_dim, edge_hidden[1])
        self.decoder_layers = nn.ModuleList(
            gvp.GVPConvLayer(hidden, decoder_edges, drop_rate=dropout_rate, autoregressive=True,
                             generator=g)
            for _ in range(num_convs))
        self.W_out = gvp.GVP(hidden, out_dims, activations=plain, generator=g)
        self.out_dim = out_dims[0]

    def forward(self, g: GraphBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        edges = (g.edge_src, g.edge_dst, g.edge_mask)
        eattr = (torch.cat([self.etype_embedding(g.edge_type), g.edge_s], dim=-1), g.edge_v)
        x = self.W_v((g.node_s, g.node_v))
        eattr = self.W_e(eattr)
        for layer in self.encoder_layers:
            x = layer(x, *edges, eattr, generator=generator)
        encoder_embeddings = x
        h_s = segment.gather_nodes(self.ntype_embedding(g.node_type), g.edge_src)   # K2
        h_s = torch.where((g.edge_src >= g.edge_dst)[..., None],
                          torch.zeros((), dtype=h_s.dtype, device=h_s.device), h_s)
        eattr = (torch.cat([eattr[0], h_s], dim=-1), eattr[1])
        for layer in self.decoder_layers:
            x = layer(x, *edges, eattr, autoregressive_x=encoder_embeddings,
                      generator=generator)
        s, _ = self.W_out(x)
        return s


PROTEIN_MODELS = {
    "lbamodel": VectorProteinGNN_LBAModel,
    "pocketminer": VectorProteinGNN_PocketMiner,
    "cpdmodel": VectorProteinGNN_CPDModel,
    "gatv2": GATv2GNN,
    "heat": HEATGNN,
}

VECTOR_MODELS = ("lbamodel", "pocketminer", "cpdmodel")


def make_protein_gnn(base_conv: str = "lbamodel", generator: Optional[torch.Generator] = None,
                     **kwargs) -> nn.Module:
    """Build a tower from its model_kwargs.json entry, with the JAX package's
    checks of scalar against (scalar, vector) typing."""
    in_channels, edge_dim = kwargs.get("in_channels"), kwargs.get("edge_dim")
    is_scalar = isinstance(in_channels, int)
    if type(in_channels) is not type(edge_dim):
        raise ValueError("in_channels and edge_dim must be the same type "
                         "(both int or both (scalar, vector) tuples)")
    if is_scalar and base_conv in VECTOR_MODELS:
        raise ValueError(f"Cannot use vector model {base_conv} with scalar input")
    if not is_scalar and base_conv not in VECTOR_MODELS:
        raise ValueError(f"Cannot use scalar model {base_conv} with vector input")
    if base_conv not in PROTEIN_MODELS:
        raise ValueError(f"unknown protein base_conv: {base_conv!r}")
    return build_tower(PROTEIN_MODELS[base_conv], generator, kwargs)
