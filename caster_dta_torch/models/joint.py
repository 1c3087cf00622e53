"""JointGNN: two GNN towers, residue-atom cross-attention and the affinity
head (counterpart of caster_dta_tpu/models/joint.py). Everything is dense
``[B, N, D]`` with node masks. Parameter names follow the reference state
dict (``protein_gnn.gnn_model.*``, ``cross_attn_module.cross_attn_layers.*``,
...), so ``caster_dta_tpu.interop.torch_import.import_joint_gnn`` maps
``state_dict()`` onto the JAX tree."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from caster_dta_torch.data.graphs import GraphBatch
from caster_dta_torch.models.common import masked_pool
from caster_dta_torch.models.molecule import make_molecule_gnn
from caster_dta_torch.models.protein import make_protein_gnn
from caster_dta_torch.nn.attention import MultiheadAttention
from caster_dta_torch.nn.common import Dense, LayerNorm, apply_act, dropout, select_activation


class _Tower(nn.Module):
    """Holds a tower as ``gnn_model``, the reference's module path."""

    def __init__(self, gnn_model: nn.Module):
        super().__init__()
        self.gnn_model = gnn_model


class CrossAttentionModule(nn.Module):
    """Bidirectional cross-attention: pre-LN, MHA both ways with key padding
    masks, optional residual streams with 2-layer FFNs (``ff1.0``/``ff1.3``)."""

    def __init__(self, embed_dim_1: int, embed_dim_2: int, n_attention_heads: int,
                 attn_dropout: float = 0.0, include_residual_stream: bool = True,
                 dim_feedforward_scale: int = 2, feedforward_dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        d1, d2 = embed_dim_1, embed_dim_2
        self.include_residual_stream = include_residual_stream
        self.feedforward_dropout = feedforward_dropout
        self.preattn_norm1 = LayerNorm(d1, eps=1e-5)
        self.preattn_norm2 = LayerNorm(d2, eps=1e-5)
        self.embed1_to_2 = MultiheadAttention(d1, n_attention_heads, kdim=d2, vdim=d2,
                                              dropout=attn_dropout, generator=g)
        self.embed2_to_1 = MultiheadAttention(d2, n_attention_heads, kdim=d1, vdim=d1,
                                              dropout=attn_dropout, generator=g)
        if include_residual_stream:
            s = dim_feedforward_scale
            self.ff_norm1 = LayerNorm(d1, eps=1e-5)
            self.ff_norm2 = LayerNorm(d2, eps=1e-5)
            # ReLU and dropout sit at 1 and 2 so the linears keep the
            # reference's names ff*.0 and ff*.3; forward applies them itself
            self.ff1 = nn.Sequential(Dense(d1, d1 * s, generator=g), nn.ReLU(), nn.Identity(),
                                     Dense(d1 * s, d1, generator=g))
            self.ff2 = nn.Sequential(Dense(d2, d2 * s, generator=g), nn.ReLU(), nn.Identity(),
                                     Dense(d2 * s, d2, generator=g))

    def forward(self, embed_1, embed_2, mask1, mask2,
                generator: Optional[torch.Generator] = None):
        x1n, x2n = self.preattn_norm1(embed_1), self.preattn_norm2(embed_2)
        x1_attn, w1 = self.embed1_to_2(x1n, x2n, x2n, key_padding_mask=~mask2,
                                       generator=generator)
        x2_attn, w2 = self.embed2_to_1(x2n, x1n, x1n, key_padding_mask=~mask1,
                                       generator=generator)
        if not self.include_residual_stream:
            return x1_attn, x2_attn, (w1, w2)

        def drop(x):
            return dropout(x, self.feedforward_dropout, self.training, generator)

        def residual(e, attn, norm, ff):
            e = e + drop(attn)
            h = drop(F.relu(ff[0](norm(e))))
            return e + drop(ff[3](h))

        e1 = residual(embed_1, x1_attn, self.ff_norm1, self.ff1)
        e2 = residual(embed_2, x2_attn, self.ff_norm2, self.ff2)
        return e1, e2, (w1, w2)


class JointGNN(nn.Module):
    """forward(protein, molecule) -> (score [B, 1], attn_weights): one tuple per
    cross-attention layer of (residues->atoms [B, R, A], atoms->residues
    [B, A, R]) head-averaged weights."""

    def __init__(self, protein_gnn_kwargs: Dict[str, Any], molecule_gnn_kwargs: Dict[str, Any],
                 residue_lin_depth: int = 1, atom_lin_depth: int = 1,
                 n_attention_heads: int = 8, attention_dropout: float = 0.0,
                 protein_lin_depth: int = 1, molecule_lin_depth: int = 1,
                 pairwise_embedding_dim: int = 512, out_lin_depth: int = 1,
                 out_lin_factor: float = 0.5, out_lin_norm_type: Optional[str] = None,
                 activation: str = "relu", dropout: float = 0.0, element_pooling: str = "mean",
                 include_residual_stream: bool = True, residual_dim_ff_scale: int = 2,
                 num_cross_attn_layers: int = 1, include_post_pool_layernorm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if out_lin_norm_type not in (None, "layer"):
            raise NotImplementedError(f"out_lin_norm_type {out_lin_norm_type!r} "
                                      "(MaskedBatchNorm) is not ported yet")
        g = generator
        self.act = select_activation(activation)
        self.dropout, self.element_pooling = dropout, element_pooling
        self.protein_gnn = _Tower(make_protein_gnn(generator=g, **protein_gnn_kwargs))
        self.molecule_gnn = _Tower(make_molecule_gnn(generator=g, **molecule_gnn_kwargs))

        def lins(depth, d, factor=2.0):
            mods = []
            for _ in range(depth):
                mods.append(Dense(d, int(d * factor), generator=g))
                d = int(d * factor)
            return nn.ModuleList(mods), d

        p_out = protein_gnn_kwargs["out_channels"]
        p_out = p_out if isinstance(p_out, int) else p_out[0]
        self.residue_lins, d1 = lins(residue_lin_depth, p_out)
        self.atom_lins, d2 = lins(atom_lin_depth, molecule_gnn_kwargs["out_channels"])
        self.cross_attn_module = nn.Module()
        self.cross_attn_module.cross_attn_layers = nn.ModuleList(
            CrossAttentionModule(d1, d2, n_attention_heads, attn_dropout=attention_dropout,
                                 include_residual_stream=include_residual_stream,
                                 dim_feedforward_scale=residual_dim_ff_scale,
                                 feedforward_dropout=dropout, generator=g)
            for _ in range(num_cross_attn_layers))
        self.include_post_pool_layernorm = include_post_pool_layernorm
        if include_post_pool_layernorm:
            self.protein_post_pool_norm = LayerNorm(d1, eps=1e-5)
            self.molecule_post_pool_norm = LayerNorm(d2, eps=1e-5)
        self.protein_lins, dp = lins(protein_lin_depth, d1)
        self.molecule_lins, dm = lins(molecule_lin_depth, d2)
        self.pm_embed_lin = Dense(dp + dm, pairwise_embedding_dim, generator=g)
        self.out_fc_layers, do = lins(out_lin_depth, pairwise_embedding_dim, out_lin_factor)
        if out_lin_norm_type == "layer":
            self.out_fc_norms = nn.ModuleList(LayerNorm(lin.out_features, eps=1e-5)
                                              for lin in self.out_fc_layers)
        self.output_layer = Dense(do, 1, generator=g)

    def _lin_stack(self, x, lins, generator, norms=None):
        for i, lin in enumerate(lins):
            x = lin(x)
            if norms is not None:
                x = norms[i](x)
            x = dropout(apply_act(self.act, x), self.dropout, self.training, generator)
        return x

    def forward(self, protein_graph: GraphBatch, molecule_graph: GraphBatch,
                return_attention: bool = True, generator: Optional[torch.Generator] = None):
        residue = self.protein_gnn.gnn_model(protein_graph, generator=generator)
        atom = self.molecule_gnn.gnn_model(molecule_graph, generator=generator)
        return self.head(residue, atom, protein_graph.node_mask, molecule_graph.node_mask,
                         return_attention, generator)

    def head(self, residue, atom, residue_mask, atom_mask, return_attention=True,
             generator: Optional[torch.Generator] = None):
        """Everything after the towers: lin stacks, cross-attention, pooling
        and the output MLP."""
        residue = self._lin_stack(residue, self.residue_lins, generator)
        atom = self._lin_stack(atom, self.atom_lins, generator)
        attn = []
        for layer in self.cross_attn_module.cross_attn_layers:
            residue, atom, w = layer(residue, atom, residue_mask, atom_mask, generator=generator)
            attn.append(w)
        protein = masked_pool(residue, residue_mask, self.element_pooling)
        molecule = masked_pool(atom, atom_mask, self.element_pooling)
        if self.include_post_pool_layernorm:
            protein = self.protein_post_pool_norm(protein)
            molecule = self.molecule_post_pool_norm(molecule)
        protein = dropout(apply_act(self.act, protein), self.dropout, self.training, generator)
        molecule = dropout(apply_act(self.act, molecule), self.dropout, self.training, generator)
        protein = self._lin_stack(protein, self.protein_lins, generator)
        molecule = self._lin_stack(molecule, self.molecule_lins, generator)
        x = self.pm_embed_lin(torch.cat([protein, molecule], dim=-1))
        x = dropout(apply_act(self.act, x), self.dropout, self.training, generator)
        x = self._lin_stack(x, self.out_fc_layers, generator, getattr(self, "out_fc_norms", None))
        score = self.output_layer(x)
        return score, (attn if return_attention and attn else None)


def make_joint_gnn(protein_gnn_kwargs: dict, molecule_gnn_kwargs: dict,
                   generator: Optional[torch.Generator] = None, **joint_gnn_kwargs) -> JointGNN:
    """Build the model from the three kwargs dicts of model_kwargs.json."""
    return JointGNN(dict(protein_gnn_kwargs), dict(molecule_gnn_kwargs),
                    generator=generator, **joint_gnn_kwargs)
