"""Scalar graph convolutions over padded batches (counterpart of
caster_dta_tpu/nn/conv.py). Only GINE is on the served path."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from caster_dta_torch.nn.common import MLP, Dense
from caster_dta_torch.ops import segment


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
