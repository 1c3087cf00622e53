"""Geometric Vector Perceptron layers (counterpart of caster_dta_tpu/nn/gvp.py).

Features are ``(s, v)`` tuples with ``s: [..., ns]`` and ``v: [..., nv, 3]``
(``nv`` may be 0). Graphs are the padded batches of data/graphs.py; GVPConv
gathers both endpoints with one merged row gather and aggregates with one
sorted segment-sum (ops/segment.py: kernels K2 and K1 on the card).

Parameter names follow the reference state dict (``message_func.{j}``,
``norm.{0,1}``, ``ff_func.{j}``), so ``caster_dta_tpu.interop.torch_import``
maps them to the JAX tree. The fused-message, remat and autoregressive
branches of the JAX module are not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from caster_dta_torch.nn.common import (Dense, LayerNorm, apply_act, dropout, get_compute_dtype,
                                       select_activation)
from caster_dta_torch.ops import segment

SV = Tuple[torch.Tensor, torch.Tensor]
Dims = Tuple[int, int]


def tuple_sum(*args: SV) -> SV:
    s_args, v_args = zip(*args)
    return sum(s_args[1:], s_args[0]), sum(v_args[1:], v_args[0])


def tuple_cat(*args: SV) -> SV:
    """Concatenate (s, V) tuples along the channel axis."""
    s_args, v_args = zip(*args)
    return torch.cat(s_args, dim=-1), torch.cat(v_args, dim=-2)


def norm_no_nan(x: torch.Tensor, dim=-1, keepdim=False, eps=1e-8, sqrt=True) -> torch.Tensor:
    """L2 norm with the squared norm clamped at eps from below."""
    out = torch.clamp(torch.sum(torch.square(x), dim=dim, keepdim=keepdim), min=eps)
    return torch.sqrt(out) if sqrt else out


def merge_sv(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flatten the vector channels and append them to the scalars."""
    return torch.cat([s, v.reshape(v.shape[:-2] + (3 * v.shape[-2],))], dim=-1)


def split_sv(x: torch.Tensor, nv: int) -> SV:
    """Inverse of merge_sv."""
    if nv == 0:
        return x, x.new_zeros(x.shape[:-1] + (0, 3))
    return x[..., :-3 * nv], x[..., -3 * nv:].reshape(x.shape[:-1] + (nv, 3))


class GVP(nn.Module):
    """Geometric Vector Perceptron, (si, vi) -> (so, vo)."""

    def __init__(self, in_dims: Dims, out_dims: Dims, h_dim: Optional[int] = None,
                 activations=("relu", "sigmoid"), vector_gate: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.si, self.vi = in_dims
        self.so, self.vo = out_dims
        self.vector_gate = vector_gate
        self.scalar_act = select_activation(activations[0])
        self.vector_act = select_activation(activations[1])
        g = generator
        if self.vi:
            h = h_dim or max(self.vi, self.vo)
            self.wh = Dense(self.vi, h, bias=False, generator=g)
            self.ws = Dense(self.si + h, self.so, generator=g)
            if self.vo:
                self.wv = Dense(h, self.vo, bias=False, generator=g)
                if vector_gate:
                    self.wsv = Dense(self.so, self.vo, generator=g)
        else:
            self.ws = Dense(self.si, self.so, generator=g)

    def forward(self, x: SV) -> SV:
        s, v = x
        if self.vi:
            vh = self.wh(v.transpose(-1, -2))                  # [..., 3, h]
            vn = norm_no_nan(vh, dim=-2)                       # [..., h]
            s = self.ws(torch.cat([s, vn], dim=-1))
            if self.vo:
                vout = self.wv(vh).transpose(-1, -2)           # [..., vo, 3]
                if self.vector_gate:
                    gate = self.wsv(apply_act(self.vector_act, s))
                    vout = vout * torch.sigmoid(gate)[..., None]
                elif self.vector_act is not None:
                    vout = vout * self.vector_act(norm_no_nan(vout, dim=-1, keepdim=True))
            else:
                vout = s.new_zeros(s.shape[:-1] + (0, 3))
        else:
            s = self.ws(s)
            vout = s.new_zeros(s.shape[:-1] + (self.vo, 3))
        return apply_act(self.scalar_act, s), vout


class GVPLayerNorm(nn.Module):
    """Scalar LayerNorm (eps 1e-5) plus vector RMS-norm across channels."""

    def __init__(self, dims: Dims):
        super().__init__()
        self.scalar_norm = LayerNorm(dims[0], eps=1e-5)

    def forward(self, x: SV) -> SV:
        s, v = x
        s = self.scalar_norm(s)
        if v.shape[-2] == 0:
            return s, v
        vn = norm_no_nan(v, dim=-1, keepdim=True, sqrt=False)   # [..., nv, 1]
        vn = torch.sqrt(torch.mean(vn, dim=-2, keepdim=True))   # [..., 1, 1]
        return s, v / vn


class GVPDropout(nn.Module):
    """(s, V) dropout in training; whole 3-vector channels drop together."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: SV, generator: Optional[torch.Generator] = None) -> SV:
        s, v = x
        if self.rate == 0.0 or not self.training:
            return x
        s = dropout(s, self.rate, True, generator)
        if v.shape[-2]:
            keep = torch.rand(v.shape[:-1], generator=generator, device=v.device) >= self.rate
            v = torch.where(keep[..., None], v / (1.0 - self.rate), torch.zeros_like(v))
        return s, v


class GVPConv(nn.Module):
    """GVP message passing over a padded batch's edges: per edge (src=j,
    dst=i) message = GVP-MLP(cat((s_j, v_j), edge, (s_i, v_i))), aggregated at
    dst by ``aggr`` ('sum'/'add' or 'mean')."""

    def __init__(self, in_dims: Dims, out_dims: Dims, edge_dims: Dims, n_layers: int = 3,
                 aggr: str = "mean", activations=("relu", "sigmoid"),
                 vector_gate: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dims, self.aggr = tuple(out_dims), aggr
        si, vi = in_dims
        se, ve = edge_dims
        msg_in = (2 * si + se, 2 * vi + ve)
        plain = (None, None)
        if n_layers == 1:
            acts = [plain]
        else:
            acts = [activations] * (n_layers - 1) + [plain]
        dims = [msg_in] + [self.out_dims] * n_layers
        self.message_func = nn.ModuleList(
            GVP(dims[i], dims[i + 1], activations=acts[i], vector_gate=vector_gate,
                generator=generator) for i in range(n_layers))

    def forward(self, x: SV, edge_src, edge_dst, edge_mask, edge_attr: SV) -> SV:
        s, v = x
        cd = get_compute_dtype()
        if cd is not None:
            # cast once BEFORE the endpoint gather (caster_dta_tpu/nn/gvp.py
            # GVPConv): the first op the features meet is a Dense in cd anyway,
            # and K2 gathers (K3 scatters) half the bytes
            s, v = s.to(cd), v.to(cd)
            edge_attr = (edge_attr[0].to(cd), edge_attr[1].to(cd))
        nv_in = v.shape[-2]
        e = edge_src.shape[1]
        # one merged-(s, v) row gather for both endpoints: [B, 2E, ns + 3nv]
        both = segment.gather_nodes(merge_sv(s, v), torch.cat([edge_src, edge_dst], dim=1))
        s_j, v_j = split_sv(both[:, :e], nv_in)
        s_i, v_i = split_sv(both[:, e:], nv_in)
        msg = tuple_cat((s_j, v_j), edge_attr, (s_i, v_i))
        for layer in self.message_func:
            msg = layer(msg)
        out = segment.aggregate(merge_sv(*msg), edge_dst, edge_mask, s.shape[1], self.aggr)
        return split_sv(out, self.out_dims[1])


class GVPConvLayer(nn.Module):
    """Residual GVP conv block: conv -> add+norm -> GVP feedforward -> add+norm,
    with an optional node_mask partial update."""

    def __init__(self, node_dims: Dims, edge_dims: Dims, n_message: int = 3,
                 n_feedforward: int = 2, drop_rate: float = 0.1,
                 activations=("relu", "sigmoid"), vector_gate: bool = False,
                 aggr: Optional[str] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        node_dims = tuple(node_dims)
        g = generator
        self.conv = GVPConv(node_dims, node_dims, edge_dims, n_message, aggr=aggr or "mean",
                            activations=activations, vector_gate=vector_gate, generator=g)
        self.norm = nn.ModuleList([GVPLayerNorm(node_dims), GVPLayerNorm(node_dims)])
        self.dropout = nn.ModuleList([GVPDropout(drop_rate), GVPDropout(drop_rate)])
        plain = (None, None)
        if n_feedforward == 1:
            dims, acts = [node_dims, node_dims], [plain]
        else:
            hid = (4 * node_dims[0], 2 * node_dims[1])
            dims = [node_dims] + [hid] * (n_feedforward - 1) + [node_dims]
            acts = [activations] * (n_feedforward - 1) + [plain]
        self.ff_func = nn.ModuleList(
            GVP(dims[i], dims[i + 1], activations=acts[i], vector_gate=vector_gate, generator=g)
            for i in range(n_feedforward))

    def forward(self, x: SV, edge_src, edge_dst, edge_mask, edge_attr: SV,
                node_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> SV:
        dh = self.conv(x, edge_src, edge_dst, edge_mask, edge_attr)
        dh = self.dropout[0](dh, generator)
        h = self.norm[0](tuple_sum(x, dh))
        ff = h
        for layer in self.ff_func:
            ff = layer(ff)
        ff = self.dropout[1](ff, generator)
        out = self.norm[1](tuple_sum(h, ff))
        if node_mask is not None:
            m = node_mask[..., None]
            out = (torch.where(m, out[0], x[0]), torch.where(m[..., None], out[1], x[1]))
        return out
