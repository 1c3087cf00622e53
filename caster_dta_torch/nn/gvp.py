"""Geometric Vector Perceptron layers (counterpart of caster_dta_tpu/nn/gvp.py).

Features are ``(s, v)`` tuples with ``s: [..., ns]`` and ``v: [..., nv, 3]``
(``nv`` may be 0). Graphs are the padded batches of data/graphs.py; GVPConv
gathers both endpoints with one merged row gather and aggregates with one
sorted segment-sum (ops/segment.py: kernels K2 and K1 on the card).

Parameter names follow the reference state dict (``message_func.{j}``,
``norm.{0,1}``, ``ff_func.{j}``), so ``caster_dta_tpu.interop.torch_import``
maps them to the JAX tree. Inside ``with fused_message():``, GVPConv runs the
JAX module's fused branch instead: a layout pin of the node table (K6), the
merged gather (K2), the whole message MLP in one kernel (K5, ops/
gvp_message.py) and the aggregation (K1), with the same parameters.

Inside ``with remat_message():`` (the JAX package's ``REMAT_MESSAGE =
True``), a conv that computes gradients keeps its gathered endpoints and
recomputes the message MLP and the aggregation in the backward pass
(``torch.utils.checkpoint``), as JAX's remat policy saves only
``"gathered_endpoints"``: less memory, the same numbers.

GVPConvLayer's ``boundary`` branch is the edge-partitioned execution of
parallel/partition.py: a second edge block whose sources lie in an extended
node table (local rows, then the halo rows from the other ranks) adds its
messages into the same local rows, and ``shard_rows`` makes its dropout
masks partition-invariant (nn/common.py ``keep_mask``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from caster_dta_torch.nn.common import (Dense, LayerNorm, apply_act, dropout, get_compute_dtype,
                                       keep_mask, select_activation)
from caster_dta_torch.ops import gvp_message, segment

SV = Tuple[torch.Tensor, torch.Tensor]
Dims = Tuple[int, int]

_FUSED_MESSAGE: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "caster_dta_torch_fused_message", default=False)

_REMAT_MESSAGE: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "caster_dta_torch_remat_message", default=False)

# the JAX gate's bound on the merged endpoint gather, 2 E (ns + 3nv) f32 bytes
FUSED_GATHER_BYTES = 4_000_000


@contextlib.contextmanager
def _switch(var: contextvars.ContextVar, enabled: bool) -> Iterator[None]:
    token = var.set(bool(enabled))
    try:
        yield
    finally:
        var.reset(token)


def fused_message(enabled: bool = True):
    """GVPConv's fused message path for the ``with`` block only, wherever
    its gate admits it (the JAX package's ``USE_FUSED_MESSAGE = True``). Off
    outside any such block, as JAX's default."""
    return _switch(_FUSED_MESSAGE, enabled)


def remat_message(enabled: bool = True):
    """GVPConv recomputes its message MLP and aggregation in the backward
    pass, for the ``with`` block only (the JAX package's ``REMAT_MESSAGE =
    True``). Off outside any such block, as JAX's default."""
    return _switch(_REMAT_MESSAGE, enabled)


def switches() -> tuple:
    """The switches in force (fused, remat): what a captured graph fixes."""
    return _FUSED_MESSAGE.get(), _REMAT_MESSAGE.get()


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
    """(s, V) dropout in training; whole 3-vector channels drop together.

    ``shard_rows=(index, n_shards)`` makes the masks partition-invariant for
    node rows (dim 1) split over ``n_shards`` ranks (parallel/partition.py):
    each rank draws the mask of the global ``n_shards * Ns`` rows from the
    shared generator and keeps its ``index``-th block, so the partitioned
    model applies exactly the single-device model's masks."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: SV, generator: Optional[torch.Generator] = None,
                shard_rows: Optional[Tuple[int, int]] = None) -> SV:
        s, v = x
        if self.rate == 0.0 or not self.training:
            return x
        shards = None if shard_rows is None else {1: shard_rows}
        s = dropout(s, self.rate, True, generator, shards)
        if v.shape[-2]:
            keep = keep_mask(v.shape[:-1], self.rate, generator, v.device, shards)
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
        self.activations, self.vector_gate = tuple(activations), vector_gate
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

    def fused_ok(self, x: SV, edge_src: torch.Tensor, edge_attr: SV) -> bool:
        """The JAX gate of the fused message path (caster_dta_tpu/nn/gvp.py
        GVPConv), condition for condition."""
        s, v = x
        nv_in, e = v.shape[-2], edge_src.shape[1]
        return bool(self.vector_gate and nv_in > 0 and self.out_dims[1] > 0
                    and edge_attr[1].shape[-2] > 0
                    and all(a in ("relu", "sigmoid", None) for a in self.activations)
                    and 2 * e * (s.shape[-1] + 3 * nv_in) * 4 <= FUSED_GATHER_BYTES
                    and _FUSED_MESSAGE.get())

    def forward(self, x: SV, edge_src, edge_dst, edge_mask, edge_attr: SV,
                message_mask: Optional[torch.Tensor] = None, aggr: Optional[str] = None) -> SV:
        """``message_mask`` [B, E] bool, when given, is ANDed into the edge
        mask of the aggregation; ``aggr``, when given, replaces the conv's
        own (the boundary branch of GVPConvLayer sums both blocks)."""
        s, v = x
        fused = self.fused_ok(x, edge_src, edge_attr)
        cd = get_compute_dtype()
        if cd is not None and not fused:
            # cast once BEFORE the endpoint gather (caster_dta_tpu/nn/gvp.py
            # GVPConv): the first op the features meet is a Dense in cd anyway,
            # and K2 gathers (K3 scatters) half the bytes. Not on the fused
            # path: there the node table and edge attributes keep the dtypes
            # the layers before them return, and K5 rounds its operands.
            s, v = s.to(cd), v.to(cd)
            edge_attr = (edge_attr[0].to(cd), edge_attr[1].to(cd))
        sv = merge_sv(s, v)
        if fused:
            sv = gvp_message.layout_pin(sv)                            # K6
        # one merged-(s, v) row gather for both endpoints: [B, 2E, ns + 3nv]
        both = segment.gather_nodes(sv, torch.cat([edge_src, edge_dst], dim=1))
        mask = edge_mask if message_mask is None else edge_mask & message_mask
        args = (both, edge_attr[0], edge_attr[1], edge_dst, mask, s.shape[1], v.shape[-2], fused,
                aggr or self.aggr)
        if _REMAT_MESSAGE.get() and torch.is_grad_enabled():
            # the gathered endpoints stay saved; the message MLP and the
            # aggregation run again in the backward pass (nothing in them
            # draws random numbers, so no RNG state is kept)
            out = torch.utils.checkpoint.checkpoint(self._message, *args, use_reentrant=False,
                                                    preserve_rng_state=False)
        else:
            out = self._message(*args)
        return split_sv(out, self.out_dims[1])

    def _message(self, both, edge_s, edge_v, edge_dst, mask, num_nodes: int, nv_in: int,
                 fused: bool, aggr: str) -> torch.Tensor:
        """The message MLP on the gathered endpoints and its aggregation ->
        merged (s, v) rows [B, N, so + 3vo]."""
        e = edge_dst.shape[1]
        ns = both.shape[-1] - 3 * nv_in
        if fused:
            merged = gvp_message.fused_message_mlp(                     # K5
                both, edge_s, edge_v, self.message_func, ns=ns, nv=nv_in,
                activations=self.activations)
        else:
            s_j, v_j = split_sv(both[:, :e], nv_in)
            s_i, v_i = split_sv(both[:, e:], nv_in)
            msg = tuple_cat((s_j, v_j), (edge_s, edge_v), (s_i, v_i))
            for layer in self.message_func:
                msg = layer(msg)
            merged = merge_sv(*msg)
        return segment.aggregate(merged, edge_dst, mask, num_nodes, aggr)


class GVPConvLayer(nn.Module):
    """Residual GVP conv block: conv -> add+norm -> GVP feedforward -> add+norm,
    with an optional node_mask partial update. ``autoregressive`` layers
    (aggr 'add' or None only) message forward edges (src < dst) from ``x``
    and the others from ``autoregressive_x``, with one conv's parameters, and
    divide the sum by the real in-degree.

    ``boundary=(x_ext, src, dst, mask, edge_attr)`` is the edge-partitioned
    path (parallel/partition.py): a second edge block whose sources index an
    extended node table (the local rows, then the halo rows) and whose
    messages add into the same local rows. The interior block runs first and
    does not depend on the halo; both share the conv's parameters, aggregate
    with 'add', and 'mean' divides once by the combined in-degree.
    ``shard_rows`` goes to both dropouts (GVPDropout)."""

    def __init__(self, node_dims: Dims, edge_dims: Dims, n_message: int = 3,
                 n_feedforward: int = 2, drop_rate: float = 0.1, autoregressive: bool = False,
                 activations=("relu", "sigmoid"), vector_gate: bool = False,
                 aggr: Optional[str] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        node_dims = tuple(node_dims)
        g = generator
        if autoregressive:
            if aggr is not None and aggr != "add":
                raise ValueError("autoregressive GVPConvLayer requires aggr='add'")
            aggr = "add"
        self.aggr = aggr or "mean"
        self.conv = GVPConv(node_dims, node_dims, edge_dims, n_message, aggr=self.aggr,
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
                autoregressive_x: Optional[SV] = None,
                node_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, boundary=None,
                shard_rows: Optional[Tuple[int, int]] = None) -> SV:
        if boundary is not None:
            if autoregressive_x is not None:
                raise ValueError("boundary and autoregressive are exclusive")
            x_ext, b_src, b_dst, b_mask, b_eattr = boundary
            ns = x[0].shape[1]
            conv_aggr = "add" if self.aggr == "mean" else self.aggr
            dh_i = self.conv(x, edge_src, edge_dst, edge_mask, edge_attr, aggr=conv_aggr)
            dh_b = self.conv(x_ext, b_src, b_dst, b_mask, b_eattr, aggr=conv_aggr)
            dh = tuple_sum(dh_i, (dh_b[0][:, :ns], dh_b[1][:, :ns]))
            if self.aggr == "mean":
                count = torch.clamp(segment.segment_degree(edge_dst, edge_mask, ns)
                                    + segment.segment_degree(b_dst, b_mask, ns), min=1.0)
                dh = (dh[0] / count[..., None], dh[1] / count[..., None, None])
        elif autoregressive_x is not None:
            fwd = edge_src < edge_dst
            dh = tuple_sum(
                self.conv(x, edge_src, edge_dst, edge_mask, edge_attr, message_mask=fwd),
                self.conv(autoregressive_x, edge_src, edge_dst, edge_mask, edge_attr,
                          message_mask=~fwd))
            count = torch.clamp(segment.segment_degree(edge_dst, edge_mask, x[0].shape[1]),
                                min=1.0)
            dh = (dh[0] / count[..., None], dh[1] / count[..., None, None])
        else:
            dh = self.conv(x, edge_src, edge_dst, edge_mask, edge_attr)
        dh = self.dropout[0](dh, generator, shard_rows)
        h = self.norm[0](tuple_sum(x, dh))
        ff = h
        for layer in self.ff_func:
            ff = layer(ff)
        ff = self.dropout[1](ff, generator, shard_rows)
        out = self.norm[1](tuple_sum(h, ff))
        if node_mask is not None:
            m = node_mask[..., None]
            out = (torch.where(m, out[0], x[0]), torch.where(m[..., None], out[1], x[1]))
        return out
