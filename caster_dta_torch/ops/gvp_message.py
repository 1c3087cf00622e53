"""The fused GVP message MLP and its layout pin (counterpart of
caster_dta_tpu/ops/pallas_gvp_message.py), as autograd Functions.

``fused_message_mlp`` runs GVPConv's whole per-edge message MLP in one
kernel (K5 fwd on the card) and its backward in another (K5 bwd: the forward
recomputed, then the layers backwards, with the weight gradients summed over
every edge). ``layout_pin`` is the JAX package's pin of the node table before
the endpoint gather: an identity copy with an optional cast (K6), whose
backward copies the cotangent back to the input's dtype. A contiguous torch
tensor has no layout to pin, so here it is only that copy, kept so the fused
path computes what the JAX one does, launch for launch.

Each dispatches by device through ops/cuda_gvp_message.py: the kernels for
CUDA tensors, the plain versions for CPU tensors, nothing else. Numerics are
the JAX kernels' (see that module); gradients of the weights come back in the
weights' dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from caster_dta_torch.nn.common import get_compute_dtype
from caster_dta_torch.ops import cuda_gvp_message as cgm


class _FusedMessage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, both, edge_s, edge_v, spec, *weights):
        ctx.save_for_backward(both, edge_s, edge_v, *weights)
        ctx.spec = spec
        return cgm.message_fwd(both, edge_s, edge_v, weights, spec)

    @staticmethod
    def backward(ctx, dout):
        both, edge_s, edge_v, *weights = ctx.saved_tensors
        dboth, des, dev, dws = cgm.message_bwd(both, edge_s, edge_v, weights, dout.contiguous(),
                                               ctx.spec)
        return (dboth, des, dev, None, *[d.to(w.dtype) for d, w in zip(dws, weights)])


def fused_message_mlp(both: torch.Tensor, edge_s: torch.Tensor, edge_v: torch.Tensor, layers,
                      ns: int, nv: int, activations) -> torch.Tensor:
    """Fused per-edge GVP message MLP.

    both:   [B, 2E, ns + 3nv] gathered merged (s, v) endpoint rows, source
            rows then destination rows (nn/gvp.GVPConv).
    edge_s: [B, E, se]; edge_v: [B, E, ve, 3].
    layers: the conv's message GVPs (vector-gated; their wh/ws/wv/wsv
            weights are used as they are).
    activations: (scalar, vector) of every layer but the last, whose are
            (None, None).
    The products run in ``get_compute_dtype()``, or both's dtype when none
    is set. -> the merged message [B, E, so + 3vo] in both's dtype."""
    b, e, ve = edge_v.shape[:3]
    spec = cgm.MessageSpec(ns, nv, activations[0], activations[1],
                           get_compute_dtype() or both.dtype)
    return _FusedMessage.apply(both.contiguous(), edge_s.contiguous(),
                               edge_v.reshape(b, e, 3 * ve).contiguous(), spec,
                               *cgm.layer_weights(layers))


class _LayoutPin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.in_dtype = x.dtype
        return cgm.cast_copy(x.contiguous(), dtype or x.dtype)

    @staticmethod
    def backward(ctx, g):
        return cgm.cast_copy(g.contiguous(), ctx.in_dtype), None


def layout_pin(x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A copy of x in ``dtype`` (x's own when None); the gradient is copied
    back to x's dtype."""
    return _LayoutPin.apply(x, dtype)
