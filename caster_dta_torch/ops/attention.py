"""Blockwise masked multi-head attention, forward only (counterpart of
caster_dta_tpu/ops/pallas_attention.py::masked_mha).

A CUDA tensor goes to the hand-written kernel K4 of ops/cuda_attention.py, a
CPU tensor to its plain PyTorch version. The layout is the JAX function's,
[B, H, L, hd], and q, k and v are cast to f32 whatever comes in, as there.

Forward only, as in the JAX package, which retired its differentiable
``flash_mha``: training takes the dense attention of nn/attention.py. Under
autograd this function raises rather than return an output that no gradient
can flow through.
"""
from __future__ import annotations

from typing import Optional

import torch

from caster_dta_torch.ops import cuda_attention


def masked_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, Lq, hd]; k, v [B, H, Lk, hd]; key_padding_mask bool [B, Lk]
    with True marking a padding key (torch convention). -> [B, H, Lq, hd] f32.
    A fully masked row averages v over its keys."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("masked_mha is forward only (as the JAX package's): it has no "
                           "backward. Call it under torch.no_grad(), or train through the "
                           "dense attention (MultiheadAttention with use_pallas=False).")
    q, k, v = (t.to(torch.float32).contiguous() for t in (q, k, v))
    if key_padding_mask is not None:
        key_padding_mask = key_padding_mask.to(torch.bool).contiguous()
    return cuda_attention.masked_mha(q, k, v, key_padding_mask)
