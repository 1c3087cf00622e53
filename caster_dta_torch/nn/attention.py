"""Multi-head attention with torch.nn.MultiheadAttention's parameters and the
JAX package's numerics (counterpart of caster_dta_tpu/nn/attention.py):
masked logits are set to -1e9 (not -inf), the logits are taken in the input
dtype, the softmax runs in f32 and its weights are cast to v's dtype, and the
returned weights are averaged over heads.

``use_pallas`` (the JAX field's name and default) takes the blockwise branch
of JAX nn/attention.py:76-82 where dropout cannot act (dropout 0 or eval
mode): after the projections, ops/attention.masked_mha (the CUDA kernel K4 on
the card) computes the output without materialising the [B, H, Lq, Lk]
logits, and the weights come back as None. It is forward only. The field
adds no parameter, so checkpoints are the same with it on or off."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from caster_dta_torch.nn.common import Dense, dropout, linear
from caster_dta_torch.ops.attention import masked_mha

_NEG = -1e9


class MultiheadAttention(nn.Module):
    """batch_first MHA: query [B, Lq, E], key/value [B, Lk, kdim/vdim] ->
    (out [B, Lq, E], weights [B, Lq, Lk] averaged over heads; None on the
    ``use_pallas`` branch). key_padding_mask marks padding keys True (torch
    convention).

    Parameters as torch's: ``in_proj_weight`` [3E, E] when kdim == vdim == E,
    else ``q_proj_weight``/``k_proj_weight``/``v_proj_weight``; then
    ``in_proj_bias`` [3E] and ``out_proj``."""

    def __init__(self, embed_dim: int, num_heads: int, kdim: Optional[int] = None,
                 vdim: Optional[int] = None, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None, use_pallas: bool = False):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim, self.num_heads, self.dropout = embed_dim, num_heads, dropout
        self.use_pallas = use_pallas
        kdim, vdim = kdim or embed_dim, vdim or embed_dim
        self.packed = kdim == embed_dim and vdim == embed_dim
        e = embed_dim
        if self.packed:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * e, e))
            _xavier(self.in_proj_weight, generator)
        else:
            self.q_proj_weight = nn.Parameter(torch.empty(e, e))
            self.k_proj_weight = nn.Parameter(torch.empty(e, kdim))
            self.v_proj_weight = nn.Parameter(torch.empty(e, vdim))
            for w in (self.q_proj_weight, self.k_proj_weight, self.v_proj_weight):
                _xavier(w, generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * e))
        self.out_proj = Dense(e, e, generator=generator)
        with torch.no_grad():
            self.out_proj.bias.zero_()

    def _weights(self):
        if self.packed:
            return self.in_proj_weight.chunk(3, dim=0)
        return self.q_proj_weight, self.k_proj_weight, self.v_proj_weight

    def forward(self, query, key, value, key_padding_mask=None,
                generator: Optional[torch.Generator] = None):
        e, h = self.embed_dim, self.num_heads
        hd = e // h
        b, lq, _ = query.shape
        lk = key.shape[1]
        wq, wk, wv = self._weights()
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = linear(query, wq, bq).reshape(b, lq, h, hd).transpose(1, 2)
        k = linear(key, wk, bk).reshape(b, lk, h, hd).transpose(1, 2)
        v = linear(value, wv, bv).reshape(b, lk, h, hd).transpose(1, 2)

        if self.use_pallas and (self.dropout == 0.0 or not self.training):
            out = masked_mha(q, k, v, key_padding_mask)
            return self.out_proj(out.transpose(1, 2).reshape(b, lq, e)), None

        # logits in the input dtype, scaled by sqrt(hd) rounded to that dtype
        scale = torch.tensor(math.sqrt(hd), dtype=q.dtype).item()
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / scale
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], _NEG)
        weights = torch.softmax(logits.to(torch.float32), dim=-1).to(v.dtype)
        used = dropout(weights, self.dropout, self.training, generator)
        out = torch.einsum("bhqk,bhkd->bhqd", used, v)
        out = self.out_proj(out.transpose(1, 2).reshape(b, lq, e))
        return out, weights.mean(dim=1)


def _xavier(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)
