"""Wrapper of the hand-written CUDA kernel K4 (blockwise masked multi-head
attention, forward only) in ``csrc/attention.cu``, with its plain PyTorch
version.

As in ops/cuda_segment.py: the wrapper takes the plain version only for a
tensor on the CPU. For a CUDA tensor it checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on the current
stream without synchronising, and raises when anything is off: there is no
fallback. Each launch adds one to ``LAUNCHES[K4]``.

K4 replaces caster_dta_tpu/ops/pallas_attention.py::_mha_kernel (via _mha and
masked_mha). At the served shapes (hd = 16) it is bound by f32 operations on
the H100: two products of 2 operations per multiply-add, against 16 bytes of
k and v per key that a whole tile of query rows shares.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from caster_dta_torch.ops import build
from caster_dta_torch.ops.cuda_segment import _check_cuda, _raise_on

K4 = "k4_masked_mha"
LAUNCHES = {K4: 0}

NEG = -1e9            # a masked key's logit, as the JAX kernel's _NEG
HD_MAX = 128          # 16 head dims a lane, at most 8 lanes a query row
_THREADS = 128        # at most, per block
_MAX_SPLITS = 32
_FILL_BLOCKS = 2 * 132  # two blocks per SM of the H100

_built: build.Built | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_library() -> build.Built:
    """Build (at first use) and load ``csrc/attention.cu``."""
    global _built
    if _built is None:
        built = build.build("attention.cu")
        vp, i = ctypes.c_void_p, ctypes.c_int
        built.lib.k4_masked_mha.argtypes = [vp] * 5 + [i] * 5 + [ctypes.c_float] + [i] * 3 + [vp]
        built.lib.k4_masked_mha.restype = i
        _built = built
    return _built


def scale_of(hd: int) -> float:
    """The logit scale of the JAX kernel: a Python float that multiplies."""
    return 1.0 / float(hd) ** 0.5


def masked_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K4, the dense f32 math with K4's own logits: q.k^T
    times ``scale_of(hd)``, a masked key's logit replaced by -1e9, softmax
    over the keys, times v. q [B, H, Lq, hd], k and v [B, H, Lk, hd],
    key_padding_mask bool [B, Lk] (True marks a padding key) -> [B, H, Lq, hd]
    f32."""
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale_of(q.shape[-1])
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)


def tiling(bh: int, lq: int, hd: int) -> tuple:
    """(lanes per query row, query rows per block, key splits per row): the
    fewest splits that give the card two blocks per SM, each block at most
    128 threads. A function of the shapes alone, so a shape always sums in
    the same order."""
    lanes = 1 << max(0, (hd - 1).bit_length() - 4)      # 16 head dims a lane
    rows = min(_THREADS // lanes, 1 << max(0, (lq - 1).bit_length()))
    splits = _THREADS // lanes // rows
    while (splits < _MAX_SPLITS and rows > 1
           and -(-lq // rows) * bh < _FILL_BLOCKS):
        rows //= 2
        splits *= 2
    return lanes, rows, min(splits, _MAX_SPLITS)


def masked_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: blockwise masked attention output, forward only. q [B, H, Lq, hd],
    k and v [B, H, Lk, hd], float32 and contiguous, hd <= 128, Lk >= 1;
    key_padding_mask bool [B, Lk] with True marking a padding key, or None.
    -> [B, H, Lq, hd] f32. A fully masked row gives the mean of v over its
    Lk keys, as the dense softmax over constant -1e9 logits does."""
    if q.device.type == "cpu":
        return masked_mha_plain(q, k, v, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"{K4}: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{K4}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, h, lq, hd = q.shape
    lk = k.shape[2]
    if key_padding_mask is not None and (key_padding_mask.shape != (b, lk)
                                         or key_padding_mask.dtype != torch.bool):
        raise ValueError(f"{K4}: key_padding_mask must be bool [{b}, {lk}], got "
                         f"{key_padding_mask.dtype} {tuple(key_padding_mask.shape)}")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError(f"{K4}: q, k and v must be float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd > HD_MAX or hd < 1:
        raise ValueError(f"{K4}: head dim {hd} of q {tuple(q.shape)} is outside [1, {HD_MAX}]")
    if lk < 1:
        raise ValueError(f"{K4}: no keys (k {tuple(k.shape)})")
    if b * h > 65535:
        raise ValueError(f"{K4}: {b} x {h} graph-heads exceed the grid's 65535")
    tensors = (q, k, v) if key_padding_mask is None else (q, k, v, key_padding_mask)
    _check_cuda(K4, *tensors)
    out = torch.empty(b, h, lq, hd, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lanes, rows, splits = tiling(b * h, lq, hd)
    lib = load_library().lib
    mask_ptr = None if key_padding_mask is None else key_padding_mask.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k4_masked_mha(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
                                out.data_ptr(), b * h, h, lq, lk, hd, scale_of(hd), lanes,
                                rows, splits, stream)
    _raise_on(err, K4)
    LAUNCHES[K4] += 1
    return out
