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
k and v per key that a whole tile of query rows shares. Head dims up to 16
run ``masked_mha_rows_kernel`` (query rows held in registers, a chunked
online softmax), wider heads ``masked_mha_kernel`` (``tiling`` says which);
both are one launch a call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from caster_dta_torch.ops import build
from caster_dta_torch.ops.cuda_segment import _check_cuda, _raise_on

K4 = "k4_masked_mha"
LAUNCHES = {K4: 0}
# the bytes each kernel\'s launches read and wrote (build.count_launch)
BYTES = dict.fromkeys(LAUNCHES, 0)

NEG = -1e9            # a masked key's logit, as the JAX kernel's _NEG
HD_MAX = 128          # the wide kernel: 16 head dims a lane, at most 8 lanes a query row
ROWS_HD_MAX = 16      # the row kernel: every head dim of a row in one lane
_THREADS = 128        # at most, per block
_MAX_SPLITS = 32
_FILL_BLOCKS = 2 * 132  # two blocks per SM of the H100
_CHUNK = 128          # keys the row kernel stages at a time (RT_CHUNK)
_PARTIAL = ROWS_HD_MAX + 2   # a row's partial softmax: max, sum, accumulators
_MAX_SPLITS_OUT = 16
# The row kernel's instance, (R, KS, MINB): 2 query rows a lane, 8 keys a
# softmax step, 4 blocks of 4 warps an SM (its __launch_bounds__: 128
# registers; K4_ROWS_INSTANCES in csrc/attention.cu). The fastest at every
# served shape of those scripts/k4_times.py timed (PERF.md, section 6).
_ROWS = (2, 8, 4)

_built: build.Built | None = None
_counters: dict = {}  # device index -> int32 tickets, 0 between launches


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = BYTES[k] = 0


def load_library() -> build.Built:
    """Build (at first use) and load ``csrc/attention.cu``."""
    global _built
    if _built is None:
        built = build.build("attention.cu")
        vp, i = ctypes.c_void_p, ctypes.c_int
        built.lib.k4_masked_mha_rows.argtypes = ([vp] * 7 + [i] * 5 + [ctypes.c_float]
                                                 + [i] * 5 + [vp])
        built.lib.k4_masked_mha_wide.argtypes = ([vp] * 5 + [i] * 5 + [ctypes.c_float]
                                                 + [i] * 3 + [vp])
        built.lib.k4_masked_mha_rows.restype = i
        built.lib.k4_masked_mha_wide.restype = i
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


def tiling(bh: int, lq: int, lk: int, hd: int) -> tuple:
    """The kernel and its tiling, a function of the shapes alone (so a shape
    always sums in the same order):

    - hd <= 16: ``("rows", R, KS, MINB, s_in, s_out)``, the row kernel's
      instance (R query rows a lane, KS keys a softmax step, MINB blocks an
      SM) and splits. A block of 4 warps covers 4 / s_in warps' rows (32 R
      each), and its s_in warps of a row split the keys: as many as the rows
      leave. Where graph-heads times query tiles leave the card under one
      block an SM, s_out blocks (a power of two, at most 16, each over at
      least two staged chunks of keys) share a tile's keys, up to two blocks
      an SM.
    - hd > 16: ``("wide", lanes, rows, splits)``: lanes per query row (16 head
      dims a lane), query rows per block and key splits per row, the fewest
      splits that give the card two blocks per SM, each block at most 128
      threads.
    """
    if hd <= ROWS_HD_MAX:
        r = _ROWS[0]
        groups = -(-lq // (32 * r))                      # warps of rows
        per_block = min(_THREADS // 32, 1 << (groups - 1).bit_length())
        s_in = _THREADS // 32 // per_block
        blocks = bh * -(-groups // per_block)
        s_out = 1
        while (s_out < _MAX_SPLITS_OUT and blocks * s_out * 2 <= _FILL_BLOCKS
               and lk >= 2 * _CHUNK * 2 * s_out):
            s_out *= 2
        return ("rows",) + _ROWS + (s_in, s_out)
    lanes = 1 << max(0, (hd - 1).bit_length() - 4)      # 16 head dims a lane
    rows = min(_THREADS // lanes, 1 << max(0, (lq - 1).bit_length()))
    splits = _THREADS // lanes // rows
    while (splits < _MAX_SPLITS and rows > 1
           and -(-lq // rows) * bh < _FILL_BLOCKS):
        rows //= 2
        splits *= 2
    return "wide", lanes, rows, min(splits, _MAX_SPLITS)


def _tickets(device: torch.device) -> torch.Tensor:
    """The row kernel's per-tile counters on this card: zeroed once, then set
    back to 0 by the kernel itself. A split launch needs one a tile, at most
    _FILL_BLOCKS / 2 (it splits only below that many)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{K4}: the first call on cuda:{index} is inside a CUDA graph "
                               "capture; call it once before capturing")
        _counters[index] = torch.zeros(_FILL_BLOCKS, dtype=torch.int32, device=device)
    return _counters[index]


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
    kind, *tile = tiling(b * h, lq, lk, hd)
    lib = load_library().lib
    mask_ptr = None if key_padding_mask is None else key_padding_mask.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "rows":
            r, ks, per_sm, s_in, s_out = tile
            partial = counters = None
            if s_out > 1:
                rows_block = 32 * r * (_THREADS // 32 // s_in)
                tiles = -(-lq // rows_block)
                partial = torch.empty(b * h * tiles * s_out * _PARTIAL * rows_block,
                                      dtype=torch.float32, device=q.device)
                counters = _tickets(q.device)
                assert b * h * tiles <= counters.numel()
            err = lib.k4_masked_mha_rows(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
                None if partial is None else partial.data_ptr(),
                None if counters is None else counters.data_ptr(), b * h, h, lq, lk, hd,
                scale_of(hd), r, ks, per_sm, s_in, s_out, stream)
        else:
            lanes, rows, splits = tile
            err = lib.k4_masked_mha_wide(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
                                         out.data_ptr(), b * h, h, lq, lk, hd, scale_of(hd),
                                         lanes, rows, splits, stream)
    _raise_on(err, K4)
    build.count_launch(LAUNCHES, BYTES, K4, *tensors, out)
    return out
