"""Wrappers of the hand-written CUDA kernels K5 (the fused GVP message MLP,
forward and backward) and K6 (copy with an optional f32/bf16 cast) in
``csrc/gvp_message.cu``, with their plain PyTorch versions.

As in ops/cuda_segment.py: a wrapper takes the plain version only for a
tensor on the CPU. For a CUDA tensor it checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream without synchronising, and raises when anything is off: there
is no fallback. Each call that launches adds one to ``LAUNCHES[name]`` (one
K5 bwd call is two launches: the tiles, then the fixed-order sum of their
weight-gradient rows).

The MLP's weights are the port's Dense weights in their own layout ([out,
in]), listed layer by layer as ``wh, ws, bs, wv, wsv, bsv``
(``layer_weights``); vectors stay interleaved (channel * 3 + xyz), as
``merge_sv`` leaves them. The TPU kernel's ``kron(I3, W)`` lifts and
planar/interleaved permutations were layout tricks for its matrix unit and
have no counterpart here.

The plain versions mirror the JAX kernels' arithmetic (``_layer_fwd`` and
``_layer_bwd`` in caster_dta_tpu/ops/pallas_gvp_message.py): every product
rounds both operands to the compute dtype and sums in f32, biases and
elementwise math stay f32, and s and v are rounded to the compute dtype
between layers. The backward is written out, not taken by autograd, so it
rounds where the JAX backward does. They are the CPU path and the reference
the kernels are held against; nothing on the card's path calls them.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from caster_dta_torch.ops import build
from caster_dta_torch.ops.cuda_segment import _check_cuda, _raise_on

K5F = "k5_message_fwd"
K5B = "k5_message_bwd"
K6 = "k6_cast_copy"
LAUNCHES = {K5F: 0, K5B: 0, K6: 0}

EPS = 1e-8
SMEM_LIMIT = 232448          # 227 KB: the most shared memory a block can have
_ACT_CODES = {None: 0, "relu": 1, "sigmoid": 2}
_FLOATS = (torch.float32, torch.bfloat16)

_built: build.Built | None = None
_dims_on_device: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_library() -> build.Built:
    """Build (at first use) and load ``csrc/gvp_message.cu``."""
    global _built
    if _built is None:
        built = build.build("gvp_message.cu")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib = built.lib
        lib.k5_smem_bytes.argtypes = [vp, i, i, i, i, i, i, i]
        lib.k5_smem_bytes.restype = ll
        lib.k5_bwd_kernel.argtypes = [vp] + [i] * 9
        lib.k5_bwd_kernel.restype = i
        lib.k5_fwd_kernel.argtypes = [vp] + [i] * 9
        lib.k5_fwd_kernel.restype = i
        lib.k5_bwd_blocks.argtypes = [vp, i, i, i, i, i, i, ll]
        lib.k5_bwd_blocks.restype = ll
        lib.k5_message_fwd.argtypes = [vp] * 7 + [i] * 14 + [vp]
        lib.k5_message_fwd.restype = i
        lib.k5_message_bwd.argtypes = [vp] * 12 + [i] * 15 + [vp]
        lib.k5_message_bwd.restype = i
        lib.k6_cast_copy.argtypes = [vp, vp, ll, i, i, vp]
        lib.k6_cast_copy.restype = i
        _built = built
    return _built


@dataclass(frozen=True)
class MessageSpec:
    """What the MLP computes besides its weights: node scalar and vector
    channels (ns, nv), the activations of every layer but the last (whose
    are none), and the compute dtype of its products."""
    ns: int
    nv: int
    act_s: Optional[str]
    act_v: Optional[str]
    compute_dtype: torch.dtype


def layer_weights(layers) -> list:
    """The weights of GVP modules (nn/gvp.GVP with vector gate), flat, in
    the kernels' order: per layer wh, ws, bs, wv, wsv, bsv."""
    return [t for g in layers for t in (g.wh.weight, g.ws.weight, g.ws.bias, g.wv.weight,
                                        g.wsv.weight, g.wsv.bias)]


def _layer_dims(weights: Sequence[torch.Tensor], spec: MessageSpec, se: int, ve: int) -> tuple:
    """(h, so, vo) per layer, after checking every weight's shape."""
    if len(weights) == 0 or len(weights) % 6:
        raise ValueError(f"{K5F}: expected 6 weights per layer, got {len(weights)}")
    si, vi = 2 * spec.ns + se, 2 * spec.nv + ve
    dims = []
    for k in range(len(weights) // 6):
        wh, ws, bs, wv, wsv, bsv = weights[6 * k:6 * k + 6]
        h, so, vo = wh.shape[0], ws.shape[0], wv.shape[0]
        want = [(h, vi), (so, si + h), (so,), (vo, h), (vo, so), (vo,)]
        got = [tuple(w.shape) for w in (wh, ws, bs, wv, wsv, bsv)]
        if got != want:
            raise ValueError(f"{K5F}: layer {k} weights {got}, expected {want}")
        dims.append((h, so, vo))
        si, vi = so, vo
    return tuple(dims)


def _check_acts(spec: MessageSpec) -> None:
    for a in (spec.act_s, spec.act_v):
        if a not in _ACT_CODES:
            raise ValueError(f"{K5F}: activation {a!r} is not one of {sorted(map(str, _ACT_CODES))}")
    if spec.compute_dtype not in _FLOATS:
        raise TypeError(f"{K5F}: compute dtype must be float32 or bfloat16, "
                        f"not {spec.compute_dtype}")


# ------------------------------------------------------------------ plain K5

def _rnd(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    return x.to(cdt).to(torch.float32)


def _act(name, x):
    if name == "relu":
        return torch.clamp(x, min=0.0)
    if name == "sigmoid":
        return torch.sigmoid(x)
    return x


def _dact(name, x):
    """Derivative at the pre-activation x; relu's is (x > 0)."""
    if name == "relu":
        return (x > 0).to(x.dtype)
    if name == "sigmoid":
        s = torch.sigmoid(x)
        return s * (1.0 - s)
    return torch.ones_like(x)


def _assemble(both, es, ev, ns, cdt):
    """-> s [R, 2ns + se], v [R, 2nv + ve, 3] of every edge, rounded."""
    b, e2, fb = both.shape
    e = e2 // 2
    r = b * e
    bj, bi = both[:, :e].float(), both[:, e:].float()
    s = torch.cat([bj[..., :ns], es.float(), bi[..., :ns]], -1).reshape(r, -1)
    v = torch.cat([bj[..., ns:], ev.float(), bi[..., ns:]], -1).reshape(r, -1, 3)
    return _rnd(s, cdt), _rnd(v, cdt)


def _layer_fwd(s, v, w, acts, cdt):
    """One gated GVP layer, s [R, si], v [R, vi, 3] -> (s_out f32, v_out f32,
    cache)."""
    wh, ws, bs, wv, wsv, bsv = w
    act_s, act_v = acts
    vh = torch.matmul(_rnd(wh, cdt), v)                      # [R, h, 3]
    q = vh[..., 0] ** 2 + vh[..., 1] ** 2 + vh[..., 2] ** 2
    vn = torch.sqrt(torch.clamp(q, min=EPS))
    sin = torch.cat([s, vn], -1)
    spre = _rnd(sin, cdt) @ _rnd(ws, cdt).t() + bs.float()
    vraw = torch.matmul(_rnd(wv, cdt), _rnd(vh, cdt))        # [R, vo, 3]
    gi = _act(act_v, spre)
    z = _rnd(gi, cdt) @ _rnd(wsv, cdt).t() + bsv.float()
    g = torch.sigmoid(z)
    return _act(act_s, spre), vraw * g[..., None], (s, v, vh, q, vn, spre, vraw, gi, g)


def _layer_bwd(cache, w, acts, cdt, dsout, dvout):
    """The backward of _layer_fwd -> (ds_in, dv_in, weight gradients in the
    weights' layout)."""
    wh, ws, bs, wv, wsv, bsv = w
    act_s, act_v = acts
    s, v, vh, q, vn, spre, vraw, gi, g = cache
    si = s.shape[-1]
    dspre = dsout * _dact(act_s, spre)
    dvraw = dvout * g[..., None]
    dg = dvout[..., 0] * vraw[..., 0] + dvout[..., 1] * vraw[..., 1] + dvout[..., 2] * vraw[..., 2]
    dz = dg * g * (1.0 - g)
    dwsv = _rnd(dz, cdt).t() @ _rnd(gi, cdt)
    dbsv = dz.sum(0)
    dgi = _rnd(dz, cdt) @ _rnd(wsv, cdt)
    dspre = dspre + dgi * _dact(act_v, spre)
    sin = torch.cat([s, vn], -1)
    dws = _rnd(dspre, cdt).t() @ _rnd(sin, cdt)
    dbs = dspre.sum(0)
    dsin = _rnd(dspre, cdt) @ _rnd(ws, cdt)
    ds, dvn = dsin[:, :si], dsin[:, si:]
    dvh = torch.matmul(_rnd(wv, cdt).t(), _rnd(dvraw, cdt))  # [R, h, 3]
    dwv = torch.einsum("rjd,rod->oj", _rnd(vh, cdt), _rnd(dvraw, cdt))
    coef = torch.where(q > EPS, dvn / vn, torch.zeros_like(vn))
    dvh = dvh + vh * coef[..., None]
    dv = torch.matmul(_rnd(wh, cdt).t(), _rnd(dvh, cdt))    # [R, vi, 3]
    dwh = torch.einsum("rid,rjd->ji", v, _rnd(dvh, cdt))
    return ds, dv, (dwh, dws, dbs, dwv, dwsv, dbsv)


def _forward_layers(both, es, ev, weights, spec, keep):
    cdt = spec.compute_dtype
    s, v = _assemble(both, es, ev, spec.ns, cdt)
    n_layers = len(weights) // 6
    caches = []
    for k in range(n_layers):
        acts = (spec.act_s, spec.act_v) if k < n_layers - 1 else (None, None)
        s_out, v_out, cache = _layer_fwd(s, v, weights[6 * k:6 * k + 6], acts, cdt)
        if keep:
            caches.append(cache)
        s, v = _rnd(s_out, cdt), _rnd(v_out, cdt)
    return s, v, caches


def message_fwd_plain(both, es, ev, weights, spec: MessageSpec) -> torch.Tensor:
    """Plain version of K5 fwd: the arguments as for ``message_fwd``."""
    b, e = es.shape[:2]
    s, v, _ = _forward_layers(both, es, ev, weights, spec, keep=False)
    out = torch.cat([s, v.reshape(s.shape[0], -1)], -1)
    return out.to(both.dtype).reshape(b, e, -1)


def message_bwd_plain(both, es, ev, weights, dout, spec: MessageSpec):
    """Plain version of K5 bwd: the arguments as for ``message_bwd``."""
    b, e, se = es.shape
    ns, nv, ve = spec.ns, spec.nv, ev.shape[-1] // 3
    n_layers = len(weights) // 6
    _, _, caches = _forward_layers(both, es, ev, weights, spec, keep=True)
    so = weights[-5].shape[0]
    dout = dout.float().reshape(b * e, -1)
    ds, dv = dout[:, :so], dout[:, so:].reshape(b * e, -1, 3)
    grads = [None] * n_layers
    for k in reversed(range(n_layers)):
        acts = (spec.act_s, spec.act_v) if k < n_layers - 1 else (None, None)
        ds, dv, grads[k] = _layer_bwd(caches[k], weights[6 * k:6 * k + 6], acts,
                                      spec.compute_dtype, ds, dv)
    dv = dv.reshape(b * e, -1)
    src = torch.cat([ds[:, :ns], dv[:, :3 * nv]], -1)
    dst = torch.cat([ds[:, ns + se:], dv[:, 3 * (nv + ve):]], -1)
    dboth = torch.cat([src.reshape(b, e, -1), dst.reshape(b, e, -1)], 1).to(both.dtype)
    des = ds[:, ns:ns + se].reshape(b, e, se).to(es.dtype)
    dev = dv[:, 3 * nv:3 * (nv + ve)].reshape(b, e, 3 * ve).to(ev.dtype)
    return dboth, des, dev, [g for layer in grads for g in layer]


# --------------------------------------------------------------- K5 kernels

def _check_message_args(both, es, ev, weights, spec, dout=None) -> tuple:
    _check_acts(spec)
    if both.dim() != 3 or es.dim() != 3 or ev.dim() != 3:
        raise ValueError(f"{K5F}: both, es, ev must be [B, 2E, F], [B, E, se], [B, E, 3ve]")
    b, e, se = es.shape
    fb = spec.ns + 3 * spec.nv
    if tuple(both.shape) != (b, 2 * e, fb) or ev.shape[:2] != es.shape[:2] or ev.shape[2] % 3:
        raise ValueError(f"{K5F}: shapes both {tuple(both.shape)}, es {tuple(es.shape)}, ev "
                         f"{tuple(ev.shape)} for ns={spec.ns}, nv={spec.nv}")
    dims = _layer_dims(weights, spec, se, ev.shape[2] // 3)
    for t in (both, es, ev) + (() if dout is None else (dout,)):
        if t.dtype not in _FLOATS:
            raise TypeError(f"{K5F}: inputs must be float32 or bfloat16, not {t.dtype}")
    if dout is not None and tuple(dout.shape) != (b, e, dims[-1][1] + 3 * dims[-1][2]):
        raise ValueError(f"{K5B}: dout {tuple(dout.shape)} for output rows of "
                         f"{dims[-1][1] + 3 * dims[-1][2]}")
    return dims


def _dims_args(dims: tuple, device: torch.device):
    """The layers' (h, so, vo) on the host (a ctypes array) and on the
    device (kept per device and shape, so it is copied there once)."""
    flat = [x for d in dims for x in d]
    key = (str(device), dims)
    if key not in _dims_on_device:
        _dims_on_device[key] = torch.tensor(flat, dtype=torch.int32, device=device)
    return (ctypes.c_int * len(flat))(*flat), _dims_on_device[key]


def _cdt_bf16(spec: MessageSpec) -> int:
    return int(spec.compute_dtype == torch.bfloat16)


def _check_smem(lib, name, dims, dims_host, spec, se, ve, backward) -> None:
    need = lib.k5_smem_bytes(dims_host, len(dims), spec.ns, spec.nv, se, ve, int(backward),
                             _cdt_bf16(spec))
    if need < 0:
        raise ValueError(f"{name}: layer widths {dims} with ns={spec.ns}, nv={spec.nv}, "
                         f"se={se}, ve={ve} are not taken")
    if need > SMEM_LIMIT:
        raise ValueError(f"{name}: layer widths (h, so, vo) {dims} with ns={spec.ns}, "
                         f"nv={spec.nv}, se={se}, ve={ve} need {need} bytes of shared memory "
                         f"per block, over the {SMEM_LIMIT} a block can have")


BWD_KERNELS = ("block tiles", "warp tiles", "warp tiles, bf16 step")
FWD_KERNELS = ("block tiles", "warp tiles", "warp tiles, served")


def _route(query, tensors, weights, spec: MessageSpec) -> int:
    """A C query of the kernel a call runs: tensors are (both, es, ev, ...)."""
    es, ev = tensors[1], tensors[2]
    dims = _layer_dims(weights, spec, es.shape[-1], ev.shape[-1] // 3)
    flat = [x for d in dims for x in d]
    dtypes = sum(_is_bf16(t) << k for k, t in enumerate(tensors))
    return query((ctypes.c_int * len(flat))(*flat), len(dims), spec.ns, spec.nv, es.shape[-1],
                 ev.shape[-1] // 3, _cdt_bf16(spec), _ACT_CODES[spec.act_s],
                 _ACT_CODES[spec.act_v], dtypes)


def bwd_kernel(both, es, ev, weights, dout, spec: MessageSpec) -> str:
    """Which kernel ``message_bwd`` runs for these arguments (one of
    BWD_KERNELS): the block-tile kernel (f32 products, or widths without a
    warp-tile instance), the warp-tile kernel (mma.sync, bf16 products), or
    its instance for the served model's bf16 training step ((relu, none)
    activations; both, es and dout f32, ev bf16). Builds the library."""
    return BWD_KERNELS[_route(load_library().lib.k5_bwd_kernel, (both, es, ev, dout), weights,
                              spec)]


def fwd_kernel(both, es, ev, weights, spec: MessageSpec) -> str:
    """Which kernel ``message_fwd`` runs for these arguments (one of
    FWD_KERNELS): the block-tile kernel (widths without a warp-tile
    instance), a warp-tile kernel (mma.sync for bf16 products, FFMA for
    f32), or its served instance: (relu, none) activations with the bf16
    training step's dtypes (both and es f32, ev bf16) or f32 serving's (all
    f32). Builds the library."""
    return FWD_KERNELS[_route(load_library().lib.k5_fwd_kernel, (both, es, ev), weights, spec)]


def _pack(weights) -> torch.Tensor:
    return torch.cat([w.detach().reshape(-1) for w in weights]).to(torch.float32).contiguous()


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def message_fwd(both: torch.Tensor, es: torch.Tensor, ev: torch.Tensor,
                weights: Sequence[torch.Tensor], spec: MessageSpec) -> torch.Tensor:
    """K5 fwd: the gated GVP message MLP of every edge.

    both [B, 2E, ns + 3nv] holds the gathered endpoint rows (row e the
    source's merged (s, v), row E + e the destination's), es [B, E, se] and
    ev [B, E, 3ve] the edge attributes; each f32 or bf16. weights as
    ``layer_weights`` gives them. -> [B, E, so + 3vo] in both's dtype.

    Replaces caster_dta_tpu/ops/pallas_gvp_message.py::_fwd_kernel (via
    fused_message_mlp). Bound by memory bytes on the H100 (see the source);
    at the served model's widths it runs on warp tiles of edges, mma.sync
    for the bf16 compute dtype and FFMA for f32 (``fwd_kernel``)."""
    if both.device.type == "cpu":
        return message_fwd_plain(both, es, ev, weights, spec)
    if both.device.type != "cuda":
        raise ValueError(f"{K5F}: unsupported device {both.device}")
    dims = _check_message_args(both, es, ev, weights, spec)
    w = _pack(weights)
    _check_cuda(K5F, both, es, ev, w)
    b, e, se = es.shape
    ve = ev.shape[2] // 3
    out = torch.empty(b, e, dims[-1][1] + 3 * dims[-1][2], dtype=both.dtype, device=both.device)
    if out.numel() == 0:
        return out
    lib = load_library().lib
    dims_host, dims_dev = _dims_args(dims, both.device)
    _check_smem(lib, K5F, dims, dims_host, spec, se, ve, backward=False)
    with torch.cuda.device(both.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k5_message_fwd(
            both.data_ptr(), es.data_ptr(), ev.data_ptr(), w.data_ptr(), dims_dev.data_ptr(),
            dims_host, out.data_ptr(), b, e, spec.ns, spec.nv, se, ve, len(dims), w.numel(),
            _ACT_CODES[spec.act_s], _ACT_CODES[spec.act_v], _is_bf16(both), _is_bf16(es),
            _is_bf16(ev), _cdt_bf16(spec), stream)
    _raise_on(err, K5F)
    LAUNCHES[K5F] += 1
    return out


def message_bwd(both: torch.Tensor, es: torch.Tensor, ev: torch.Tensor,
                weights: Sequence[torch.Tensor], dout: torch.Tensor, spec: MessageSpec):
    """K5 bwd: recompute the forward and return (d both [B, 2E, F], d es,
    d ev, the weights' gradients summed over every edge), the input
    gradients in their inputs' dtypes and the weight gradients f32 in the
    weights' shapes. dout [B, E, so + 3vo] is f32 or bf16. The weight sums
    have a fixed order and no atomics: two runs give the same bits.

    Replaces caster_dta_tpu/ops/pallas_gvp_message.py::_bwd_kernel. Bound by
    memory bytes on the H100 (see the source); with the bf16 compute dtype
    at the served model's widths it runs on warp tiles of 16 edges and
    mma.sync (``bwd_kernel``)."""
    if both.device.type == "cpu":
        return message_bwd_plain(both, es, ev, weights, dout, spec)
    if both.device.type != "cuda":
        raise ValueError(f"{K5B}: unsupported device {both.device}")
    dims = _check_message_args(both, es, ev, weights, spec, dout)
    w = _pack(weights)
    _check_cuda(K5B, both, es, ev, dout, w)
    b, e, se = es.shape
    ve = ev.shape[2] // 3
    dboth = torch.empty_like(both)
    des = torch.empty_like(es)
    dev = torch.empty_like(ev)
    sizes = [wt.numel() for wt in weights]
    if b * e == 0:
        return dboth, des, dev, [torch.zeros_like(wt, dtype=torch.float32) for wt in weights]
    lib = load_library().lib
    dims_host, dims_dev = _dims_args(dims, both.device)
    _check_smem(lib, K5B, dims, dims_host, spec, se, ve, backward=True)
    with torch.cuda.device(both.device):
        rows = lib.k5_bwd_blocks(dims_host, len(dims), spec.ns, spec.nv, se, ve,
                                 _cdt_bf16(spec), b * e)
        partial = torch.empty(rows, w.numel(), dtype=torch.float32, device=both.device)
        dw = torch.empty(w.numel(), dtype=torch.float32, device=both.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k5_message_bwd(
            both.data_ptr(), es.data_ptr(), ev.data_ptr(), w.data_ptr(), dims_dev.data_ptr(),
            dims_host, dout.data_ptr(), dboth.data_ptr(), des.data_ptr(), dev.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), b, e, spec.ns, spec.nv, se, ve, len(dims),
            w.numel(), _ACT_CODES[spec.act_s], _ACT_CODES[spec.act_v], _is_bf16(both),
            _is_bf16(es), _is_bf16(ev), _is_bf16(dout), _cdt_bf16(spec), stream)
    _raise_on(err, K5B)
    LAUNCHES[K5B] += 1
    return dboth, des, dev, [g.view(wt.shape) for g, wt in zip(dw.split(sizes), weights)]


# ---------------------------------------------------------------------- K6

def cast_copy_plain(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K6: a new tensor of x's values in ``dtype``."""
    return torch.empty(x.shape, dtype=dtype, device=x.device).copy_(x)


def cast_copy(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K6: a copy of x (f32 or bf16, contiguous) in ``dtype`` (f32 or bf16),
    rounded to nearest even where it narrows.

    Replaces caster_dta_tpu/ops/pallas_gvp_message.py::_cast_kernel (via
    layout_pin). Bound by memory bytes on the H100: one read and one write
    per element, in 16-byte words where both pointers are 16-byte aligned."""
    if x.device.type == "cpu":
        return cast_copy_plain(x, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{K6}: unsupported device {x.device}")
    if x.dtype not in _FLOATS or dtype not in _FLOATS:
        raise TypeError(f"{K6}: copies between float32 and bfloat16, not {x.dtype} -> {dtype}")
    _check_cuda(K6, x)
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = load_library().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k6_cast_copy(x.data_ptr(), out.data_ptr(), x.numel(), _is_bf16(x),
                               _is_bf16(out), stream)
    _raise_on(err, K6)
    LAUNCHES[K6] += 1
    return out
