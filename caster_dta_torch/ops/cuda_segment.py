"""Wrappers of the hand-written CUDA kernels K1 (sorted segment-sum), K2
(row gather), K3 (unsorted scatter-add, K2's transpose), K7 (windowed row
gather) and K8 (row-major sorted segment-sum) in ``csrc/segment.cu``, with
their plain PyTorch versions.

A wrapper takes the plain version only for a tensor on the CPU. For a CUDA
tensor it checks device, dtype, shape and contiguity, allocates its output
with ``torch.empty``, launches the kernel on the current stream without
synchronising, and raises when anything is off: there is no fallback. Each
launch adds one to ``LAUNCHES[name]``, so a run can show which kernels carried
it, and its bytes to ``BYTES[name]`` (inputs read once, outputs written once).

The wrappers are not differentiable themselves: ops/segment.py wraps them in
autograd Functions whose backward passes are these same kernels (K1's VJP is a
K2 gather, K2's is a K3 scatter). K7 and K8 compute K2's and K1's functions
in another way and are dispatched on no path, as in the JAX package.
"""
from __future__ import annotations

import ctypes

import torch

from caster_dta_torch.ops import build

K1 = "k1_segment_sum_sorted"
K2 = "k2_gather_rows"
K3 = "k3_scatter_rows"
K7 = "k7_gather_windowed"
K8 = "k8_segment_sum_2d"
LAUNCHES = {K1: 0, K2: 0, K3: 0, K7: 0, K8: 0}
# the bytes each kernel\'s launches read and wrote (build.count_launch)
BYTES = dict.fromkeys(LAUNCHES, 0)
# K1's and K3's kernels by route, as csrc/segment.cu's k1_route and k3_route
# number them
K1_ROUTES = ("narrow", "small", "walk")
K3_ROUTES = ("narrow", "small", "csr + sum")
# the K1 and K3 launches that took the narrow kernel (rows of one or two
# columns), eager calls and captures; a graph replay adds nothing here
NARROW_LAUNCHES = {K1: 0, K3: 0}
K7_WINDOW_BYTES = 32768     # a table row must fit one window of csrc/segment.cu's K7
K3_LONG = 64                # csrc/segment.cu's K3: a row of more ids is summed by a block

_built: build.Built | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = BYTES[k] = 0
    for k in NARROW_LAUNCHES:
        NARROW_LAUNCHES[k] = 0


def load_library() -> build.Built:
    """Build (at first use) and load ``csrc/segment.cu``."""
    global _built
    if _built is None:
        built = build.build("segment.cu")
        vp, i = ctypes.c_void_p, ctypes.c_int
        built.lib.k1_segment_sum_sorted.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
        built.lib.k1_segment_sum_sorted.restype = i
        built.lib.k1_route.argtypes = [i, i, i, i]
        built.lib.k1_route.restype = i
        built.lib.k3_route.argtypes = [i, i, i, i]
        built.lib.k3_route.restype = i
        built.lib.k2_gather_rows.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp]
        built.lib.k2_kernel.argtypes = [i, i, i, i]
        built.lib.k2_gather_rows.restype = i
        built.lib.k3_workspace_ints.argtypes = [i, i, i]
        built.lib.k3_workspace_ints.restype = ctypes.c_int64
        built.lib.k3_scatter_csr.argtypes = [vp, vp, i, i, i, vp]
        built.lib.k3_scatter_csr.restype = i
        built.lib.k3_scatter_rows.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
        built.lib.k3_scatter_rows.restype = i
        built.lib.k7_gather_windowed.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
        built.lib.k7_gather_windowed.restype = i
        built.lib.k8_segment_sum_2d.argtypes = [vp, vp, vp, i, i, i, i, vp]
        built.lib.k8_segment_sum_2d.restype = i
        _built = built
    return _built


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(f"{name}: built for sm_90a, but {dev} is "
                           f"{torch.cuda.get_device_name(dev)}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


_routes: dict = {}


def _route(name: str, b: int, e: int, n: int, f: int) -> int:
    key = (name, b, e, n, f)
    if key not in _routes:
        lib = load_library().lib
        _routes[key] = (lib.k1_route if name == K1 else lib.k3_route)(b, e, n, f)
    return _routes[key]


def k1_route(b: int, e: int, n: int, f: int) -> str:
    """Which of K1's kernels (K1_ROUTES) sums B graphs of E edges into N rows
    of F columns: the narrow kernel (rows of one or two columns of a graph
    that one block holds), segment_small_kernel or segment_walk_kernel. The
    rule is csrc/segment.cu's ``k1_route``. Builds the library."""
    return K1_ROUTES[_route(K1, b, e, n, f)]


def k3_route(b: int, e: int, n: int, f: int) -> str:
    """Which of K3's kernels (K3_ROUTES) scatters B graphs of E rows of F
    columns into N rows: the narrow kernel (rows of one or two columns of a
    graph that one block holds), scatter_small_kernel or the CSR build and
    the row sums. The rule is csrc/segment.cu's ``k3_route``. Builds the
    library."""
    return K3_ROUTES[_route(K3, b, e, n, f)]


# ---------------------------------------------------------------- K1

def segment_sum_sorted_plain(msgs: torch.Tensor, dst: torch.Tensor,
                             mask: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Plain version of K1: masked ``index_add_`` of msgs [B, E, F] into
    [B, N, F] f32 by the global row ``b * N + dst``."""
    b, e, f = msgs.shape
    flat = torch.where(mask[..., None], msgs.to(torch.float32), 0.0).reshape(b * e, f)
    rows = (dst.long() + num_nodes * torch.arange(b, device=dst.device)[:, None]).reshape(-1)
    out = torch.zeros(b * num_nodes, f, dtype=torch.float32, device=msgs.device)
    return out.index_add_(0, rows, flat).reshape(b, num_nodes, f)


def segment_sum_sorted(msgs: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                       num_nodes: int) -> torch.Tensor:
    """K1: sum the real edges' rows of msgs [B, E, F] (f32 or bf16) into their
    destination rows, -> [B, N, F] f32. dst [B, E] int32 is sorted ascending
    within each graph; mask [B, E] bool marks real edges.

    On the card a warp sums a few short rows at once and a row of many edges
    (the padding row N-1) goes to its whole block, which skips its masked
    edges a pass of 4096 at a time. Rows of one or two columns (``k1_route``)
    take the narrow kernel instead: a block per slice of a graph's rows keeps
    their real edges in edge order and a thread adds each row. Every row is
    summed in f32 in edge order, so the result equals the plain version's on
    the CPU bit for bit.

    Replaces caster_dta_tpu/ops/pallas_segment.py::_segment_kernel_t
    (via pallas_segment_sum). Bound by memory bytes on the H100."""
    if msgs.device.type == "cpu":
        return segment_sum_sorted_plain(msgs, dst, mask, num_nodes)
    if msgs.device.type != "cuda":
        raise ValueError(f"{K1}: unsupported device {msgs.device}")
    if msgs.dim() != 3 or dst.shape != msgs.shape[:2] or mask.shape != dst.shape:
        raise ValueError(f"{K1}: shapes msgs {tuple(msgs.shape)}, dst "
                         f"{tuple(dst.shape)}, mask {tuple(mask.shape)}")
    if msgs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{K1}: msgs must be float32 or bfloat16, not {msgs.dtype}")
    if dst.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError(f"{K1}: dst must be int32 and mask bool, got {dst.dtype}, {mask.dtype}")
    _check_cuda(K1, msgs, dst, mask)
    b, e, f = msgs.shape
    if b > 65535:
        raise ValueError(f"{K1}: {b} graphs exceed the grid's 65535")
    out = torch.empty(b, num_nodes, f, dtype=torch.float32, device=msgs.device)
    if out.numel() == 0:
        return out
    lib = load_library().lib
    with torch.cuda.device(msgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k1_segment_sum_sorted(
            msgs.data_ptr(), dst.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, e, num_nodes, f, int(msgs.dtype == torch.bfloat16), stream)
    _raise_on(err, K1)
    build.count_launch(LAUNCHES, BYTES, K1, msgs, dst, mask, out)
    NARROW_LAUNCHES[K1] += _route(K1, b, e, num_nodes, f) == 0
    return out


# ---------------------------------------------------------------- K2

def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: ``index_select`` of rows of table [B, N, F] by the
    global row ``b * N + idx`` -> [B, E, F]."""
    b, n, f = table.shape
    rows = (idx.long() + n * torch.arange(b, device=idx.device)[:, None]).reshape(-1)
    return table.reshape(b * n, f).index_select(0, rows).reshape(b, idx.shape[1], f)


def _vec_bytes(name: str, row_bytes: int, *ptrs: int) -> int:
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    raise ValueError(f"{name}: row of {row_bytes} bytes has no 2-byte alignment")


def gather_load_bytes(table: torch.Tensor) -> int:
    """The bytes of each of K2's loads from ``table`` [B, N, F]: the widest of
    16, 8, 4, 2 that divides a row's bytes and the table's address, and at
    least one element. K2's stores are 16 bytes whatever this is."""
    size = table.element_size()
    return next(v for v in (16, 8, 4, 2) if v == size or (
        v > size and (table.shape[2] * size) % v == 0 and table.data_ptr() % v == 0))


GATHER_KERNELS = ("vectors", "runs", "staged")


def gather_kernel(table: torch.Tensor) -> str:
    """Which of K2's kernels ``gather_rows`` runs for ``table`` [B, N, F] (one
    of GATHER_KERNELS): gather_rows_kernel (rows of 16-byte loads, or of one
    load), gather_staged_kernel (other rows, where a graph's table fits its
    shared memory) or gather_runs_kernel (the rest). Builds the library."""
    _, n, f = table.shape
    return GATHER_KERNELS[load_library().lib.k2_kernel(n, f, table.element_size(),
                                                       gather_load_bytes(table))]


def _check_gather(name: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    """The device, shape and dtype checks of K2 and K7 on a CUDA tensor."""
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
    if table.dim() != 3 or idx.dim() != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(f"{name}: shapes table {tuple(table.shape)}, idx {tuple(idx.shape)}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: table must be float32 or bfloat16, not {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, not {idx.dtype}")
    _check_cuda(name, table, idx)


def _check_index_on_cpu(name: str, idx: torch.Tensor, n: int) -> None:
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"{name}: index outside [0, {n})")


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K2: out[b, e, :] = table[b, idx[b, e], :]. table [B, N, F] float32 or
    bfloat16, idx [B, E] int32 in [0, N). An exact copy.

    An index outside [0, N) raises IndexError on the CPU and stops the kernel
    on the card, where the launch failure surfaces at the next
    synchronisation; no device returns a row for it.

    Replaces caster_dta_tpu/ops/pallas_segment.py::_onehot_gather_kernel
    (via onehot_gather). Bound by memory bytes on the H100."""
    if table.device.type == "cpu":
        _check_index_on_cpu(K2, idx, table.shape[1])
        return gather_rows_plain(table, idx)
    _check_gather(K2, table, idx)
    b, n, f = table.shape
    e = idx.shape[1]
    out = torch.empty(b, e, f, dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    if n == 0:
        raise ValueError(f"{K2}: gather from an empty table")
    load = gather_load_bytes(table)
    lib = load_library().lib
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k2_gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                 b, e, n, f, table.element_size(), load, stream)
    _raise_on(err, K2)
    build.count_launch(LAUNCHES, BYTES, K2, table, idx, out)
    return out


# ---------------------------------------------------------------- K3

def scatter_rows_plain(rows: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain version of K3: ``index_add_`` of every row of rows [B, E, F] into
    [B, N, F] f32 by the global row ``b * N + id``."""
    b, e, f = rows.shape
    flat = rows.to(torch.float32).reshape(b * e, f)
    gids = (ids.long() + num_segments * torch.arange(b, device=ids.device)[:, None]).reshape(-1)
    out = torch.zeros(b * num_segments, f, dtype=torch.float32, device=rows.device)
    return out.index_add_(0, gids, flat).reshape(b, num_segments, f)


def scatter_csr_plain(ids: torch.Tensor, num_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3's first launch: the stable CSR of ids [B, E] by id.
    -> (row_ptr [B, N+1], perm [B, E]), both int32: row n of graph b holds the
    edges perm[b, row_ptr[b, n]:row_ptr[b, n+1]], in edge order."""
    b, e = ids.shape
    gids = (ids.long() + num_segments * torch.arange(b, device=ids.device)[:, None]).reshape(-1)
    counts = torch.bincount(gids, minlength=b * num_segments).reshape(b, num_segments)
    row_ptr = torch.zeros(b, num_segments + 1, dtype=torch.int64, device=ids.device)
    row_ptr[:, 1:] = counts.cumsum(1)
    perm = torch.sort(ids, dim=1, stable=True).indices
    return row_ptr.to(torch.int32), perm.to(torch.int32)


def _check_ids(ids: torch.Tensor, *others: torch.Tensor) -> None:
    """The device, dtype and shape checks of K3's ids on a CUDA tensor."""
    if ids.device.type != "cuda":
        raise ValueError(f"{K3}: unsupported device {ids.device}")
    if ids.dim() != 2:
        raise ValueError(f"{K3}: ids must be [B, E], not {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"{K3}: ids must be int32, not {ids.dtype}")
    _check_cuda(K3, ids, *others)
    if ids.shape[0] > 65535:
        raise ValueError(f"{K3}: {ids.shape[0]} graphs exceed the grid's 65535")


def scatter_csr(ids: torch.Tensor, num_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's first launch alone: the stable CSR of ids [B, E] int32 in [0, N)
    by id -> (row_ptr [B, N+1], perm [B, E]) int32, equal to
    ``scatter_csr_plain``'s. It exists to hold the build against its plain
    version, so it does not count in ``LAUNCHES``; ``scatter_rows`` runs it
    itself. An id outside [0, N) raises IndexError on the CPU and stops the
    kernel on the card."""
    if ids.device.type == "cpu":
        _check_index_on_cpu(K3, ids, num_segments)
        return scatter_csr_plain(ids, num_segments)
    _check_ids(ids)
    b, e = ids.shape
    lib = load_library().lib
    ws = torch.empty(lib.k3_workspace_ints(b, e, num_segments), dtype=torch.int32,
                     device=ids.device)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k3_scatter_csr(ids.data_ptr(), ws.data_ptr(), b, e, num_segments, stream)
    _raise_on(err, K3)
    row_ptr = ws[:b * (num_segments + 1)].view(b, num_segments + 1)
    perm = ws[b * (num_segments + 1):b * (num_segments + 1 + e)].view(b, e)
    return row_ptr, perm


def scatter_rows(rows: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """K3: out[b, n, :] = sum of rows[b, e, :] over the edges e with
    ids[b, e] == n. rows [B, E, F] float32 or bfloat16, ids [B, E] int32 in
    [0, N) in any order, no mask (every row counts). The sum is taken in f32,
    in edge order; the output is [B, N, F] f32. Any N.

    On the card, rows of one or two columns (``k3_route``) take one launch
    of the narrow kernel: a block per slice of a graph's rows lays each row's
    values out in edge order and a thread adds each row (an edge whose
    values are all +-0 is left out: it would not move the sum's bits).
    Wider rows take one launch where a graph's rows, ids and CSR fit one
    block's shared memory (the molecule graphs), else two: the stable CSR of
    the ids (``scatter_csr``), then the row sums over it, a warp per row of
    at most ``K3_LONG`` ids and a block per longer row. Every row is summed
    in edge order, so the result equals the plain version's on the CPU bit
    for bit.

    An id outside [0, N) raises IndexError on the CPU and stops the kernel on
    the card, as K2 does.

    Replaces caster_dta_tpu/ops/pallas_segment.py::_scatter_fullN_kernel and
    ::_segment_kernel_dense (via unsorted_segment_sum_rows). Bound by memory
    bytes on the H100."""
    if rows.device.type == "cpu":
        _check_index_on_cpu(K3, ids, num_segments)
        return scatter_rows_plain(rows, ids, num_segments)
    if rows.device.type != "cuda":
        raise ValueError(f"{K3}: unsupported device {rows.device}")
    if rows.dim() != 3 or ids.shape != rows.shape[:2]:
        raise ValueError(f"{K3}: shapes rows {tuple(rows.shape)}, ids {tuple(ids.shape)}")
    if rows.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{K3}: rows must be float32 or bfloat16, not {rows.dtype}")
    _check_ids(ids, rows)
    b, e, f = rows.shape
    out = torch.empty(b, num_segments, f, dtype=torch.float32, device=rows.device)
    if out.numel() == 0:
        return out
    lib = load_library().lib
    narrow = _route(K3, b, e, num_segments, f) == 0
    # the narrow kernel needs no workspace
    ws = torch.empty(0 if narrow else lib.k3_workspace_ints(b, e, num_segments),
                     dtype=torch.int32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k3_scatter_rows(rows.data_ptr(), ids.data_ptr(), ws.data_ptr(),
                                  out.data_ptr(), b, e, num_segments, f,
                                  int(rows.dtype == torch.bfloat16), stream)
    _raise_on(err, K3)
    build.count_launch(LAUNCHES, BYTES, K3, rows, ids, out)
    NARROW_LAUNCHES[K3] += narrow
    return out


# ---------------------------------------------------------------- K7

# K7 computes K2's function: its plain version is K2's
gather_windowed_plain = gather_rows_plain


def gather_windowed(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K7: out[b, e, :] = table[b, idx[b, e], :], as K2, reading per chunk of
    edges only the table rows that the chunk's indices span. table [B, N, F]
    float32 or bfloat16 (a row of at most 32 KB), idx [B, E] int32 in [0, N),
    in any order (sorted indices read the least). An exact copy.

    An index outside [0, N) raises IndexError on the CPU and stops the kernel
    on the card, as K2's does. Dispatched on no path (ops/segment.py keeps K2).

    Replaces caster_dta_tpu/ops/pallas_segment.py::_gather_window_kernel
    (via gather_windowed). Bound by memory bytes on the H100."""
    if table.device.type == "cpu":
        _check_index_on_cpu(K7, idx, table.shape[1])
        return gather_windowed_plain(table, idx)
    _check_gather(K7, table, idx)
    b, n, f = table.shape
    e = idx.shape[1]
    if b > 65535:
        raise ValueError(f"{K7}: {b} graphs exceed the grid's 65535")
    row_bytes = f * table.element_size()
    if row_bytes > K7_WINDOW_BYTES:
        raise ValueError(f"{K7}: a row of {row_bytes} bytes exceeds the "
                         f"{K7_WINDOW_BYTES}-byte window (table {tuple(table.shape)})")
    out = torch.empty(b, e, f, dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    if n == 0:
        raise ValueError(f"{K7}: gather from an empty table")
    vec = _vec_bytes(K7, row_bytes, table.data_ptr(), out.data_ptr())
    lib = load_library().lib
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k7_gather_windowed(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                     b, e, n, row_bytes, vec, stream)
    _raise_on(err, K7)
    build.count_launch(LAUNCHES, BYTES, K7, table, idx, out)
    return out


# ---------------------------------------------------------------- K8

def segment_sum_2d_plain(msgs: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Plain version of K8: ``index_add_`` of every row of msgs [B, E, F] f32
    into [B, N, F] by the global row ``b * N + dst``."""
    return scatter_rows_plain(msgs, dst, num_nodes)


def segment_sum_2d(msgs: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """K8: out[b, n, :] = sum of msgs[b, e, :] over the edges e with
    dst[b, e] == n. msgs [B, E, F] float32 only, already masked (every row
    counts); dst [B, E] int32 in [0, N), sorted ascending within each graph.
    The sum is taken in f32 in edge order; the output is [B, N, F] f32, equal
    to the plain version's on the CPU and to K1's on the same masked rows bit
    for bit. The card runs K1's kernel with the mask switched off.

    Dispatched on no path (ops/segment.py keeps K1, which takes the mask).

    Replaces caster_dta_tpu/ops/pallas_segment.py::_segment_kernel (via
    _pallas_segment_sum_2d). Bound by memory bytes on the H100."""
    if msgs.dtype != torch.float32:
        raise TypeError(f"{K8}: msgs must be float32, not {msgs.dtype}")
    if msgs.device.type == "cpu":
        return segment_sum_2d_plain(msgs, dst, num_nodes)
    if msgs.device.type != "cuda":
        raise ValueError(f"{K8}: unsupported device {msgs.device}")
    if msgs.dim() != 3 or dst.shape != msgs.shape[:2]:
        raise ValueError(f"{K8}: shapes msgs {tuple(msgs.shape)}, dst {tuple(dst.shape)}")
    if dst.dtype != torch.int32:
        raise TypeError(f"{K8}: dst must be int32, not {dst.dtype}")
    _check_cuda(K8, msgs, dst)
    b, e, f = msgs.shape
    if b > 65535:
        raise ValueError(f"{K8}: {b} graphs exceed the grid's 65535")
    out = torch.empty(b, num_nodes, f, dtype=torch.float32, device=msgs.device)
    if out.numel() == 0:
        return out
    lib = load_library().lib
    with torch.cuda.device(msgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k8_segment_sum_2d(msgs.data_ptr(), dst.data_ptr(), out.data_ptr(),
                                    b, e, num_nodes, f, stream)
    _raise_on(err, K8)
    build.count_launch(LAUNCHES, BYTES, K8, msgs, dst, out)
    return out
