"""A CPU mirror of the narrow kernels of caster_dta_torch/csrc/segment.cu
(``segment_narrow_kernel`` for K1 and ``scatter_narrow_kernel`` for K3, rows
of one or two columns) and of the route rules ``k1_route`` and ``k3_route``.

The card's compiler is not here, so the narrow kernels' order of adds is
held on the CPU through this mirror. It splits the work as the kernels do:

- a block per (graph, slice of ``slice_rows`` rows); ``narrow_plan`` gives
  the warps, chunks, slices and shared memory of a launch;
- warp w owns edges [w * chunks * 32, (w + 1) * chunks * 32), so within a
  warp the edges go in edge order by (chunk, lane);
- K3 keeps the edges of the slice whose F values are not all +-0, ranks each
  among its warp's kept edges of its row, turns the [rows][warps] counts
  into each warp's offset within the row and the rows' counts into their
  starts, and places each kept edge's values at start + offset + rank;
- K1 keeps the real edges of the slice, compacted in edge order, and a row
  starts where its first kept edge is (rows with none at the next one's);
- thread r adds row r's placed values in order, in f32.

Every step asserts what the kernel relies on (the places are a
permutation, the starts ascend), and the sums are IEEE f32 adds in that
order (numpy float32), so a mirror that equals the plain version bit for
bit says the kernels' order does. tests/test_torch_kernels.py holds the
route mirror against the compiled rule on the card. This module imports no
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

# csrc/segment.cu's constants
K1_NARROW_F = 2
K3_NARROW_F = 2
NARROW_IPT = 8
NARROW_EDGES = 32 * 32 * NARROW_IPT
NARROW_MIN_WARPS = 4
NARROW_SLICES = 4
NARROW_SLICE_ROWS = 64
NARROW_SMEM = 232448 - 1024
NARROW_TABLE = 33
K3_CSR_SMEM = 232448 - 1024
K3_SMALL_ROWS = 4096
K3_WALK = 64
SMALL_FLOATS = 16384
SMALL_EDGES = 512
SMALL_ROWS = 1024


def narrow_plan(b: int, e: int, n: int, f: int, k3: bool) -> dict:
    """csrc/segment.cu's narrow_plan: warps, chunks, slices, slice_rows,
    vals_at (4-byte words) and bytes of a narrow launch."""
    warps = min(32, max(NARROW_MIN_WARPS, -(-e // (32 * NARROW_IPT))))
    chunks = -(-e // (32 * warps))
    slices = max(1, min(NARROW_SLICES, 132 // max(b, 1), n // NARROW_SLICE_ROWS))
    slice_rows = -(-n // slices)
    ints = NARROW_TABLE * slice_rows + slice_rows + 1 if k3 else slice_rows + 1 + e
    vals_at = -(-ints // 4) * 4
    return dict(warps=warps, chunks=chunks, slices=slices, slice_rows=slice_rows,
                vals_at=vals_at, bytes=(vals_at + e * f) * 4)


def narrow_fits(plan: dict, e: int) -> bool:
    return e <= NARROW_EDGES and plan["chunks"] <= NARROW_IPT and plan["bytes"] <= NARROW_SMEM


def k3_small_bytes(e: int, n: int, f: int) -> int:
    walkers = min(32, max(1, -(-e // K3_WALK)))
    ints = e * f + 2 * e + walkers * n + n + 1
    return ints * 4 if n <= K3_SMALL_ROWS and ints * 4 <= K3_CSR_SMEM else 0


def walk_small_fits(e: int, n: int, f: int) -> bool:
    return e <= SMALL_EDGES and n <= SMALL_ROWS and e * f <= SMALL_FLOATS


def k1_route(b: int, e: int, n: int, f: int) -> str:
    """The name (cuda_segment.K1_ROUTES) of the kernel k1_route picks."""
    if 1 <= f <= K1_NARROW_F and narrow_fits(narrow_plan(b, e, n, f, False), e):
        return "narrow"
    return "small" if walk_small_fits(e, n, f) else "walk"


def k3_route(b: int, e: int, n: int, f: int) -> str:
    """The name (cuda_segment.K3_ROUTES) of the kernel k3_route picks."""
    if 1 <= f <= K3_NARROW_F and narrow_fits(narrow_plan(b, e, n, f, True), e):
        return "narrow"
    return "small" if k3_small_bytes(e, n, f) else "csr + sum"


def _row_sums(vals: np.ndarray, start: np.ndarray) -> np.ndarray:
    """Thread r's chain: acc[f] += vals[i, f] for i in [start[r], start[r+1])
    in order, in f32, from +0 -> [rows, F]."""
    nr = len(start) - 1
    lens = start[1:] - start[:-1]
    acc = np.zeros((nr, vals.shape[1]), np.float32)
    for i in range(int(lens.max()) if nr else 0):
        live = lens > i
        acc[live] = acc[live] + vals[start[:-1][live] + i]
    return acc


def _blocks(b: int, n: int, plan: dict):
    for g in range(b):
        for s in range(plan["slices"]):
            r0 = s * plan["slice_rows"]
            nr = min(n - r0, plan["slice_rows"])
            if nr > 0:
                yield g, r0, nr


def scatter_narrow(rows: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """K3's narrow kernel on the CPU: rows [B, E, F] f32 or bf16, ids [B, E]
    in [0, N) in any order -> [B, N, F] f32."""
    b, e, f = rows.shape
    plan = narrow_plan(b, e, n, f, True)
    assert narrow_fits(plan, e), plan
    vals_in = rows.float().numpy()
    ids_np = ids.numpy().astype(np.int64)
    if e and (ids_np.min() < 0 or ids_np.max() >= n):
        raise IndexError("an id outside [0, N): the kernel traps")
    warp_of = np.arange(e) // (plan["chunks"] * 32)
    out = np.zeros((b, n, f), np.float32)
    for g, r0, nr in _blocks(b, n, plan):
        q = ids_np[g] - r0
        nonzero = (vals_in[g] != 0).any(axis=1)        # +-0 everywhere: not kept
        kept = np.flatnonzero((q >= 0) & (q < nr) & nonzero)   # in edge order
        counts = np.zeros((nr, plan["warps"]), np.int64)      # [row][warp]
        rank = np.empty(len(kept), np.int64)
        for i, k in enumerate(kept):                  # warp by warp, chunk by chunk
            rank[i] = counts[q[k], warp_of[k]]
            counts[q[k], warp_of[k]] += 1
        offset = np.cumsum(counts, axis=1) - counts    # each warp's offset within its row
        start = np.zeros(nr + 1, np.int64)
        start[1:] = np.cumsum(counts.sum(axis=1))
        place = start[q[kept]] + offset[q[kept], warp_of[kept]] + rank
        assert np.array_equal(np.sort(place), np.arange(len(kept)))   # a permutation
        vals = np.empty((len(kept), f), np.float32)
        vals[place] = vals_in[g, kept]
        out[g, r0:r0 + nr] = _row_sums(vals, start)
    return torch.from_numpy(out)


def segment_narrow(msgs: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                   n: int) -> torch.Tensor:
    """K1's narrow kernel on the CPU: msgs [B, E, F] f32 or bf16, dst [B, E]
    sorted per graph, mask [B, E] -> [B, N, F] f32."""
    b, e, f = msgs.shape
    plan = narrow_plan(b, e, n, f, False)
    assert narrow_fits(plan, e), plan
    vals_in = msgs.float().numpy()
    dst_np, mask_np = dst.numpy().astype(np.int64), mask.numpy()
    out = np.zeros((b, n, f), np.float32)
    for g, r0, nr in _blocks(b, n, plan):
        q = dst_np[g] - r0
        kept = np.flatnonzero(mask_np[g] & (q >= 0) & (q < nr))   # ballots: edge order
        krow = q[kept]
        total = len(kept)
        start = np.full(nr + 1, -1, np.int64)
        for k in range(total):            # rows (previous kept edge's row, q] start at k
            start[(krow[k - 1] + 1 if k else 0):krow[k] + 1] = k
        start[(krow[-1] + 1 if total else 0):] = total
        assert (start >= 0).all() and (np.diff(start) >= 0).all() and start[-1] == total
        out[g, r0:r0 + nr] = _row_sums(vals_in[g, kept], start)
    return torch.from_numpy(out)


def signed_zero_rows(ids: torch.Tensor, f: int) -> torch.Tensor:
    """Rows of +-0.0 and N(0, 1) values: every third edge all +-0 (its sign
    by a coin), every fifth edge +-0 in its first column only, the padding
    row's edges all -0."""
    rng = np.random.default_rng(11)
    b, e = ids.shape
    rows = rng.normal(size=(b, e, f)).astype(np.float32)
    sign = np.where(rng.random((b, e, f)) < 0.5, -0.0, 0.0).astype(np.float32)
    rows[:, ::3] = sign[:, ::3]
    rows[:, ::5, 0] = sign[:, ::5, 0]
    rows[ids.numpy() == ids.max().item()] = -0.0
    return torch.from_numpy(rows)


# the route of each shape chip_smoke.py times (B, E, N, F): the zoo's widths
# 1 and 2 take the narrow kernels on the flagship protein graph (32, 4096,
# 512) and its molecule graph (32, 256, 64); wider rows keep their kernels
TIMED_ROUTES = [
    ("K1", (32, 4096, 512, 1), "narrow"), ("K1", (32, 4096, 512, 2), "narrow"),
    ("K1", (32, 4096, 512, 3), "walk"), ("K1", (32, 4096, 512, 28), "walk"),
    ("K1", (32, 4096, 512, 32), "walk"), ("K1", (32, 4096, 512, 128), "walk"),
    ("K1", (32, 256, 64, 1), "narrow"), ("K1", (32, 256, 64, 2), "narrow"),
    ("K1", (32, 256, 64, 3), "small"), ("K1", (32, 256, 64, 16), "small"),
    ("K1", (32, 256, 64, 51), "small"), ("K1", (32, 256, 64, 59), "small"),
    ("K1", (128, 4096, 768, 28), "walk"), ("K1", (128, 4096, 768, 1), "narrow"),
    ("K1", (4, 65536, 4608, 28), "walk"), ("K1", (4, 65536, 4608, 1), "walk"),
    ("K1", (1, 4096, 512, 1), "narrow"), ("K1", (3, 4096, 512, 2), "narrow"),
    ("K3", (32, 4096, 512, 1), "narrow"), ("K3", (32, 4096, 512, 2), "narrow"),
    ("K3", (32, 4096, 512, 3), "small"), ("K3", (32, 4096, 512, 32), "csr + sum"),
    ("K3", (32, 4096, 512, 128), "csr + sum"), ("K3", (32, 8192, 512, 28), "csr + sum"),
    ("K3", (32, 256, 64, 1), "narrow"), ("K3", (32, 256, 64, 2), "narrow"),
    ("K3", (32, 256, 64, 3), "small"), ("K3", (32, 256, 64, 16), "small"),
    ("K3", (32, 256, 64, 51), "small"), ("K3", (128, 8192, 768, 28), "csr + sum"),
    ("K3", (128, 4096, 768, 1), "narrow"), ("K3", (4, 131072, 4608, 28), "csr + sum"),
    ("K3", (4, 65536, 4608, 1), "csr + sum"), ("K3", (1, 4096, 512, 1), "narrow"),
    ("K3", (3, 4096, 512, 2), "narrow"), ("K3", (2, 0, 30, 1), "narrow"),
]
