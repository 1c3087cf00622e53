"""A CPU mirror of the tile kernels of caster_dta_torch/csrc/segment.cu
(``segment_tile_kernel`` for K1 and K8, ``scatter_tile_kernel`` for K3, on
a molecule-sized graph: at most 512 edges, 1,024 rows and 16,384 values).

The card's compiler is not here, so the tile kernels' work split and order
of adds are held on the CPU through this mirror. It splits the work as the
kernels do:

- ``tile_plan``: a unit is 4 columns (the last of a row may hold fewer); a
  graph's units split into at most 4 column slices, and its rows into row
  slices of at least 16 where B times the
  column slices falls short of 128 blocks; a block per (column slice, row
  slice, graph);
- K3: each edge whose id falls in the block's rows sets bit e % 32 of its
  row's word for chunk e // 32 (the chunk's warp stores a row's bits at once);
- K1: a row's edge range comes from the sorted dst (edge e starts the rows
  (dst[e - 1], dst[e]], the last edge ends the rows after it at E), and the
  real edges of chunk c are the bits of one ballot of the mask;
- a thread per (row, unit) walks its row's set bits, chunk by chunk and bit
  by bit, and adds each edge's values in f32 from +0.

Every step asserts what the kernels rely on (each row start written once,
the starts ascending, each output element written by exactly one thread),
and the sums are IEEE f32 adds in the walk's order (numpy float32), so a
mirror that equals the plain version bit for bit says the kernels' order
does. This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

# csrc/segment.cu's constants
TILE_EDGES = 512
SMALL_ROWS = 1024
SMALL_FLOATS = 16384
TILE_COL_SLICES = 4
TILE_BLOCKS = 128
TILE_MIN_ROWS = 16
TILE_MIN_THREADS = 128
TILE_K3_ROWS = 32
TILE_THREADS = 512
TILE_LOADS = 8
TILE_SMEM = 232448 - 1024


def tile_fits(e: int, n: int, f: int) -> bool:
    """csrc/segment.cu's walk_small_fits: the graph is molecule-sized."""
    return e <= TILE_EDGES and n <= SMALL_ROWS and e * f <= SMALL_FLOATS


def tile_plan(b: int, e: int, n: int, f: int, k3: bool, wide: bool | None = None) -> dict:
    """csrc/segment.cu's tile_plan; ``wide`` (default: F splits into units)
    stages a unit a load, else an element."""
    wide = f % 4 == 0 if wide is None else wide
    units = -(-f // 4)
    want = min(units, TILE_COL_SLICES)
    su = -(-units // want)
    col_slices = -(-units // su)
    per_graph = -(-TILE_BLOCKS // max(1, b * col_slices))
    row_slices = max(1, min(per_graph, n // TILE_MIN_ROWS))
    if k3:   # warp 0 scans a K3 tile's row counts
        row_slices = max(row_slices, -(-n // TILE_K3_ROWS))
    slice_rows = -(-n // row_slices)
    row_slices = -(-n // slice_rows) if n > 0 else 1
    lanes = slice_rows * su
    loads = e * su * (1 if wide else 4)
    threads = min(TILE_THREADS, max(TILE_MIN_THREADS, -(-max(lanes, -(-loads // TILE_LOADS)) // 32)
                                    * 32))
    nch = -(-e // 32)
    ints = 2 * nch * slice_rows + slice_rows + 1 if k3 else slice_rows + 1 + nch
    vals_at = -(-ints // 4) * 4
    return dict(su=su, col_slices=col_slices, row_slices=row_slices,
                slice_rows=slice_rows, threads=threads, nch=nch, vals_at=vals_at,
                bytes=(vals_at + (2 if k3 else 1) * e * su * 4) * 4)


def _walk(words: list) -> list:
    """The edges of a row's set bits, as the kernel walks them: chunk c in
    order, bit j low to high -> edge 32 c + j."""
    edges = []
    for c, w in words:
        while w:
            low = w & -w
            edges.append(32 * c + low.bit_length() - 1)
            w ^= low
    return edges


def _add_in_order(vals: np.ndarray, edges: list) -> np.ndarray:
    """A row's sums over every column at once (each column's adds are its
    own, so a column slice's are these)."""
    acc = np.zeros(vals.shape[1], np.float32)
    for e in edges:
        acc = acc + vals[e]
    return acc


def staged_columns(f: int, plan: dict, wide: bool) -> list:
    """The columns each column slice's block reads of a row, as the kernels
    stage them: a unit of 4 a load where ``wide`` (a slice's units past the
    row's last are read as its last unit's and not stored), else a column a
    load, those past F not read."""
    units, su = -(-f // 4), plan["su"]
    out = []
    for x in range(plan["col_slices"]):
        u0 = x * su
        nu = min(units - u0, su)
        if wide:
            cols = [4 * (u0 + min(u, nu - 1)) + c for u in range(su) for c in range(4)]
        else:
            cols = [c for c in range(4 * u0, 4 * (u0 + su)) if c < f]
        assert cols and max(cols) < f and min(cols) >= 0, (f, plan, x)   # inside the row
        out.append(sorted(set(cols)))
    return out


def _tiles(b: int, n: int, f: int, plan: dict):
    """(graph, r0, nr, the column slices) of every row slice of a graph: a
    block per column slice."""
    width = plan["su"] * 4
    cols = [slice(x * width, min(f, (x + 1) * width)) for x in range(plan["col_slices"])]
    assert cols[-1].stop == f and all(c.start < c.stop for c in cols)
    for wide in (f % 4 == 0, False):   # every read of a row lies inside it
        read = staged_columns(f, plan, wide)
        assert all(set(range(c.start, c.stop)) <= set(r) for c, r in zip(cols, read))
    for g in range(b):
        for y in range(plan["row_slices"]):
            r0 = y * plan["slice_rows"]
            yield g, r0, min(n - r0, plan["slice_rows"]), cols


def scatter_tile(rows: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """K3's tile kernel on the CPU: rows [B, E, F] f32 or bf16, ids [B, E] in
    [0, N) in any order -> [B, N, F] f32."""
    b, e, f = rows.shape
    assert tile_fits(e, n, f)
    plan = tile_plan(b, e, n, f, True)
    assert plan["bytes"] <= TILE_SMEM
    vals = rows.float().numpy()
    ids_np = ids.numpy().astype(np.int64)
    if e and (ids_np.min() < 0 or ids_np.max() >= n):
        raise IndexError("an id outside [0, N): the kernel traps")
    out = np.full((b, n, f), np.nan, np.float32)
    written = np.zeros((b, n, f), np.int64)
    for g, r0, nr, col_slices in _tiles(b, n, f, plan):
        masks = [[0] * nr for _ in range(plan["nch"])]      # [chunk][row]
        for edge in range(e):
            q = ids_np[g, edge] - r0
            if 0 <= q < nr:
                masks[edge >> 5][q] |= 1 << (edge & 31)
        for q in range(nr):
            acc = _add_in_order(vals[g], _walk([(c, masks[c][q]) for c in range(plan["nch"])]))
            for cols in col_slices:
                out[g, r0 + q, cols] = acc[cols]
                written[g, r0 + q, cols] += 1
    assert (written == 1).all()
    return torch.from_numpy(out)


def _row_starts(dst: np.ndarray, e: int, n: int, r0: int, nr: int) -> np.ndarray:
    """start[q] for q in [0, nr]: edge k writes the rows (dst[k - 1], dst[k]]
    of the tile (the last edge also (dst[E - 1], N] with E); E = 0 gives 0."""
    start = np.full(nr + 1, -1, np.int64)
    if e == 0:
        start[:] = 0
    for k in range(e):
        dp = dst[k - 1] if k > 0 else -1
        hi = n if k == e - 1 else min(dst[k], n)
        for r in range(max(dp + 1, r0), min(hi, r0 + nr) + 1):
            assert start[r - r0] == -1      # each start written once
            start[r - r0] = k if r <= dst[k] else e
    assert (start >= 0).all() and (np.diff(start) >= 0).all()
    return start


def segment_tile(msgs: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor | None,
                 n: int) -> torch.Tensor:
    """K1's tile kernel on the CPU (K8's where ``mask`` is None: every edge
    counts): msgs [B, E, F] f32 or bf16, dst [B, E] sorted per graph,
    mask [B, E] -> [B, N, F] f32."""
    b, e, f = msgs.shape
    assert tile_fits(e, n, f)
    plan = tile_plan(b, e, n, f, False)
    assert plan["bytes"] <= TILE_SMEM
    vals = msgs.float().numpy()
    dst_np = dst.numpy().astype(np.int64)
    real = np.ones((b, e), bool) if mask is None else mask.numpy()
    out = np.full((b, n, f), np.nan, np.float32)
    written = np.zeros((b, n, f), np.int64)
    for g, r0, nr, col_slices in _tiles(b, n, f, plan):
        # one ballot a chunk of 32 edges
        bits = np.zeros(plan["nch"] * 32, bool)
        bits[:e] = real[g]
        words = [int(np.packbits(chunk[::-1]).view(">u4")[0]) for chunk in bits.reshape(-1, 32)]
        start = _row_starts(dst_np[g], e, n, r0, nr)
        for q in range(nr):
            lo, hi = int(start[q]), int(start[q + 1])
            picked = []
            for c in range(lo >> 5, (hi + 31) >> 5):
                w = words[c]
                if c == lo >> 5:
                    w &= (0xFFFFFFFF << (lo & 31)) & 0xFFFFFFFF
                if c == hi >> 5:
                    w &= (1 << (hi & 31)) - 1
                picked.append((c, w))
            acc = _add_in_order(vals[g], _walk(picked))
            for cols in col_slices:
                out[g, r0 + q, cols] = acc[cols]
                written[g, r0 + q, cols] += 1
    assert (written == 1).all()
    return torch.from_numpy(out)
