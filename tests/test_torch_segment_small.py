"""The tile kernels of K1 (sorted segment-sum, and K8 with every edge real)
and K3 (unsorted scatter-add) in caster_dta_torch/csrc/segment.cu, which
take a molecule-sized graph (at most 512 edges, 1,024 rows and 16,384
values), held on the CPU through their mirror (tests/segment_tile_mirror.py):
how a graph's columns and rows are split over blocks and threads, each row's
edges as bit masks a chunk of 32, and the order of adds. The mirror must give
the plain versions' bits (``scatter_rows_plain``, ``segment_sum_sorted_plain``,
``segment_sum_2d_plain``, each row summed in f32 in edge order) at the
molecule widths F = 16, 51 and 59 (and 28, the CLI's small protein graphs,
whose units do not split evenly over the column slices), f32 and bf16, at the flagship bucket
(B = 32), the explainer's evaluate batches (B = 8, 48 and 128 rows) and one
graph, and on edge cases; and it stays within 1e-5 of the JAX package's
segment sums on the molecule graph. The route mirror names the tile kernels
for molecule graphs and the other kernels for protein graphs. The card tests
(tests/test_torch_kernels.py) hold the compiled kernels to the same.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caster_dta_tpu.ops import pallas_segment
from caster_dta_tpu.ops import segment as jseg
from caster_dta_torch.data.batching import synthetic_pair_batch
import segment_narrow_mirror as routes
import segment_tile_mirror as mirror
from caster_dta_torch.ops import cuda_segment as cs

DTYPES = [torch.float32, torch.bfloat16]
WIDTHS = [16, 51, 59, 28]   # 28: the CLI's small protein graphs, 7 units over 4 slices
# (B, molecule rows): one graph, the explainer's evaluate batches, the flagship
GRAPHS = [(1, 64), (8, 48), (8, 128), (32, 64)]


def _molecules(b: int, n_m: int):
    return synthetic_pair_batch(b=b, n_p=64, e_p=256, n_m=n_m, e_m=256, seed=b + n_m).molecule


def _rows(shape, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=shape).astype(np.float32)
    rows[:, ::7] = np.where(rng.random(rows[:, ::7].shape) < 0.5, -0.0, 0.0)  # +-0 rows
    return torch.from_numpy(rows)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("b,n_m", GRAPHS)
def test_tile_mirrors_give_the_plain_bits_on_molecule_graphs(b, n_m, f, dtype):
    """K3 on the gathers' cotangents by src (unsorted) and by dst, K1 on the
    messages by dst with the mask, K8 (f32) with every edge real."""
    g = _molecules(b, n_m)
    n, e = g.n_pad, g.e_pad
    rows = _rows((b, e, f), f).to(dtype)
    for ids in (g.edge_src, g.edge_dst):
        assert routes.k3_route(b, e, n, f) == "tiles"
        assert torch.equal(mirror.scatter_tile(rows, ids, n), cs.scatter_rows_plain(rows, ids, n))
    assert routes.k1_route(b, e, n, f) == "tiles"
    assert torch.equal(mirror.segment_tile(rows, g.edge_dst, g.edge_mask, n),
                       cs.segment_sum_sorted_plain(rows, g.edge_dst, g.edge_mask, n))
    if dtype == torch.float32:
        assert torch.equal(mirror.segment_tile(rows, g.edge_dst, None, n),
                           cs.segment_sum_2d_plain(rows, g.edge_dst, n))


def _edge_case(case: str, f: int):
    """(rows [B, E, F] f32, ids [B, E] int32, N); sorted ids for K1."""
    rng = np.random.default_rng(11 + f)
    b, e, n = {"E=0": (2, 0, 9), "N=1": (3, 40, 1), "padding row": (2, 256, 48),
               "empty rows": (3, 300, 200), "E off the chunks": (2, 77, 31)}[case]
    if case == "padding row":
        ids = np.full((b, e), n - 1)
    elif case == "empty rows":   # the even rows below N/2 only
        ids = 2 * rng.integers(0, n // 4, (b, e))
    else:
        ids = rng.integers(0, n, (b, e))
    rows = _rows((b, e, f), 21 + f) if e else torch.zeros(b, 0, f)
    return rows, torch.from_numpy(ids.astype(np.int32)), n


EDGE_CASES = ["E=0", "N=1", "padding row", "empty rows", "E off the chunks"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [16, 51])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_tile_mirrors_on_edge_cases(case, f, dtype):
    """No edges, one row, every id on the padding row, empty rows (0, never
    -0), E not a multiple of 32; K1 with a random mask and, on the padding
    row case, every edge masked."""
    rows, ids, n = _edge_case(case, f)
    rows = rows.to(dtype)
    b, e = ids.shape
    got = mirror.scatter_tile(rows, ids, n)
    assert torch.equal(got, cs.scatter_rows_plain(rows, ids, n))
    counts = (torch.stack([torch.bincount(x.long(), minlength=n) for x in ids]) if e
              else torch.zeros(b, n, dtype=torch.long))
    assert torch.all(got[counts == 0] == 0) and not torch.signbit(got[got == 0]).any()
    dst = torch.sort(ids, dim=1).values.contiguous()
    mask = torch.from_numpy(np.random.default_rng(f).random((b, e)) < 0.7)
    if case == "padding row":
        mask[:] = False
    got = mirror.segment_tile(rows, dst, mask, n)
    assert torch.equal(got, cs.segment_sum_sorted_plain(rows, dst, mask, n))
    assert not torch.signbit(got[got == 0]).any()


def test_tile_staging_reads_inside_the_row():
    """Every column slice reads only its row's columns: where the units do
    not split evenly (F = 28: 7 units, slices of 2) the last slice's loads
    stay on its one unit instead of the next row's."""
    plan = mirror.tile_plan(128, 512, 64, 28, True)
    assert (plan["su"], plan["col_slices"]) == (2, 4)
    assert mirror.staged_columns(28, plan, True)[-1] == [24, 25, 26, 27]
    for f in (3, 12, 16, 20, 28, 51, 59, 128):
        for k3 in (False, True):
            plan = mirror.tile_plan(8, 256, 64, f, k3)
            for wide in {f % 4 == 0, False}:
                mirror.staged_columns(f, plan, wide)


def test_tile_plan_splits_the_columns_and_rows():
    """Units of 4 columns; at most 4 column slices; rows split where B x
    column slices leaves the card short of 128 blocks, in slices of at least
    16 (K3: of at most 32); threads enough for a thread a (row, unit) and for one round of 8
    loads a thread; every tile fits its shared memory at the largest
    molecule-sized graphs."""
    p = mirror.tile_plan(32, 256, 64, 16, False)     # flagship F=16
    assert (p["su"], p["col_slices"], p["row_slices"], p["threads"]) == (1, 4, 1, 128)
    p = mirror.tile_plan(32, 256, 64, 51, False)     # flagship F=51: 13 units, loads of one
    assert (p["su"], p["col_slices"], p["row_slices"], p["threads"]) == (4, 4, 1, 512)
    p = mirror.tile_plan(32, 256, 64, 16, True)      # K3: tiles of at most 32 rows
    assert (p["col_slices"], p["row_slices"], p["slice_rows"]) == (4, 2, 32)
    p = mirror.tile_plan(8, 256, 48, 16, False)      # evaluate batch, 48 rows
    assert (p["col_slices"], p["row_slices"], p["slice_rows"]) == (4, 3, 16)
    p = mirror.tile_plan(8, 256, 128, 51, True)      # evaluate batch, 128 rows
    assert (p["col_slices"], p["row_slices"], p["slice_rows"]) == (4, 4, 32)
    assert mirror.tile_plan(1, 64, 1024, 3, True)["slice_rows"] <= mirror.TILE_K3_ROWS
    for b, e, n, f in [(1, 512, 1024, 16), (1, 512, 1024, 3), (1, 16, 1024, 1024),
                       (64, 512, 1024, 32)]:
        for k3 in (False, True):
            assert mirror.tile_plan(b, e, n, f, k3)["bytes"] <= mirror.TILE_SMEM


@pytest.mark.parametrize("kernel,shape,want", [
    ("K3", (32, 256, 64, 16), "tiles"), ("K3", (8, 256, 128, 51), "tiles"),
    ("K3", (8, 256, 48, 3), "tiles"), ("K3", (32, 8192, 512, 28), "csr + sum"),
    ("K3", (32, 4096, 512, 3), "small"), ("K3", (2, 515, 130, 70), "small"),
    ("K3", (4, 1024, 128, 51), "small"), ("K3", (32, 256, 64, 2), "narrow"),
    ("K1", (32, 256, 64, 59), "tiles"), ("K1", (8, 256, 128, 16), "tiles"),
    ("K1", (32, 4096, 512, 28), "walk"), ("K1", (4, 1024, 128, 16), "walk"),
    ("K1", (32, 256, 64, 1), "narrow"),
])
def test_routes_send_molecule_graphs_to_the_tiles(kernel, shape, want):
    """Molecule graphs (and only graphs of at most 512 edges, 1,024 rows and
    16,384 values) take the tile kernels; protein graphs keep their routes."""
    rule = routes.k1_route if kernel == "K1" else routes.k3_route
    assert rule(*shape) == want


def test_tile_mirrors_match_jax_on_the_molecule_graph():
    """The mirrors against the JAX package at the flagship molecule graph:
    K1 against segment_sum (XLA), K3 against unsorted_segment_sum_rows (the
    TPU kernel in interpret mode), f32, within 1e-5 (sums in another order)."""
    g = _molecules(32, 64)
    n = g.n_pad
    rows = _rows((32, g.e_pad, 16), 3)
    want = np.asarray(jseg.segment_sum(jnp.asarray(rows.numpy()), jnp.asarray(g.edge_dst.numpy()),
                                       jnp.asarray(g.edge_mask.numpy()), n))
    np.testing.assert_allclose(mirror.segment_tile(rows, g.edge_dst, g.edge_mask, n).numpy(),
                               want, rtol=1e-5, atol=1e-5)
    want = np.asarray(pallas_segment.unsorted_segment_sum_rows(
        jnp.asarray(rows.numpy()), jnp.asarray(g.edge_src.numpy()), n))
    np.testing.assert_allclose(mirror.scatter_tile(rows, g.edge_src, n).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_k3_tile_mirror_refuses_an_id_outside_the_rows():
    with pytest.raises(IndexError):
        mirror.scatter_tile(torch.ones(1, 3, 16), torch.tensor([[0, 3, 9]], dtype=torch.int32), 9)
