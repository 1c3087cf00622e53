"""The narrow routes of K1 (sorted segment-sum) and K3 (unsorted scatter-add)
in caster_dta_torch/csrc/segment.cu, rows of one or two columns, held on the
CPU through their mirror (tests/segment_narrow_mirror.py): how the rows are
split over blocks, warps and lanes, each row's order of adds, and K3's
leaving out of edges whose values are all +-0. The mirror must give the
plain versions' bits (``scatter_rows_plain``, ``segment_sum_sorted_plain``,
each row summed in f32 in edge order) at F = 1 and 2 (the cut-off), f32 and
bf16, on the flagship protein graph with its padding row, the molecule
graph, and edge cases; and it stays within 1e-5 of the JAX package's
segment sums on the molecule graph. The route mirror names the kernel of
each shape that chip_smoke.py times. The card tests (tests/test_torch_kernels.py)
hold the compiled kernels and the compiled route rule to the same.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caster_dta_tpu.ops import pallas_segment
from caster_dta_tpu.ops import segment as jseg
from caster_dta_torch.data.batching import synthetic_pair_batch
import chip_smoke
import segment_narrow_mirror as mirror
from caster_dta_torch.ops import cuda_segment as cs

FLAGSHIP = dict(b=32, n_p=512, e_p=4096, n_m=64, e_m=256)
DTYPES = [torch.float32, torch.bfloat16]
WIDTHS = [1, 2]


def _graph(which: str):
    batch = synthetic_pair_batch(**FLAGSHIP, seed=0)
    return batch.protein if which == "protein" else batch.molecule


def _k3_case(case: str, f: int):
    """(rows [B, E, F] f32, ids [B, E] int32, N)."""
    rng = np.random.default_rng(7 + f)
    if case in ("protein dst", "protein src", "molecule dst"):
        g = _graph(case.split()[0])
        ids = (g.edge_src if case == "protein src" else g.edge_dst).to(torch.int32)
        n = g.n_pad
    elif case == "repeated ids":
        n = 40
        ids = torch.from_numpy(rng.integers(0, 5, (3, 700)).astype(np.int32))
    elif case == "one row":
        n = 9
        ids = torch.full((2, 4096), 4, dtype=torch.int32)
    elif case == "empty rows":
        n = 200   # ids on the even rows below N/2 only
        ids = torch.from_numpy(2 * rng.integers(0, 50, (3, 1000)).astype(np.int32))
    elif case == "unsorted ids":
        n = 512
        ids = torch.from_numpy(rng.permutation(np.arange(4096) % n).reshape(1, 4096)
                               .astype(np.int32))
    elif case == "E=0":
        n = 30
        ids = torch.zeros(2, 0, dtype=torch.int32)
    else:
        raise ValueError(case)
    rows = torch.from_numpy(rng.normal(size=(*ids.shape, f)).astype(np.float32))
    return rows, ids.contiguous(), n


K3_CASES = ["protein dst", "protein src", "molecule dst", "repeated ids", "one row",
            "empty rows", "unsorted ids", "E=0"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("case", K3_CASES)
def test_k3_narrow_mirror_gives_the_plain_bits(case, f, dtype):
    rows, ids, n = _k3_case(case, f)
    rows = rows.to(dtype)
    b, e = ids.shape
    assert mirror.k3_route(b, e, n, f) == "narrow"
    got = mirror.scatter_narrow(rows, ids, n)
    want = cs.scatter_rows_plain(rows, ids, n)
    assert got.shape == want.shape and torch.equal(got, want)
    counts = torch.stack([torch.bincount(g.long(), minlength=n) for g in ids]) if e else \
        torch.zeros(b, n, dtype=torch.long)
    assert torch.all(got[counts == 0] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("case", ["protein dst", "unsorted ids", "one row"])
def test_k3_narrow_mirror_skips_signed_zeros_with_the_same_bits(case, f, dtype):
    """K3 leaves out an edge whose values are all +-0: an in-order f32 sum
    from +0 is never -0, so the row keeps the plain version's bits, +0 for a
    row of zeros only (the padding row here)."""
    _, ids, n = _k3_case(case, f)
    rows = mirror.signed_zero_rows(ids, f).to(dtype)
    got = mirror.scatter_narrow(rows, ids, n)
    want = cs.scatter_rows_plain(rows, ids, n)
    assert torch.equal(got, want)
    assert not torch.signbit(got[got == 0]).any()   # no -0 anywhere


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", WIDTHS)
@pytest.mark.parametrize("graph", ["zoo", "zoo molecule"])
def test_k3_narrow_mirror_on_softmax_cotangents(graph, heads, dtype):
    """The rows K3 scatters in segment_softmax's backward (its two gathers
    by dst; chip_smoke.softmax_cotangent_cases on the CPU): +-0 on the
    masked edges, so the padding row keeps no edge."""
    batch = synthetic_pair_batch(**FLAGSHIP, seed=0)
    g = batch.protein if graph == "zoo" else batch.molecule
    cases = [c for c in chip_smoke.softmax_cotangent_cases(
        torch, batch, torch.Generator().manual_seed(2), dev="cpu")
        if c[0].startswith(f"{graph} backward F={heads},")]
    assert len(cases) == 2
    for _, rows, ids, n in cases:
        assert torch.all(rows[~g.edge_mask] == 0)
        rows = rows.to(dtype)
        assert torch.equal(mirror.scatter_narrow(rows, ids, n),
                           cs.scatter_rows_plain(rows, ids, n))


def _k1_case(case: str, f: int):
    """(msgs [B, E, F] f32, dst [B, E] int32 sorted, mask, N)."""
    rng = np.random.default_rng(3 + f)
    if case in ("protein", "molecule"):
        g = _graph(case)
        dst, mask, n = g.edge_dst.to(torch.int32), g.edge_mask, g.n_pad
    else:
        b, n, e = {"repeated ids": (3, 40, 700), "one row": (2, 9, 4096),
                   "empty rows": (3, 200, 1000), "E=0": (2, 30, 0)}[case]
        if case == "one row":
            d = np.full((b, e), 4)
        elif case == "empty rows":   # the even rows below N/2 only, then padding at N-1
            d = np.concatenate([np.sort(2 * rng.integers(0, 50, (b, e - 300)), axis=1),
                                np.full((b, 300), n - 1)], axis=1)
        else:
            d = np.sort(rng.integers(0, 5, (b, e)), axis=1)
        dst = torch.from_numpy(d.astype(np.int32))
        mask = torch.from_numpy(rng.random((b, e)) < 0.8)
        if case == "empty rows":
            mask[:, e - 300:] = False
    msgs = torch.from_numpy(rng.normal(size=(*dst.shape, f)).astype(np.float32))
    return msgs, dst.contiguous(), mask.contiguous(), n


K1_CASES = ["protein", "molecule", "repeated ids", "one row", "empty rows", "E=0"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("case", K1_CASES)
def test_k1_narrow_mirror_gives_the_plain_bits(case, f, dtype):
    msgs, dst, mask, n = _k1_case(case, f)
    msgs = msgs.to(dtype)
    b, e = dst.shape
    assert mirror.k1_route(b, e, n, f) == "narrow"
    got = mirror.segment_narrow(msgs, dst, mask, n)
    want = cs.segment_sum_sorted_plain(msgs, dst, mask, n)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("f", WIDTHS)
def test_k1_narrow_mirror_with_signed_zero_messages(f):
    """Messages of +-0.0 on real and masked edges: the sums keep the plain
    version's bits (a masked -0 adds nothing; a real one adds -0 to +0)."""
    msgs, dst, mask, n = _k1_case("protein", f)
    rng = np.random.default_rng(5)
    zeros = torch.from_numpy(np.where(rng.random(msgs.shape) < 0.5, -0.0, 0.0)
                             .astype(np.float32))
    msgs = torch.where(torch.from_numpy(rng.random(msgs.shape) < 0.3), zeros, msgs)
    assert torch.equal(mirror.segment_narrow(msgs, dst, mask, n),
                       cs.segment_sum_sorted_plain(msgs, dst, mask, n))


@pytest.mark.parametrize("f", WIDTHS)
def test_narrow_mirrors_match_jax_on_the_molecule_graph(f):
    """The mirrors against the JAX package at the molecule graph: K1 against
    segment_sum (XLA), K3 against unsorted_segment_sum_rows (the TPU kernel
    in interpret mode), f32, within 1e-5 (sums in another order)."""
    msgs, dst, mask, n = _k1_case("molecule", f)
    want = np.asarray(jseg.segment_sum(jnp.asarray(msgs.numpy()), jnp.asarray(dst.numpy()),
                                       jnp.asarray(mask.numpy()), n))
    np.testing.assert_allclose(mirror.segment_narrow(msgs, dst, mask, n).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    rows, ids, n = _k3_case("molecule dst", f)
    want = np.asarray(pallas_segment.unsorted_segment_sum_rows(
        jnp.asarray(rows.numpy()), jnp.asarray(ids.numpy()), n))
    np.testing.assert_allclose(mirror.scatter_narrow(rows, ids, n).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_k3_narrow_mirror_refuses_an_id_outside_the_rows():
    ids = torch.tensor([[0, 3, 9]], dtype=torch.int32)
    with pytest.raises(IndexError):
        mirror.scatter_narrow(torch.ones(1, 3, 1), ids, 9)


@pytest.mark.parametrize("kernel,shape,want", mirror.TIMED_ROUTES)
def test_routes_at_the_timed_shapes(kernel, shape, want):
    rule = mirror.k1_route if kernel == "K1" else mirror.k3_route
    assert rule(*shape) == want


@pytest.mark.parametrize("b,e,n", [(32, 4096, 512), (32, 256, 64), (1, 4096, 512),
                                   (3, 4096, 512), (128, 4096, 768), (2, 8192, 300)])
def test_narrow_plan_spreads_a_graph_and_fits(b, e, n):
    """Slices fill the card where the graphs leave SMs idle (at most 4 a
    graph, each of at least 64 rows); the warps hold the edges at 8 a thread
    at most; the values sit 16-byte aligned after the tables."""
    for k3 in (False, True):
        p = mirror.narrow_plan(b, e, n, 2, k3)
        assert mirror.narrow_fits(p, e)
        assert p["slices"] * p["slice_rows"] >= n > (p["slices"] - 1) * p["slice_rows"]
        assert p["slices"] == 1 or p["slice_rows"] >= mirror.NARROW_SLICE_ROWS
        assert p["warps"] * 32 * p["chunks"] >= e and p["chunks"] <= mirror.NARROW_IPT
        assert p["vals_at"] % 4 == 0
    assert mirror.narrow_plan(32, 4096, 512, 1, True)["slices"] == 4
    assert mirror.narrow_plan(32, 4096, 512, 1, True)["warps"] == 16
    assert mirror.narrow_plan(32, 256, 64, 1, True)["warps"] == 4
