"""The CUDA kernels K1 (sorted segment-sum), K2 (row gather), K3 (unsorted
scatter-add), K4 (blockwise masked attention), K5 (fused GVP message MLP,
forward and backward), K6 (copy-cast), K7 (windowed row gather) and K8
(row-major segment-sum) of caster_dta_torch against their plain PyTorch
versions (K1, K2 and K3 also at the model zoo's row widths, on the narrow
kernels of rows of one or two columns, whose route rule is held against its
CPU mirror, tests/segment_narrow_mirror.py, and on the tile kernels of
molecule-sized graphs, ``-k tile``, mirrored by tests/segment_tile_mirror.py), and
the autograd Functions built on them, segment_max and segment_softmax against
the same functions on the CPU, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one. This file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernels.py

(``-k k3`` selects K3's tests alone.)
"""
import os
import subprocess
import sys

import pytest
import torch

from caster_dta_torch.data.batching import synthetic_pair_batch
from caster_dta_torch.nn import gvp
from caster_dta_torch.ops import attention
from caster_dta_torch.ops import cuda_attention as ca
from caster_dta_torch.ops import cuda_gvp_message as cgm
from caster_dta_torch.ops import cuda_segment as cs
from caster_dta_torch.ops import segment
import segment_narrow_mirror as mirror

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _sorted_case(gen, b, n, e, f, dev, dtype=torch.float32):
    dst = torch.sort(torch.randint(0, n, (b, e), generator=gen, device=dev), dim=1).values
    mask = torch.rand(b, e, generator=gen, device=dev) < 0.85
    msgs = torch.randn(b, e, f, generator=gen, device=dev).to(dtype)
    return msgs, dst.to(torch.int32), mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,e,f", [(32, 512, 4096, 28), (32, 64, 256, 51), (3, 77, 1000, 5),
                                     (2, 40, 0, 9)])
def test_k1_matches_plain(cuda, dtype, b, n, e, f):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    msgs, dst, mask = _sorted_case(gen, b, n, e, f, cuda, dtype)
    before = cs.LAUNCHES[cs.K1]
    with torch.no_grad():
        got = cs.segment_sum_sorted(msgs, dst, mask, n)
        torch.cuda.synchronize()
    want = cs.segment_sum_sorted_plain(msgs, dst, mask, n)
    assert got.dtype == torch.float32
    # f32 sums of the same terms in edge order vs atomic order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert cs.LAUNCHES[cs.K1] == before + 1


def _aggregation(case, f=28, seed=12):
    """K1's inputs on the CPU: (msgs [B, E, F], dst, mask, N). The buckets'
    real dst and mask (synthetic_pair_batch, seed 0; padding edges at
    dst = N-1, masked), all edges of each graph on one row and real, or
    random sorted dst with one real edge in ten masked."""
    gen = torch.Generator().manual_seed(seed)
    if case in ("flagship protein", "flagship molecule", "large protein"):
        size = (dict(b=4, n_p=4608, e_p=65536, n_m=128, e_m=1024) if case == "large protein"
                else dict(b=32, n_p=512, e_p=4096, n_m=64, e_m=256))
        batch = synthetic_pair_batch(**size, seed=0)
        g = batch.molecule if case == "flagship molecule" else batch.protein
        dst, mask, n = g.edge_dst.to(torch.int32), g.edge_mask, g.n_pad
    elif case == "one row":
        dst = torch.full((2, 16384), 4, dtype=torch.int32)
        mask, n = torch.ones(2, 16384, dtype=torch.bool), 9
    else:
        b, n, e = {"E=0": (2, 40, 0), "N=1": (3, 1, 100), "E=1001": (3, 77, 1001)}[case]
        dst = torch.sort(torch.randint(0, n, (b, e), generator=gen), dim=1).values.to(torch.int32)
        mask = torch.rand(b, e, generator=gen) < 0.9
    msgs = torch.randn(*dst.shape, f, generator=gen)
    return msgs, dst.contiguous(), mask.contiguous(), n


K1_CASES = [("flagship protein", 28), ("flagship molecule", 51), ("flagship molecule", 16),
            ("large protein", 28), ("one row", 28), ("E=0", 9), ("N=1", 4), ("E=1001", 70)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,f", K1_CASES)
def test_k1_equals_the_cpu_bit_for_bit(cuda, dtype, case, f):
    """K1 sums every row in edge order in f32, as the plain version does on
    the CPU, so the two agree bit for bit: at the buckets' real dst and mask
    (the padding row N-1 holds ~700 masked edges a graph at the flagship,
    ~30,000 at the large protein), a row of 16,384 real edges, no edges, one
    row and an E off any alignment."""
    msgs, dst, mask, n = _aggregation(case, f)
    msgs = msgs.to(dtype)
    before = cs.LAUNCHES[cs.K1]
    got = cs.segment_sum_sorted(msgs.to(cuda), dst.to(cuda), mask.to(cuda), n).cpu()
    want = cs.segment_sum_sorted_plain(msgs, dst, mask, n)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, want)
    assert cs.LAUNCHES[cs.K1] == before + (1 if got.numel() else 0)


# the model zoo's row widths on a flagship protein graph: 1 (in-degrees), 2
# (segment_softmax's per-head max and denominators), 3 (one above the narrow
# kernels' cut-off), 21 (CPD's type one-hot, gathered by src), 2 x 16 and
# 2 x 64 (GATv2's per-head rows); the narrow widths and the one above also
# at B = 1 and 3 (its first graphs), and 1 and 2 on its molecule graph
ZOO_CARD_CASES = ([("protein", 32, f) for f in (1, 2, 3, 21, 32, 128)]
                  + [("protein", b, f) for b in (1, 3) for f in (1, 2, 3)]
                  + [("molecule", 32, f) for f in (1, 2)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("graph,b,f", ZOO_CARD_CASES)
def test_k1_k2_k3_at_the_zoo_widths(cuda, dtype, graph, b, f):
    """K1 and K3 bit for bit their plain versions on the CPU, K2 bit-exact,
    one launch a call each; rows of one or two columns on the narrow
    kernels (``k1_route``, ``k3_route``, as the CPU mirror names them)."""
    batch = synthetic_pair_batch(32, 512, 4096, 64, 256, seed=0)
    g = batch.protein if graph == "protein" else batch.molecule
    src, dst, mask = (t[:b].contiguous() for t in (g.edge_src, g.edge_dst, g.edge_mask))
    gen = torch.Generator().manual_seed(f)
    n, e = g.n_pad, g.e_pad
    table = torch.randn(b, n, f, generator=gen).to(dtype)
    idx = src if f == 21 else dst
    assert torch.equal(cs.gather_rows(table.to(cuda), idx.to(cuda)).cpu(),
                       cs.gather_rows_plain(table, idx))
    msgs = torch.randn(b, e, f, generator=gen).to(dtype)
    assert cs.k1_route(b, e, n, f) == mirror.k1_route(b, e, n, f)
    assert cs.k3_route(b, e, n, f) == mirror.k3_route(b, e, n, f)
    before = (cs.LAUNCHES[cs.K1], cs.LAUNCHES[cs.K3], dict(cs.NARROW_LAUNCHES))
    got = cs.segment_sum_sorted(msgs.to(cuda), dst.to(cuda), mask.to(cuda), n)
    assert torch.equal(got.cpu(), cs.segment_sum_sorted_plain(msgs, dst, mask, n))
    _k3_against_plain(msgs, dst, n, cuda)
    assert (cs.LAUNCHES[cs.K1], cs.LAUNCHES[cs.K3]) == (before[0] + 1, before[1] + 1)
    for k, route in ((cs.K1, cs.k1_route), (cs.K3, cs.k3_route)):
        narrow = route(b, e, n, f) == "narrow"
        assert narrow == (f <= 2)
        assert cs.NARROW_LAUNCHES[k] == before[2][k] + narrow


@pytest.mark.parametrize("kernel,shape,want", mirror.TIMED_ROUTES)
def test_narrow_route_rule_matches_its_mirror(cuda, kernel, shape, want):
    """The compiled route rules (k1_route, k3_route) name the kernel that the
    CPU mirror names at every shape chip_smoke.py times."""
    rule, mirrored = ((cs.k1_route, mirror.k1_route) if kernel == "K1"
                      else (cs.k3_route, mirror.k3_route))
    assert rule(*shape) == mirrored(*shape) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("graph,b,f", [("protein", 32, 1), ("protein", 32, 2),
                                       ("protein", 3, 2), ("molecule", 32, 1),
                                       ("molecule", 32, 2)])
def test_narrow_routes_give_the_same_bits_twice(cuda, dtype, graph, b, f):
    batch = synthetic_pair_batch(32, 512, 4096, 64, 256, seed=0)
    g = batch.protein if graph == "protein" else batch.molecule
    dst, mask = g.edge_dst[:b].contiguous().to(cuda), g.edge_mask[:b].contiguous().to(cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(12)
    msgs = torch.randn(b, g.e_pad, f, generator=gen, device=cuda).to(dtype)
    assert cs.k1_route(b, g.e_pad, g.n_pad, f) == cs.k3_route(b, g.e_pad, g.n_pad, f) == "narrow"
    first = cs.segment_sum_sorted(msgs, dst, mask, g.n_pad)
    assert torch.equal(first, cs.segment_sum_sorted(msgs, dst, mask, g.n_pad))
    first = cs.scatter_rows(msgs, dst, g.n_pad)
    assert torch.equal(first, cs.scatter_rows(msgs, dst, g.n_pad))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["unsorted ids", "one row", "empty rows", "E=0",
                                  "signed zeros"])
def test_k3_narrow_edge_cases(cuda, dtype, case):
    """The narrow K3 kernel bit for bit the CPU's plain version on unsorted
    ids, all ids on one row, empty rows (0), no ids, and rows of +-0 (left
    out: the sums keep their bits, never -0)."""
    gen = torch.Generator().manual_seed(13)
    b, e, n = {"one row": (2, 4096, 9), "empty rows": (3, 1000, 200), "E=0": (2, 0, 30)}.get(
        case, (2, 4096, 512))
    if case == "one row":
        ids = torch.full((b, e), 4, dtype=torch.int32)
    elif case == "empty rows":
        ids = (torch.randint(0, 50, (b, e), generator=gen) * 2).to(torch.int32)
    else:
        ids = torch.stack([torch.randperm(e, generator=gen) % n for _ in range(b)]).to(
            torch.int32) if e else torch.zeros(b, 0, dtype=torch.int32)
    for f in (1, 2):
        rows = (mirror.signed_zero_rows(ids, f) if case == "signed zeros"
                else torch.randn(b, e, f, generator=gen)).to(dtype)
        assert cs.k3_route(b, e, n, f) == "narrow"
        got, want = _k3_against_plain(rows, ids, n, cuda)
        counts = (torch.stack([torch.bincount(x.long(), minlength=n) for x in ids]) if e
                  else torch.zeros(b, n, dtype=torch.long))
        assert torch.all(got[counts == 0] == 0)
        assert not torch.signbit(got[got == 0]).any()


# the tile kernels' molecule graphs: (B, rows) of one graph, the explainer's
# evaluate batches and the flagship (tests/segment_tile_mirror.py on the CPU)
TILE_GRAPHS = [(1, 64), (8, 48), (8, 128), (32, 64)]


def _molecules(b, n_m):
    return synthetic_pair_batch(b=b, n_p=64, e_p=256, n_m=n_m, e_m=256, seed=b + n_m).molecule


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [16, 51, 59, 28])
@pytest.mark.parametrize("b,n_m", TILE_GRAPHS)
def test_tile_kernels_give_the_cpu_bits_on_molecule_graphs(cuda, b, n_m, f, dtype):
    """K3 (by src and by dst), K1 and K8 (f32) on the tile kernels
    (``k1_route``, ``k3_route`` name them), bit for bit their plain versions
    on the CPU, one launch a call; F=16 also from tensors off 16-byte
    alignment (a column a unit)."""
    g = _molecules(b, n_m)
    n, e = g.n_pad, g.e_pad
    assert cs.k1_route(b, e, n, f) == cs.k3_route(b, e, n, f) == "tiles"
    gen = torch.Generator(device=cuda)
    gen.manual_seed(f)
    storage = torch.randn(b * e * f + 1, generator=gen, device=cuda).to(dtype)
    views = [storage[:-1].view(b, e, f)] + ([storage[1:].view(b, e, f)] if f == 16 else [])
    src, dst, mask = (t.to(cuda) for t in (g.edge_src, g.edge_dst, g.edge_mask))
    for rows in views:
        cpu = rows.cpu()
        before = (cs.LAUNCHES[cs.K1], cs.LAUNCHES[cs.K3])
        for ids in (src, dst):
            got = cs.scatter_rows(rows, ids, n).cpu()
            assert torch.equal(got, cs.scatter_rows_plain(cpu, ids.cpu(), n))
        got = cs.segment_sum_sorted(rows, dst, mask, n).cpu()
        assert torch.equal(got, cs.segment_sum_sorted_plain(cpu, g.edge_dst, g.edge_mask, n))
        assert (cs.LAUNCHES[cs.K1], cs.LAUNCHES[cs.K3]) == (before[0] + 1, before[1] + 2)
        if dtype == torch.float32:
            got = cs.segment_sum_2d(rows, dst, n).cpu()
            assert torch.equal(got, cs.segment_sum_2d_plain(cpu, g.edge_dst, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["E=0", "N=1", "padding row", "empty rows", "signed zeros"])
def test_tile_kernels_edge_cases(cuda, dtype, case):
    """No edges, one row, every id on the padding row (K1: every edge masked),
    empty rows (0, never -0), rows of +-0: bit for bit the CPU's."""
    gen = torch.Generator().manual_seed(14)
    b, e, n = {"E=0": (2, 0, 9), "N=1": (3, 40, 1), "padding row": (2, 256, 48),
               "empty rows": (3, 300, 200)}.get(case, (2, 256, 64))
    if case == "padding row":
        ids = torch.full((b, e), n - 1, dtype=torch.int32)
    elif case == "empty rows":
        ids = (torch.randint(0, n // 4, (b, e), generator=gen) * 2).to(torch.int32)
    else:
        ids = torch.randint(0, n, (b, e), generator=gen, dtype=torch.int32)
    for f in (16, 51):
        assert cs.k3_route(b, e, n, f) == cs.k1_route(b, e, n, f) == "tiles"
        rows = (mirror.signed_zero_rows(ids, f) if case == "signed zeros"
                else torch.randn(b, e, f, generator=gen)).to(dtype)
        got, _ = _k3_against_plain(rows, ids, n, cuda)
        counts = (torch.stack([torch.bincount(x.long(), minlength=n) for x in ids]) if e
                  else torch.zeros(b, n, dtype=torch.long))
        assert torch.all(got[counts == 0] == 0) and not torch.signbit(got[got == 0]).any()
        dst = torch.sort(ids, dim=1).values.contiguous()
        mask = (torch.zeros(b, e, dtype=torch.bool) if case == "padding row"
                else torch.rand(b, e, generator=gen) < 0.7)
        got = cs.segment_sum_sorted(rows.to(cuda), dst.to(cuda), mask.to(cuda), n).cpu()
        assert torch.equal(got, cs.segment_sum_sorted_plain(rows, dst, mask, n))
        assert not torch.signbit(got[got == 0]).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_kernels_at_the_clis_small_protein_graphs(cuda, dtype):
    """The training CLI's synthetic proteins pad to 64 rows and 256 edges, 128
    graphs a batch: K1 at 28 columns (7 units over 4 column slices, the last
    of one unit) and K3 on the merged src||dst ids (512 edges) take the tile
    kernels; bit for bit the CPU's, and no read past a row (the last graph's
    last row ends the tensor)."""
    p = synthetic_pair_batch(128, 64, 256, 48, 256, seed=3).protein
    n, e = p.n_pad, p.e_pad
    merged = torch.cat([p.edge_src, p.edge_dst], 1).to(torch.int32).contiguous()
    assert cs.k1_route(128, e, n, 28) == cs.k3_route(128, 2 * e, n, 28) == "tiles"
    gen = torch.Generator().manual_seed(15)
    msgs = torch.randn(128, e, 28, generator=gen).to(dtype)
    got = cs.segment_sum_sorted(msgs.to(cuda), p.edge_dst.to(cuda), p.edge_mask.to(cuda), n)
    assert torch.equal(got.cpu(), cs.segment_sum_sorted_plain(msgs, p.edge_dst, p.edge_mask, n))
    rows = torch.randn(128, 2 * e, 28, generator=gen).to(dtype)
    _k3_against_plain(rows, merged, n, cuda)
    torch.cuda.synchronize()


def test_tile_and_small_k3_trap_on_an_id_out_of_range(cuda):
    """The tile kernel (a molecule-sized graph) and scatter_small_kernel
    (E = 600 ids over 3 columns: one block's shared memory, past the tile
    kernels' 512 edges) stop on an id outside [0, N)."""
    assert cs.k3_route(1, 4, 4, 3) == "tiles" and cs.k3_route(1, 600, 4, 3) == "small"
    _trap_in_child("cs.scatter_rows(t, i, 4)")
    _trap_in_child("cs.scatter_rows(t.repeat(1, 150, 1), i.repeat(1, 150), 4)")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_max_and_softmax_match_the_cpu(cuda, dtype):
    """segment_max (scatter_reduce) and segment_softmax (K1, K2; K3 in the
    backward) on the card against the CPU at a flagship protein graph, H = 2:
    values and gradients within 1e-5 in f32 (sums in another order), one
    bf16 ulp in bf16; segment_max's values exactly."""
    p = synthetic_pair_batch(32, 512, 4096, 64, 256, seed=0).protein
    gen = torch.Generator().manual_seed(5)
    logits = (torch.randn(32, p.e_pad, 2, generator=gen) * 3).to(dtype)
    weight = torch.randn(32, p.e_pad, 2, generator=gen)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2 ** -7,
                                                                          atol=2 ** -7)

    def run(dev):
        x = logits.to(dev).requires_grad_()
        args = (p.edge_dst.to(dev), p.edge_mask.to(dev), p.n_pad)
        m = segment.segment_max(x, *args)
        w = segment.segment_softmax(x, *args)
        loss = (w.float() * weight.to(dev)).sum() + m.float().sum()
        return [t.detach().cpu().float() for t in (m, w, *torch.autograd.grad(loss, x))]

    card, cpu = run(cuda), run("cpu")
    assert torch.equal(card[0], cpu[0])
    for got, want in zip(card[1:], cpu[1:]):
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_same_bits_twice(cuda, dtype):
    msgs, dst, mask, n = (t.to(cuda) if isinstance(t, torch.Tensor) else t
                          for t in _aggregation("large protein"))
    msgs = msgs.to(dtype)
    first = cs.segment_sum_sorted(msgs, dst, mask, n)
    assert torch.equal(first, cs.segment_sum_sorted(msgs, dst, mask, n))


# K2 at the served widths (28: 16-byte loads; 51 and 16), the zoo's (21,
# 59) and odd ones: rows whose bytes 16 does not divide take narrower loads,
# from a staged table where a graph's fits (N = 64, 77) or in runs of rows
# (N = 512, 300; E off the runs leaves a partial last run), and E off the
# staged blocks' 64 edges a partial block
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,e,f", [(32, 512, 8192, 28), (32, 64, 256, 51), (2, 9, 13, 1),
                                     (32, 512, 4096, 21), (128, 64, 256, 51), (32, 64, 256, 59),
                                     (3, 77, 1000, 3), (5, 40, 37, 2), (3, 300, 1003, 21)])
def test_k2_bit_exact(cuda, dtype, b, n, e, f):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    table = torch.randn(b, n, f, generator=gen, device=cuda).to(dtype)
    idx = torch.randint(0, n, (b, e), generator=gen, device=cuda, dtype=torch.int32)
    with torch.no_grad():
        got = cs.gather_rows(table, idx)
        torch.cuda.synchronize()
    assert torch.equal(got, cs.gather_rows_plain(table, idx))


# a table that starts off 16-byte alignment (one element into its storage):
# the loads narrow to what the address allows, the stores stay 16 bytes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [28, 21, 3, 64])
def test_k2_bit_exact_off_alignment(cuda, dtype, f):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    b, n, e = 4, 70, 333
    storage = torch.randn(b * n * f + 1, generator=gen, device=cuda).to(dtype)
    table = storage[1:].view(b, n, f)
    assert table.data_ptr() % 16 != 0 and cs.gather_load_bytes(table) < 16
    idx = torch.randint(0, n, (b, e), generator=gen, device=cuda, dtype=torch.int32)
    before = cs.LAUNCHES[cs.K2]
    got = cs.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert cs.LAUNCHES[cs.K2] == before + 1
    assert torch.equal(got, cs.gather_rows_plain(table, idx))


def test_k2_traps_on_an_index_out_of_range(cuda):
    _trap_in_child("cs.gather_rows(t, i)")
    with pytest.raises(IndexError, match="outside"):
        cs.gather_rows(torch.ones(1, 4, 3), torch.tensor([[0, 1, 5, 2]], dtype=torch.int32))


def test_kernels_refuse_what_they_do_not_take(cuda):
    table = torch.randn(2, 5, 3, device=cuda)
    idx = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        cs.gather_rows(table, idx.long())
    with pytest.raises(ValueError):
        cs.gather_rows(table.transpose(1, 2), idx)
    with pytest.raises(TypeError):
        cs.scatter_rows(table.double(), torch.zeros(2, 5, dtype=torch.int32, device=cuda), 5)
    with pytest.raises(ValueError):
        cs.scatter_rows(table, idx, 5)      # ids [2, 4] for rows [2, 5, 3]
    msgs = torch.randn(2, 4, 3, device=cuda)
    with pytest.raises(TypeError):
        cs.segment_sum_sorted(msgs.double(), idx, idx.bool(), 5)


def _k3_case(gen, b, e, n, f, dev, kind):
    """ids of one kind: uniform, all on one row, or only on the even rows
    below n // 2 (the odd and upper rows stay empty)."""
    if kind == "one row":
        ids = torch.full((b, e), n // 3, device=dev, dtype=torch.int32)
    elif kind == "empty rows":
        ids = torch.randint(0, max(n // 4, 1), (b, e), generator=gen, device=dev) * 2
    else:
        ids = torch.randint(0, n, (b, e), generator=gen, device=dev)
    rows = torch.randn(b, e, f, generator=gen, device=dev)
    return rows, ids.to(torch.int32).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,e,n,f,kind", [
    (32, 8192, 512, 28, "uniform"),     # flagship merged src||dst backward
    (32, 256, 64, 51, "uniform"),       # molecule gathers
    (32, 256, 64, 16, "uniform"),
    (3, 1000, 77, 5, "one row"),
    (2, 515, 130, 70, "empty rows"),     # F over one 64-column tile
    (2, 3000, 6000, 28, "uniform"),     # N above the JAX package's 4096 split
    (2, 0, 9, 4, "uniform"),
])
def test_k3_matches_plain(cuda, dtype, b, e, n, f, kind):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    rows, ids = _k3_case(gen, b, e, n, f, cuda, kind)
    rows = rows.to(dtype)
    before = cs.LAUNCHES[cs.K3]
    got = cs.scatter_rows(rows, ids, n).cpu()
    # the plain version on the CPU sums in edge order, as K3 does (on the
    # card index_add_ sums in atomic order, up to ~1e-4 off on a row of
    # ~1,000 terms)
    want = cs.scatter_rows_plain(rows.cpu(), ids.cpu(), n)
    assert got.dtype == torch.float32 and got.shape == (b, n, f)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.all(got[want.abs().sum(-1) == 0] == 0)
    assert cs.LAUNCHES[cs.K3] == before + (1 if b * n * f else 0)


def _merged_ids(bucket):
    """The merged src||dst ids of a bucket's protein graphs (seed 0), as the
    GVP convs' gather takes them: padding edges put their src on row 0 and
    their dst on row N-1."""
    size = (dict(b=32, n_p=512, e_p=4096, n_m=64, e_m=256) if bucket == "flagship" else
            dict(b=4, n_p=4608, e_p=65536, n_m=128, e_m=1024))
    p = synthetic_pair_batch(**size, seed=0).protein
    return torch.cat([p.edge_src, p.edge_dst], 1).to(torch.int32), p.n_pad


def _k3_against_plain(rows, ids, n, dev):
    """K3 on the card against its plain version on the CPU: within the card
    tolerance, and bit for bit, since every row is summed in edge order."""
    got = cs.scatter_rows(rows.to(dev), ids.to(dev), n).cpu()
    want = cs.scatter_rows_plain(rows, ids, n)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, want)
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bucket", ["flagship", "large protein"])
def test_k3_real_skewed_ids(cuda, dtype, bucket):
    ids, n = _merged_ids(bucket)
    counts = torch.stack([torch.bincount(g.long(), minlength=n) for g in ids])
    # the hot rows 0 and N-1: ~700 ids each (mean) at the flagship, ~30,000
    # at the large protein
    assert counts[:, 0].float().mean() > 500 and counts[:, -1].float().mean() > 500
    assert counts.max() > 10 * cs.K3_LONG
    gen = torch.Generator().manual_seed(5)
    rows = torch.randn(*ids.shape, 28, generator=gen).to(dtype)
    _k3_against_plain(rows, ids, n, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_hot_row_extreme(cuda, dtype):
    """All 16,384 ids of each graph on one row (over 100 x K3_LONG)."""
    ids = torch.full((2, 16384), 4, dtype=torch.int32)
    gen = torch.Generator().manual_seed(6)
    rows = torch.randn(2, 16384, 28, generator=gen).to(dtype)
    got, _ = _k3_against_plain(rows, ids, 9, cuda)
    assert torch.all(got[:, [0, 1, 2, 3, 5, 6, 7, 8]] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_same_bits_twice(cuda, dtype):
    ids, n = _merged_ids("flagship")
    gen = torch.Generator().manual_seed(7)
    rows = torch.randn(*ids.shape, 28, generator=gen).to(dtype).to(cuda)
    ids = ids.to(cuda)
    first = cs.scatter_rows(rows, ids, n)
    assert torch.equal(first, cs.scatter_rows(rows, ids, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_short_rows_exact(cuda, dtype):
    """Rows of at most K3_LONG ids (uniform ids, F over one 32-lane tile, and
    one row over K3_LONG) equal the plain version bit for bit."""
    gen = torch.Generator().manual_seed(8)
    ids = torch.randint(0, 300, (8, 4096), generator=gen, dtype=torch.int32)
    ids[:, :200] = 7
    rows = torch.randn(8, 4096, 51, generator=gen).to(dtype)
    got = cs.scatter_rows(rows.to(cuda), ids.to(cuda), 300).cpu()
    want = cs.scatter_rows_plain(rows, ids, 300)
    counts = torch.stack([torch.bincount(g.long(), minlength=300) for g in ids])
    short = counts <= cs.K3_LONG
    assert short.sum() > 0 and (~short).sum() > 0
    assert torch.equal(got[short], want[short])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_k3_empty_rows_zero(cuda):
    """Rows with no id come out exactly 0, beside a row that takes the long path."""
    gen = torch.Generator().manual_seed(9)
    ids = (torch.randint(0, 40, (3, 2000), generator=gen) * 2).to(torch.int32)
    ids[:, :500] = 10
    rows = torch.randn(3, 2000, 28, generator=gen)
    got, _ = _k3_against_plain(rows, ids, 170, cuda)
    empty = torch.stack([torch.bincount(g.long(), minlength=170) for g in ids]) == 0
    assert empty.sum() > 0 and torch.all(got[empty] == 0)


@pytest.mark.parametrize("case", ["flagship", "large protein", "N=6000", "E=0", "N=1",
                                  "N=70000"])
def test_k3_csr_matches_plain(cuda, case):
    """K3's first launch alone (scatter_csr): row_ptr and perm exactly equal
    to scatter_csr_plain's. N=70000 keeps the counts in global memory."""
    gen = torch.Generator().manual_seed(10)
    if case in ("flagship", "large protein"):
        ids, n = _merged_ids(case)
    else:
        b, e, n = {"N=6000": (2, 3000, 6000), "E=0": (2, 0, 9), "N=1": (3, 100, 1),
                   "N=70000": (2, 3000, 70000)}[case]
        ids = torch.randint(0, n, (b, e), generator=gen, dtype=torch.int32)
    before = cs.LAUNCHES[cs.K3]
    row_ptr, perm = cs.scatter_csr(ids.to(cuda), n)
    torch.cuda.synchronize()
    want_ptr, want_perm = cs.scatter_csr_plain(ids, n)
    assert torch.equal(row_ptr.cpu(), want_ptr) and torch.equal(perm.cpu(), want_perm)
    assert cs.LAUNCHES[cs.K3] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_counts_past_shared_memory(cuda, dtype):
    """N=70000 rows: the CSR build keeps its counts in global memory."""
    gen = torch.Generator().manual_seed(11)
    ids = torch.randint(0, 70000, (2, 3000), generator=gen, dtype=torch.int32)
    ids[:, :300] = 69999
    rows = torch.randn(2, 3000, 9, generator=gen).to(dtype)
    _k3_against_plain(rows, ids, 70000, cuda)


def _trap_in_child(call: str) -> None:
    """Run ``call`` on t [1, 4, 3] and the index 5 of i [[0, 1, 5, 2]] in a
    child process (a trap leaves the CUDA context unusable) and require the
    launch failure to surface."""
    script = ("import sys, torch\n"
              "from caster_dta_torch.ops import cuda_segment as cs\n"
              "t = torch.ones(1, 4, 3, device='cuda')\n"
              "i = torch.tensor([[0, 1, 5, 2]], dtype=torch.int32, device='cuda')\n"
              "try:\n"
              f"    {call}\n"
              "    torch.cuda.synchronize()\n"
              "except RuntimeError as e:\n"
              "    print('trapped:', e)\n"
              "    sys.exit(0)\n"
              "sys.exit(1)\n")
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "trapped" in r.stdout, r.stdout + r.stderr


def test_k3_traps_on_an_id_out_of_range(cuda):
    _trap_in_child("cs.scatter_rows(t, i, 4)")
    # the narrow kernel (rows of one column)
    _trap_in_child("cs.scatter_rows(t[..., :1].contiguous(), i, 4)")
    with pytest.raises(IndexError, match="outside"):
        cs.scatter_rows(torch.ones(1, 4, 3), torch.tensor([[0, 1, 5, 2]], dtype=torch.int32), 4)


# f32 gradients: the same sums in another order. bf16 gradients are rounded
# from f32 sums once, so they may differ by one bf16 ulp (2**-8 relative).
GRAD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_functions_match_the_cpu(cuda, dtype):
    """gather_nodes (K2, backward K3) and segment_sum (K1, backward K2) at
    the flagship shapes: card gradients against the CPU's."""
    gen = torch.Generator().manual_seed(3)
    b, n, e, f = 32, 512, 4096, 28
    dst = torch.sort(torch.randint(0, n - 1, (b, e), generator=gen), dim=1).values
    dst[:, -300:] = n - 1                       # padding edges, masked
    mask = torch.ones(b, e, dtype=torch.bool)
    mask[:, -300:] = False
    src = torch.randint(0, n, (b, e), generator=gen)
    idx = torch.cat([src, dst], dim=1).to(torch.int32)
    dst = dst.to(torch.int32)
    table = torch.randn(b, n, f, generator=gen).to(dtype)
    msgs = torch.randn(b, e, f, generator=gen).to(dtype)
    w_g = torch.randn(b, 2 * e, f, generator=gen)
    w_s = torch.randn(b, n, f, generator=gen)

    def grads(dev):
        t = table.to(dev).requires_grad_()
        m = msgs.to(dev).requires_grad_()
        out_g = segment.gather_nodes(t, idx.to(dev))
        out_s = segment.segment_sum(m, dst.to(dev), mask.to(dev), n)
        loss = (out_g.float() * w_g.to(dev)).sum() + (out_s.float() * w_s.to(dev)).sum()
        gt, gm = torch.autograd.grad(loss, (t, m))
        assert gt.dtype == dtype and gm.dtype == dtype
        return gt.cpu(), gm.cpu()

    before = dict(cs.LAUNCHES)
    g_card = grads(cuda)
    torch.cuda.synchronize()
    assert {k: cs.LAUNCHES[k] - before[k] for k in cs.LAUNCHES} == {cs.K1: 1, cs.K2: 2, cs.K3: 1,
                                                                    cs.K7: 0, cs.K8: 0}
    g_cpu = grads("cpu")
    for got, want in zip(g_card, g_cpu):
        torch.testing.assert_close(got.float(), want.float(), **GRAD_TOL[dtype])
    assert torch.all(g_card[1][:, -300:] == 0)  # masked edges get no gradient


# K5 against its plain version on the card. f32: the same products summed in
# another order (cuBLAS vs the kernel's fixed order), so outputs and input
# gradients within 1e-5 and the weight gradients, sums over every edge,
# within 2e-4 of their largest entry (as the JAX package's fused-vs-module
# test). bf16 (the compute dtype or the tensor's own): a sum that lands on
# another side of a bf16 rounding boundary moves that value by one bf16 ulp,
# and the layers after it carry that on, so each tensor within 2e-2 of its
# largest entry.
def _k5_close(got, want, cdt, what, weight=False):
    bf16 = torch.bfloat16 in (cdt, got.dtype)
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    if bf16:
        tol = 2e-2 * scale
    elif weight:
        tol = 2e-4 * scale
    else:
        tol = 1e-5 + 1e-5 * scale
    err = (got - want).abs().max().item() if got.numel() else 0.0
    assert err <= tol, f"{what}: max|d| {err:.3e} > {tol:.3e} (max|want| {scale:.3e})"


def _k5_case(dev, b, e, n_layers, acts, dtypes, seed=0, ns=16, nv=4, se=32, ve=1):
    """The served model's message MLP widths by default: node (16, 4), edge
    (32, 1), out (16, 4)."""
    g = torch.Generator().manual_seed(seed)
    conv = gvp.GVPConv((ns, nv), (ns, nv), (se, ve), n_layers=n_layers, activations=acts,
                       vector_gate=True, generator=g)
    weights = [w.detach().to(dev) for w in cgm.layer_weights(conv.message_func)]
    both = torch.randn(b, 2 * e, ns + 3 * nv, generator=g).to(dev, dtypes[0])
    es = torch.randn(b, e, se, generator=g).to(dev, dtypes[1])
    ev = torch.randn(b, e, 3 * ve, generator=g).to(dev, dtypes[2])
    dout = torch.randn(b, e, ns + 3 * nv, generator=g).to(dev, dtypes[0])
    return both, es, ev, weights, dout


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("b,e,n_layers,acts,dtypes,cdt", [
    (32, 4096, 3, ("relu", None), (F32, F32, F32), F32),      # flagship, f32 serving
    (32, 4096, 3, ("relu", None), (F32, F32, BF16), BF16),    # flagship, the bf16 step's inputs
    (128, 4096, 3, ("relu", None), (F32, F32, F32), F32),     # Davis bucket
    (3, 1000, 3, ("sigmoid", "sigmoid"), (F32, F32, F32), F32),  # E off the tiles
    (2, 77, 1, ("relu", None), (BF16, BF16, BF16), BF16),     # one layer, all bf16
    (2, 130, 2, ("relu", "sigmoid"), (BF16, F32, BF16), F32),  # bf16 inputs, f32 products
])
def test_k5_matches_plain(cuda, b, e, n_layers, acts, dtypes, cdt):
    both, es, ev, weights, dout = _k5_case(cuda, b, e, n_layers, acts, dtypes)
    spec = cgm.MessageSpec(16, 4, acts[0], acts[1], cdt)
    before = dict(cgm.LAUNCHES)
    out = cgm.message_fwd(both, es, ev, weights, spec)
    grads = cgm.message_bwd(both, es, ev, weights, dout, spec)
    torch.cuda.synchronize()
    assert {k: cgm.LAUNCHES[k] - before[k] for k in cgm.LAUNCHES} == {cgm.K5F: 1, cgm.K5B: 1,
                                                                     cgm.K6: 0}
    want_out = cgm.message_fwd_plain(both, es, ev, weights, spec)
    want = cgm.message_bwd_plain(both, es, ev, weights, dout, spec)
    assert out.dtype == both.dtype and out.shape == (b, e, 28)
    _k5_close(out, want_out, cdt, "out")
    for what, got, ref in zip(("d both", "d es", "d ev"), grads[:3], want[:3]):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        _k5_close(got, ref, cdt, what)
    for i, (got, ref) in enumerate(zip(grads[3], want[3])):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        _k5_close(got, ref, cdt, f"weight {i}", weight=True)


@pytest.mark.parametrize("cdt", [F32, BF16])
def test_k5_gives_the_same_bits_twice(cuda, cdt):
    both, es, ev, weights, dout = _k5_case(cuda, 32, 4096, 3, ("relu", None), (F32, F32, BF16))
    spec = cgm.MessageSpec(16, 4, "relu", None, cdt)
    runs = [(cgm.message_fwd(both, es, ev, weights, spec),
             cgm.message_bwd(both, es, ev, weights, dout, spec)) for _ in range(2)]
    (o1, g1), (o2, g2) = runs
    assert torch.equal(o1, o2)
    for a, b in zip(list(g1[:3]) + g1[3], list(g2[:3]) + g2[3]):
        assert torch.equal(a, b)


# K5 bwd's warp tiles (16 edges) and blocks (4 warps, at most 2 a SM): edge
# counts off both, and a grid over which each warp walks many tiles (Davis:
# 32,768 tiles against 1,056 resident warps on an H100).
@pytest.mark.parametrize("b,e", [(1, 1), (1, 15), (1, 17), (1, 33), (1, 16 * 37 + 7),
                                 (3, 16 * 85 + 7), (128, 4096)])
@pytest.mark.parametrize("dtypes,cdt", [((F32, F32, BF16), BF16), ((F32, F32, F32), F32)],
                         ids=["bf16 step", "f32"])
def test_k5_bwd_off_the_tiles(cuda, b, e, dtypes, cdt):
    both, es, ev, weights, dout = _k5_case(cuda, b, e, 3, ("relu", None), dtypes)
    spec = cgm.MessageSpec(16, 4, "relu", None, cdt)
    assert cgm.bwd_kernel(both, es, ev, weights, dout, spec) == (
        "warp tiles, bf16 step" if cdt == BF16 else "warp tiles, f32 served")
    before = cgm.LAUNCHES[cgm.K5B]
    got = cgm.message_bwd(both, es, ev, weights, dout, spec)
    torch.cuda.synchronize()
    assert cgm.LAUNCHES[cgm.K5B] == before + 1
    want = cgm.message_bwd_plain(both, es, ev, weights, dout, spec)
    for what, g, ref in zip(("d both", "d es", "d ev"), got[:3], want[:3]):
        assert g.dtype == ref.dtype and g.shape == ref.shape
        _k5_close(g, ref, cdt, what)
    for i, (g, ref) in enumerate(zip(got[3], want[3])):
        _k5_close(g, ref, cdt, f"weight {i}", weight=True)


# the warp-tile kernel's instance with activations and dtypes read at run
# time (the bf16 step with (relu, none) has its own)
@pytest.mark.parametrize("n_layers,acts", [(1, ("relu", "sigmoid")), (2, ("sigmoid", "sigmoid"))])
def test_k5_bwd_warp_tiles_other_depths(cuda, n_layers, acts):
    both, es, ev, weights, dout = _k5_case(cuda, 2, 16 * 9 + 5, n_layers, acts, (F32, F32, BF16))
    spec = cgm.MessageSpec(16, 4, acts[0], acts[1], BF16)
    assert cgm.bwd_kernel(both, es, ev, weights, dout, spec) == "warp tiles"
    runs = [cgm.message_bwd(both, es, ev, weights, dout, spec) for _ in range(2)]
    want = cgm.message_bwd_plain(both, es, ev, weights, dout, spec)
    for a, b in zip(list(runs[0][:3]) + runs[0][3], list(runs[1][:3]) + runs[1][3]):
        assert torch.equal(a, b)
    for i, (g, ref) in enumerate(zip(list(runs[0][:3]) + runs[0][3], list(want[:3]) + want[3])):
        _k5_close(g, ref, BF16, f"output {i}", weight=i >= 3)


# K5 bwd's f32 warp tiles (32 edges, a lane each): every input gradient is
# the block-tile kernel's FFMA chain, so d both, d es and d ev equal
# message_bwd_kernel's bits on the same inputs (reached through the test
# hook); the weight gradients sum in another order, within 2e-4 of the plain
# version's largest entry (chip_smoke.K5_TOL["weight"]), the same bits twice.
# The served instance at the flagship and Davis edges and off the tiles; the
# run-time instance for other activations, bf16 tensors and depths; five
# layers do not fit the input rows and stay on the block-tile kernel.
@pytest.mark.parametrize("b,e,n_layers,acts,dtypes,kernel", [
    (32, 4096, 3, ("relu", None), (F32, F32, F32), "warp tiles, f32 served"),
    (128, 4096, 3, ("relu", None), (F32, F32, F32), "warp tiles, f32 served"),
    (3, 32 * 9 + 5, 3, ("relu", None), (F32, F32, F32), "warp tiles, f32 served"),
    (3, 1000, 3, ("sigmoid", "sigmoid"), (F32, F32, F32), "warp tiles, f32"),
    (2, 130, 2, ("relu", "sigmoid"), (BF16, F32, BF16), "warp tiles, f32"),
    (5, 7, 1, ("relu", None), (F32, F32, F32), "warp tiles, f32 served"),
    (2, 77, 4, ("relu", None), (F32, F32, F32), "warp tiles, f32 served"),
    (2, 77, 5, ("relu", None), (F32, F32, F32), "block tiles"),
])
def test_k5_bwd_f32_warp_tiles_give_the_block_tiles_bits(cuda, b, e, n_layers, acts, dtypes,
                                                          kernel):
    both, es, ev, weights, dout = _k5_case(cuda, b, e, n_layers, acts, dtypes)
    spec = cgm.MessageSpec(16, 4, acts[0], acts[1], F32)
    assert cgm.bwd_kernel(both, es, ev, weights, dout, spec) == kernel
    before = cgm.LAUNCHES[cgm.K5B]
    runs = [cgm.message_bwd(both, es, ev, weights, dout, spec) for _ in range(2)]
    block = cgm._message_bwd_block_tiles(both, es, ev, weights, dout, spec)
    torch.cuda.synchronize()
    assert cgm.LAUNCHES[cgm.K5B] == before + 2
    for x, y in zip(list(runs[0][:3]) + runs[0][3], list(runs[1][:3]) + runs[1][3]):
        assert torch.equal(x, y)
    for what, x, y in zip(("d both", "d es", "d ev"), runs[0][:3], block[:3]):
        assert torch.equal(x, y), f"{what}: not the block-tile kernel's bits"
    want = cgm.message_bwd_plain(both, es, ev, weights, dout, spec)
    for i, (g, ref) in enumerate(zip(runs[0][3], want[3])):
        _k5_close(g, ref, F32, f"weight {i}", weight=True)


# K5 fwd's warp-tile kernels at the flagship and Davis protein edges, in the
# two kinds of chip_smoke.K5_DTYPES: f32 serving (the f32 kernel) and the
# bf16 step (mma.sync), each in its served instance; one launch a call and
# the same bits twice.
@pytest.mark.parametrize("b", [32, 128], ids=["flagship", "davis"])
@pytest.mark.parametrize("dtypes,cdt", [((F32, F32, F32), F32), ((F32, F32, BF16), BF16)],
                         ids=["f32", "bf16 step"])
def test_k5_fwd_warp_tiles_match_plain(cuda, b, dtypes, cdt):
    both, es, ev, weights, _ = _k5_case(cuda, b, 4096, 3, ("relu", None), dtypes)
    spec = cgm.MessageSpec(16, 4, "relu", None, cdt)
    assert cgm.fwd_kernel(both, es, ev, weights, spec) == "warp tiles, served"
    before = cgm.LAUNCHES[cgm.K5F]
    runs = [cgm.message_fwd(both, es, ev, weights, spec) for _ in range(2)]
    torch.cuda.synchronize()
    assert cgm.LAUNCHES[cgm.K5F] == before + 2
    assert torch.equal(runs[0], runs[1])
    want = cgm.message_fwd_plain(both, es, ev, weights, spec)
    assert runs[0].dtype == want.dtype and runs[0].shape == want.shape
    _k5_close(runs[0], want, cdt, "out")


# which kernel K5 fwd runs: the served instances, the warp-tile kernels'
# run-time instances for other activations and dtypes, and the block-tile
# kernel at widths without a warp-tile instance (each held to the plain version)
@pytest.mark.parametrize("widths,acts,dtypes,cdt,kernel", [
    ((16, 4, 32, 1), ("relu", None), (F32, F32, F32), F32, "warp tiles, served"),
    ((16, 4, 32, 1), ("relu", None), (F32, F32, BF16), BF16, "warp tiles, served"),
    ((16, 4, 32, 1), ("sigmoid", "sigmoid"), (F32, F32, F32), F32, "warp tiles"),
    ((16, 4, 32, 1), ("relu", None), (BF16, F32, BF16), F32, "warp tiles"),
    ((16, 4, 32, 1), ("relu", "sigmoid"), (BF16, BF16, BF16), BF16, "warp tiles"),
    ((8, 2, 16, 1), ("relu", None), (F32, F32, F32), F32, "block tiles"),
    ((8, 2, 16, 1), ("relu", None), (F32, F32, BF16), BF16, "block tiles"),
])
def test_k5_fwd_kernel_route(cuda, widths, acts, dtypes, cdt, kernel):
    ns, nv, se, ve = widths
    both, es, ev, weights, _ = _k5_case(cuda, 2, 300, 3, acts, dtypes, ns=ns, nv=nv, se=se, ve=ve)
    spec = cgm.MessageSpec(ns, nv, acts[0], acts[1], cdt)
    assert cgm.fwd_kernel(both, es, ev, weights, spec) == kernel
    out = cgm.message_fwd(both, es, ev, weights, spec)
    torch.cuda.synchronize()
    _k5_close(out, cgm.message_fwd_plain(both, es, ev, weights, spec), cdt, "out")


# K5 fwd's edge cases on its warp tiles: E off the tiles (16 and 32 edges),
# one layer, a handful of edges, tiles across graphs (E < 32)
@pytest.mark.parametrize("b,e,n_layers", [(3, 1000, 3), (2, 77, 1), (1, 1, 3), (5, 7, 3),
                                          (3, 16 * 85 + 7, 2)])
@pytest.mark.parametrize("dtypes,cdt", [((F32, F32, F32), F32), ((F32, F32, BF16), BF16)],
                         ids=["f32", "bf16 step"])
def test_k5_fwd_off_the_tiles(cuda, b, e, n_layers, dtypes, cdt):
    both, es, ev, weights, _ = _k5_case(cuda, b, e, n_layers, ("relu", None), dtypes)
    spec = cgm.MessageSpec(16, 4, "relu", None, cdt)
    assert cgm.fwd_kernel(both, es, ev, weights, spec) == "warp tiles, served"
    out = cgm.message_fwd(both, es, ev, weights, spec)
    torch.cuda.synchronize()
    _k5_close(out, cgm.message_fwd_plain(both, es, ev, weights, spec), cdt, "out")


# a fused conv whose edges are all masked: K5 fwd runs on every edge and the
# aggregation drops them all, so the conv's output is exactly 0
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k5_fwd_all_edges_masked(cuda, dtype):
    from caster_dta_torch.nn.common import compute_dtype
    g = torch.Generator().manual_seed(3)
    conv = gvp.GVPConv((16, 4), (16, 4), (32, 1), n_layers=3, aggr="sum",
                       activations=("relu", None), vector_gate=True, generator=g).to(cuda)
    b, n, e = 2, 40, 300
    x = (torch.randn(b, n, 16, generator=g).to(cuda), torch.randn(b, n, 4, 3, generator=g).to(cuda))
    ea = (torch.randn(b, e, 32, generator=g).to(cuda),
          torch.randn(b, e, 1, 3, generator=g).to(cuda))
    src = torch.randint(0, n, (b, e), generator=g).to(cuda, torch.int32)
    dst = torch.sort(torch.randint(0, n, (b, e), generator=g), dim=1).values.to(cuda, torch.int32)
    before = cgm.LAUNCHES[cgm.K5F]
    with torch.no_grad(), gvp.fused_message(), compute_dtype(dtype):
        out_s, out_v = conv(x, src, dst, torch.zeros(b, e, dtype=torch.bool, device=cuda), ea)
    torch.cuda.synchronize()
    assert cgm.LAUNCHES[cgm.K5F] == before + 1
    assert torch.all(out_s == 0) and torch.all(out_v == 0)


def test_k5_refuses_what_it_does_not_take(cuda):
    both, es, ev, weights, dout = _k5_case(cuda, 2, 64, 3, ("relu", None), (F32, F32, F32))
    spec = cgm.MessageSpec(16, 4, "relu", None, F32)
    with pytest.raises(TypeError):
        cgm.message_fwd(both.double(), es, ev, weights, spec)
    with pytest.raises(ValueError):
        cgm.message_fwd(both[:, :100].contiguous(), es, ev, weights, spec)
    with pytest.raises(ValueError):
        cgm.message_fwd(both, es, ev, weights[:-1], spec)
    with pytest.raises(ValueError):
        cgm.message_fwd(both, es, ev, weights, cgm.MessageSpec(16, 4, "gelu", None, F32))
    # widths whose tile needs more than 227 KB of shared memory
    big = _k5_case(cuda, 1, 8, 3, ("relu", None), (F32, F32, F32), ns=256, nv=64, se=8, ve=1)
    with pytest.raises(ValueError, match="shared memory"):
        cgm.message_bwd(*big[:4], big[4], cgm.MessageSpec(256, 64, "relu", None, F32))


@pytest.mark.parametrize("src,dst", [(F32, F32), (F32, BF16), (BF16, F32), (BF16, BF16)])
@pytest.mark.parametrize("shape", [(32, 512, 28), (3, 7, 5), (1, 1, 1)])
def test_k6_is_an_exact_cast(cuda, src, dst, shape):
    x = torch.randn(*shape, device=cuda).to(src)
    before = cgm.LAUNCHES[cgm.K6]
    y = cgm.cast_copy(x, dst)
    torch.cuda.synchronize()
    assert y.dtype == dst and y.data_ptr() != x.data_ptr()
    assert torch.equal(y, cgm.cast_copy_plain(x, dst))
    assert cgm.LAUNCHES[cgm.K6] == before + 1


# K6 moves 16-byte units (8 elements where it casts) and leaves the rest to
# one thread each; a slice from offset 1 is off 16-byte alignment and takes
# the element-wise loop.
@pytest.mark.parametrize("src,dst", [(F32, F32), (F32, BF16), (BF16, F32), (BF16, BF16)])
@pytest.mark.parametrize("n", [1, 7, 9, 4097, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1])
def test_k6_odd_lengths_and_a_misaligned_start(cuda, src, dst, n, offset):
    base = torch.randn(n + offset, device=cuda).to(src)
    x = base[offset:]
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (offset == 1)
    y = cgm.cast_copy(x, dst)
    assert torch.equal(y, cgm.cast_copy_plain(x, dst))
    assert torch.equal(y.cpu(), x.cpu().to(dst))


# K4 against its plain version on the card: the same f32 products summed in
# another order, one exp per key against a dense softmax: within 2e-5, the
# JAX tests' own tolerance.
K4_TOL = dict(rtol=2e-5, atol=2e-5)


def _k4_case(gen, b, h, lq, lk, hd, mask_kind, dev):
    q, k, v = (torch.randn(b, h, n, hd, generator=gen, device=dev) for n in (lq, lk, lk))
    if mask_kind is None:
        return q, k, v, None
    mask = torch.rand(b, lk, generator=gen, device=dev) < 0.3
    if mask_kind == "a fully masked graph":
        mask[0] = True
    elif mask_kind == "trailing":      # each graph's padding after its real keys
        n_real = torch.randint(1, lk + 1, (b, 1), generator=gen, device=dev)
        mask = torch.arange(lk, device=dev)[None, :] >= n_real
    return q, k, v, mask


@pytest.mark.parametrize("b,h,lq,lk,hd,mask_kind", [
    (32, 8, 512, 64, 16, "padding"),        # flagship residues -> atoms
    (32, 8, 64, 512, 16, "padding"),        # flagship atoms -> residues
    (4, 8, 128, 4608, 16, "padding"),       # large protein, atoms -> residues
    (4, 8, 4608, 128, 16, "padding"),       # large protein, residues -> atoms
    (128, 8, 768, 64, 16, "padding"),       # Davis residues -> atoms
    (128, 8, 64, 768, 16, "padding"),       # Davis atoms -> residues
    (2, 8, 67, 1000, 16, "padding"),        # Lq off the tiles, split blocks
    (6, 8, 67, 600, 16, "trailing"),        # padding keys last, as batched
    (3, 2, 200, 150, 5, "a fully masked graph"),
    (1, 2, 130, 33, 16, None),              # off any tile
    (2, 2, 7, 1, 16, "padding"),            # one key
    (2, 3, 50, 70, 8, "a fully masked graph"),
    (2, 3, 50, 70, 32, "padding"),
    (2, 2, 40, 300, 128, "padding"),        # the largest head dim
    (1, 1, 1, 1, 5, None),
])
def test_k4_matches_plain(cuda, b, h, lq, lk, hd, mask_kind):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    q, k, v, mask = _k4_case(gen, b, h, lq, lk, hd, mask_kind, cuda)
    before = ca.LAUNCHES[ca.K4]
    got = ca.masked_mha(q, k, v, mask)
    torch.cuda.synchronize()
    assert ca.LAUNCHES[ca.K4] == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, h, lq, hd)
    torch.testing.assert_close(got, ca.masked_mha_plain(q, k, v, mask), **K4_TOL)
    if mask_kind == "a fully masked graph":
        # uniform weights over every key: the mean of v
        torch.testing.assert_close(got[0], v[0].mean(dim=1, keepdim=True).expand_as(got[0]),
                                   **K4_TOL)


# K4's kernel and tiling at the served cross-attention shapes (graph-heads,
# Lq, Lk, hd): the row kernel's one instance (2 query rows a lane, 8 keys a
# step, 4 blocks an SM); where Lq is 64 or 128 the warps of a block split
# the keys, and where the grid leaves the card under one block an SM, blocks
# split them too (the large protein's 32 graph-heads).
@pytest.mark.parametrize("shape,want", [
    ((256, 512, 64, 16), ("rows", 2, 8, 4, 1, 1)),    # flagship residues -> atoms
    ((256, 64, 512, 16), ("rows", 2, 8, 4, 4, 1)),    # flagship atoms -> residues
    ((1024, 768, 64, 16), ("rows", 2, 8, 4, 1, 1)),   # Davis residues -> atoms
    ((1024, 64, 768, 16), ("rows", 2, 8, 4, 4, 1)),   # Davis atoms -> residues
    ((32, 4608, 128, 16), ("rows", 2, 8, 4, 1, 1)),   # large protein residues -> atoms
    ((32, 128, 4608, 16), ("rows", 2, 8, 4, 2, 8)),   # large protein atoms -> residues
    ((6, 50, 70, 8), ("rows", 2, 8, 4, 4, 1)),        # every hd up to 16
    ((8, 60, 90, 32), ("wide", 2, 2, 32)),            # wider heads: the first kernel
])
def test_k4_tiling_at_the_served_shapes(shape, want):
    assert ca.tiling(*shape) == want


def test_k4_takes_bf16_through_the_f32_cast(cuda):
    """ops.attention.masked_mha casts bf16 (and strided) inputs to contiguous
    f32, as the JAX masked_mha does, then launches K4."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    q, k, v, mask = _k4_case(gen, 4, 8, 96, 40, 16, "padding", cuda)
    q, k, v = (t.to(torch.bfloat16).transpose(1, 2).contiguous().transpose(1, 2)
               for t in (q, k, v))
    before = ca.LAUNCHES[ca.K4]
    with torch.no_grad():
        got = attention.masked_mha(q, k, v, mask)
    torch.cuda.synchronize()
    assert ca.LAUNCHES[ca.K4] == before + 1
    torch.testing.assert_close(got, ca.masked_mha_plain(q.float(), k.float(), v.float(), mask),
                               **K4_TOL)


def test_k4_gives_the_same_bits_twice(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6)
    for shape in ((32, 8, 512, 64, 16), (32, 8, 64, 512, 16), (4, 8, 128, 4608, 16),
                  (128, 8, 64, 768, 16), (2, 8, 67, 1000, 16)):
        q, k, v, mask = _k4_case(gen, *shape, "padding", cuda)
        assert torch.equal(ca.masked_mha(q, k, v, mask), ca.masked_mha(q, k, v, mask))


def test_k4_refuses_what_it_does_not_take(cuda):
    q = torch.randn(2, 2, 5, 16, device=cuda)
    mask = torch.zeros(2, 5, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        ca.masked_mha(q.to(torch.bfloat16), q, q, mask)
    with pytest.raises(ValueError):
        ca.masked_mha(q.transpose(2, 3).contiguous().transpose(2, 3), q, q, mask)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.randn(1, 1, 3, 129, device=cuda)
        ca.masked_mha(big, big, big)
    with pytest.raises(ValueError):
        ca.masked_mha(q, q, q, mask.int())
    with pytest.raises(ValueError, match="no keys"):
        ca.masked_mha(q, q[:, :, :0], q[:, :, :0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,e,f,order", [
    (32, 512, 4096, 28, "sorted"),      # flagship dst
    (32, 512, 4096, 28, "unsorted"),    # flagship src
    (32, 64, 256, 51, "unsorted"),
    (3, 5000, 700, 70, "sorted"),       # more rows than one window holds
    (2, 9, 13, 1, "unsorted"),
    (1, 3, 5, 8192, "unsorted"),        # a row of 32 KB in f32: one row a window
])
def test_k7_equals_k2(cuda, dtype, b, n, e, f, order):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    table = torch.randn(b, n, f, generator=gen, device=cuda).to(dtype)
    idx = torch.randint(0, n, (b, e), generator=gen, device=cuda, dtype=torch.int32)
    if order == "sorted":
        idx = torch.sort(idx, dim=1).values.contiguous()
    before = cs.LAUNCHES[cs.K7]
    got = cs.gather_windowed(table, idx)
    torch.cuda.synchronize()
    assert cs.LAUNCHES[cs.K7] == before + 1
    assert torch.equal(got, cs.gather_rows(table, idx))
    assert torch.equal(got, cs.gather_windowed_plain(table, idx))


def test_k7_refuses_what_it_does_not_take(cuda):
    table = torch.randn(2, 5, 3, device=cuda)
    idx = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        cs.gather_windowed(table, idx.long())
    with pytest.raises(TypeError):
        cs.gather_windowed(table.double(), idx)
    with pytest.raises(ValueError):
        cs.gather_windowed(table.transpose(1, 2), idx)
    with pytest.raises(ValueError, match="window"):
        cs.gather_windowed(torch.zeros(1, 2, 8193, device=cuda), idx[:1])


def test_k7_traps_on_an_index_out_of_range(cuda):
    _trap_in_child("cs.gather_windowed(t, i)")
    with pytest.raises(IndexError, match="outside"):
        cs.gather_windowed(torch.ones(1, 4, 3), torch.tensor([[0, 1, 5, 2]], dtype=torch.int32))


@pytest.mark.parametrize("b,n,e,f,kind", [
    (32, 512, 4096, 28, "random"), (32, 64, 256, 51, "random"), (3, 77, 1000, 5, "random"),
    (2, 130, 515, 70, "random"), (2, 40, 0, 9, "random"),
    (4, 4608, 65536, 28, "large protein"),  # the bucket's dst: ~30,000 zeroed edges on N-1
    (2, 9, 16384, 28, "one row"),           # every edge of a graph on one row
])
def test_k8_matches_plain(cuda, b, n, e, f, kind):
    """K8 against its plain version on the CPU (index_add_ in edge order, as
    K8 adds): within 1e-5 and bit for bit; and against K1 on the same masked
    rows bit for bit (both add in edge order; a zeroed row adds +0)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    if kind == "random":
        msgs, dst, mask = _sorted_case(gen, b, n, e, f, cuda)
    else:
        msgs, dst, mask, _ = (t.to(cuda) if isinstance(t, torch.Tensor) else t
                              for t in _aggregation(kind, f))
        assert msgs.shape == (b, e, f)
    masked = torch.where(mask[..., None], msgs, 0.0).contiguous()
    before = cs.LAUNCHES[cs.K8]
    got = cs.segment_sum_2d(masked, dst, n)
    torch.cuda.synchronize()
    assert cs.LAUNCHES[cs.K8] == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, n, f)
    want = cs.segment_sum_2d_plain(masked.cpu(), dst.cpu(), n)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, cs.segment_sum_sorted(msgs, dst, mask, n))


def test_k8_refuses_what_it_does_not_take(cuda):
    msgs = torch.randn(2, 4, 3, device=cuda)
    dst = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        cs.segment_sum_2d(msgs.to(torch.bfloat16), dst, 5)
    with pytest.raises(TypeError):
        cs.segment_sum_2d(msgs, dst.long(), 5)
    with pytest.raises(ValueError):
        cs.segment_sum_2d(msgs.transpose(0, 1), dst.t(), 5)
