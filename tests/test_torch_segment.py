"""Port parity: the segment ops and batch containers of caster_dta_torch
against caster_dta_tpu on the same numpy inputs.

On the CPU the port's K1 (sorted segment-sum), K2 (row gather), K3
(unsorted scatter-add), K7 (windowed gather) and K8 (row-major segment-sum)
wrappers take their plain PyTorch versions; they are held here against the
JAX package's XLA path and its Pallas kernels in interpret mode
(``segment.USE_PALLAS = True``, ``gather_windowed``,
``_pallas_segment_sum_2d``), forward and gradient. The
CUDA kernels themselves are held against these plain versions on the card
(tests/test_torch_kernels.py and chip_smoke.py). f32 sums in another order:
rtol/atol 1e-5; bf16 gradients rounded once from f32 sums taken in another
order: within one bf16 ulp (rtol/atol 2**-7).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from caster_dta_tpu.data import graphs as jgraphs
from caster_dta_tpu.ops import pallas_segment
from caster_dta_tpu.ops import segment as jseg
from caster_dta_torch.data import graphs as tgraphs
from caster_dta_torch.data.batching import synthetic_pair_batch
from caster_dta_torch.ops import cuda_segment
from caster_dta_torch.ops import segment as tseg

RTOL = ATOL = 1e-5


def _padded_case(rng, b, n, e_real, e_pad, f, empty_stride=1):
    """dst sorted per graph over every empty_stride-th row below n - 1 (the
    other rows get no edge), then padding edges at dst = N-1, masked; about
    one real edge in ten is masked as well."""
    rows = np.arange(0, n - 1, empty_stride)
    dst = np.sort(rng.choice(rows, size=(b, e_real)), axis=1)
    dst = np.concatenate([dst, np.full((b, e_pad - e_real), n - 1)], axis=1).astype(np.int32)
    mask = np.zeros((b, e_pad), bool)
    mask[:, :e_real] = rng.random((b, e_real)) < 0.9
    msgs = rng.normal(size=(b, e_pad, f)).astype(np.float32)
    return msgs, dst, mask


# the last three put most edges on the masked padding row N-1, as the
# buckets do (~700 of 4096 at the flagship, ~30,000 of 65,536 at the large
# protein): the row that K1's and K8's kernels hand to a whole block
CASES = [(2, 70, 150, 200, 12), (1, 300, 515, 515, 28), (3, 33, 40, 64, 5), (2, 16, 0, 8, 3),
         (2, 40, 50, 2000, 28), (1, 9, 100, 5000, 16), (3, 130, 400, 1001, 51)]


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("b,n,e_real,e_pad,f", CASES)
def test_segment_sum_matches_jax(rng, monkeypatch, pallas, b, n, e_real, e_pad, f):
    monkeypatch.setattr(jseg, "USE_PALLAS", pallas)
    msgs, dst, mask = _padded_case(rng, b, n, e_real, e_pad, f, empty_stride=3)
    want = np.asarray(jseg.segment_sum(jnp.asarray(msgs), jnp.asarray(dst), jnp.asarray(mask), n))
    got = tseg.segment_sum(torch.from_numpy(msgs), torch.from_numpy(dst),
                           torch.from_numpy(mask), n)
    assert got.dtype == torch.float32 and got.shape == (b, n, f)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # rows with no real edge, padding row N-1 included, come out exactly 0
    real = np.zeros((b, n), bool)
    for bi in range(b):
        real[bi, dst[bi][mask[bi]]] = True
    assert np.all(got.numpy()[~real] == 0)


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
def test_gather_nodes_matches_jax(rng, monkeypatch, pallas):
    monkeypatch.setattr(jseg, "USE_PALLAS", pallas)
    for (b, n, e, f) in [(2, 70, 130, 13), (1, 300, 515, 28), (3, 130, 64, 5)]:
        table = rng.normal(size=(b, n, f)).astype(np.float32)
        idx = rng.integers(0, n, (b, e)).astype(np.int32)
        want = np.asarray(jseg.gather_nodes(jnp.asarray(table), jnp.asarray(idx)))
        got = tseg.gather_nodes(torch.from_numpy(table), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), want)


def test_gather_nodes_trailing_dims(rng):
    """[B, N, nv, 3] tables gather as flattened rows."""
    table = rng.normal(size=(2, 9, 4, 3)).astype(np.float32)
    idx = rng.integers(0, 9, (2, 17)).astype(np.int32)
    want = np.asarray(jseg.gather_nodes(jnp.asarray(table), jnp.asarray(idx)))
    got = tseg.gather_nodes(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.shape == (2, 17, 4, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", [-1, 9], ids=["negative", "N"])
def test_gather_rows_rejects_out_of_range_index(bad):
    """An index outside [0, N) raises, also where the flattened rows of the
    plain version would reach into the next graph's table."""
    table = torch.zeros(2, 9, 4)
    idx = torch.zeros(2, 5, dtype=torch.int32)
    idx[0, 3] = bad
    with pytest.raises(IndexError, match="outside"):
        cuda_segment.gather_rows(table, idx)


@pytest.mark.parametrize("mode", ["sum", "add", "mean"])
def test_aggregate_matches_jax(rng, mode):
    msgs, dst, mask = _padded_case(rng, 3, 41, 90, 128, 6, empty_stride=2)
    msgs = msgs.reshape(3, 128, 2, 3)   # trailing dims, as the vector channels
    args = (dst, mask)
    want = np.asarray(jseg.aggregate(jnp.asarray(msgs), *map(jnp.asarray, args), 41, mode))
    got = tseg.aggregate(torch.from_numpy(msgs), *map(torch.from_numpy, args), 41, mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_segment_degree_matches_jax(rng):
    _, dst, mask = _padded_case(rng, 2, 50, 120, 160, 1)
    want = np.asarray(jseg.segment_degree(jnp.asarray(dst), jnp.asarray(mask), 50))
    got = tseg.segment_degree(torch.from_numpy(dst), torch.from_numpy(mask), 50)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_sum_casts_back_to_message_dtype(rng):
    msgs, dst, mask = _padded_case(rng, 2, 20, 30, 40, 4)
    t = torch.from_numpy(msgs).to(torch.bfloat16)
    got = tseg.segment_sum(t, torch.from_numpy(dst), torch.from_numpy(mask), 20)
    assert got.dtype == torch.bfloat16
    want = cuda_segment.segment_sum_sorted_plain(t, torch.from_numpy(dst),
                                                 torch.from_numpy(mask), 20)
    assert want.dtype == torch.float32
    assert torch.equal(got, want.to(torch.bfloat16))


def test_aggregate_max_not_ported(rng):
    """aggregate('max') is segment_max now (held against JAX in
    tests/test_torch_zoo_ops.py); an unknown mode raises."""
    msgs, dst, mask = _padded_case(rng, 1, 8, 6, 8, 2)
    args = tuple(map(torch.from_numpy, (msgs, dst, mask)))
    assert torch.equal(tseg.aggregate(*args, 8, "max"), tseg.segment_max(*args, 8))
    with pytest.raises(ValueError):
        tseg.aggregate(*args, 8, "min")


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for a CPU tensor; any other
    device goes to the kernel or raises (no fallback)."""
    t = torch.empty(2, 4, 3, device="meta")
    idx = torch.empty(2, 5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_segment.gather_rows(t, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_segment.segment_sum_sorted(t, idx[:, :4], idx[:, :4].bool(), 3)


def test_launch_counters_untouched_on_cpu(rng):
    cuda_segment.reset_launches()
    msgs, dst, mask = _padded_case(rng, 2, 20, 30, 40, 4)
    tseg.segment_sum(*map(torch.from_numpy, (msgs, dst, mask)), 20)
    tseg.gather_nodes(torch.from_numpy(msgs), torch.from_numpy(dst))
    cuda_segment.scatter_rows(torch.from_numpy(msgs), torch.from_numpy(dst), 20)
    cuda_segment.gather_windowed(torch.from_numpy(msgs), torch.from_numpy(dst))
    cuda_segment.segment_sum_2d(torch.from_numpy(msgs), torch.from_numpy(dst), 20)
    assert cuda_segment.LAUNCHES == {cuda_segment.K1: 0, cuda_segment.K2: 0, cuda_segment.K3: 0,
                                     cuda_segment.K7: 0, cuda_segment.K8: 0}


F32_TOL = dict(rtol=RTOL, atol=ATOL)
BF16_GRAD_TOL = 2 ** -7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,e_real,e_pad,f", [(2, 70, 150, 200, 12), (3, 33, 40, 64, 5),
                                                (1, 4200, 300, 320, 3)])
def test_segment_grads_match_jax(rng, monkeypatch, dtype, b, n, e_real, e_pad, f):
    """Gradients of gather_nodes (backward K3) and segment_sum (backward K2)
    against jax.grad with the JAX package's Pallas VJPs: empty rows, masked
    padding edges at N-1 and, in the last case, N above its 4096 split."""
    monkeypatch.setattr(jseg, "USE_PALLAS", True)
    msgs, dst, mask = _padded_case(rng, b, n, e_real, e_pad, f, empty_stride=3)
    table = rng.normal(size=(b, n, f)).astype(np.float32)
    src = rng.integers(0, n // 2, (b, e_pad)).astype(np.int32)   # the upper rows stay ungathered
    idx = np.concatenate([src, dst], axis=1)
    w_g = rng.normal(size=(b, 2 * e_pad, f)).astype(np.float32)
    w_s = rng.normal(size=(b, n, f)).astype(np.float32)

    def jax_loss(t, m):
        g = jseg.gather_nodes(t, jnp.asarray(idx))
        s = jseg.segment_sum(m, jnp.asarray(dst), jnp.asarray(mask), n)
        return (jnp.sum(g.astype(jnp.float32) * w_g)
                + jnp.sum(s.astype(jnp.float32) * w_s))

    jdt = jnp.dtype(dtype)
    want_t, want_m = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(table).astype(jdt),
                                                        jnp.asarray(msgs).astype(jdt))
    tdt = getattr(torch, dtype)
    t = torch.from_numpy(table).to(tdt).requires_grad_()
    m = torch.from_numpy(msgs).to(tdt).requires_grad_()
    g = tseg.gather_nodes(t, torch.from_numpy(idx))
    s = tseg.segment_sum(m, torch.from_numpy(dst), torch.from_numpy(mask), n)
    loss = (g.float() * torch.from_numpy(w_g)).sum() + (s.float() * torch.from_numpy(w_s)).sum()
    got_t, got_m = torch.autograd.grad(loss, (t, m))
    assert got_t.dtype == got_m.dtype == tdt
    tol = F32_TOL if dtype == "float32" else dict(rtol=BF16_GRAD_TOL, atol=BF16_GRAD_TOL)
    for got, want in ((got_t, want_t), (got_m, want_m)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   **tol)
    assert torch.all(got_m[torch.from_numpy(~mask)] == 0)       # masked edges
    gathered = np.zeros((b, n), bool)
    for bi in range(b):
        gathered[bi, idx[bi]] = True
    assert torch.all(got_t[torch.from_numpy(~gathered)] == 0)   # rows never gathered


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,e,n,f", [(2, 300, 70, 28), (3, 64, 9, 5), (1, 700, 300, 51)])
def test_scatter_rows_plain_matches_pallas(rng, dtype, b, e, n, f):
    """K3's plain version against the TPU kernels (unsorted_segment_sum_rows,
    interpret mode): unsorted ids, repeated ids, rows with no id."""
    rows = rng.normal(size=(b, e, f)).astype(np.float32)
    ids = rng.integers(0, max(n // 2, 1), (b, e)).astype(np.int32)
    ids[:, : e // 4] = 1                                     # one row takes many
    jrows = jnp.asarray(rows).astype(jnp.dtype(dtype))
    want = pallas_segment.unsorted_segment_sum_rows(jrows, jnp.asarray(ids), n)
    got = cuda_segment.scatter_rows(torch.from_numpy(rows).to(getattr(torch, dtype)),
                                    torch.from_numpy(ids), n)
    assert got.dtype == torch.float32 and got.shape == (b, n, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert torch.all(got[:, n // 2:] == 0)


@pytest.mark.parametrize("bad", [-1, 9], ids=["negative", "N"])
def test_scatter_rows_rejects_out_of_range_id(bad):
    rows = torch.zeros(2, 5, 4)
    ids = torch.zeros(2, 5, dtype=torch.int32)
    ids[1, 2] = bad
    with pytest.raises(IndexError, match="outside"):
        cuda_segment.scatter_rows(rows, ids, 9)


@pytest.mark.parametrize("b,e,n", [(3, 200, 17), (2, 0, 5), (2, 50, 1), (2, 3000, 6000),
                                   (1, 700, 300)])
def test_scatter_csr_plain_matches_numpy(rng, b, e, n):
    """K3's CSR (its first launch): row_ptr is the running count of each id
    and perm each graph's stable argsort of the ids. Covers E=0, N=1 and
    N=6000, and one row that takes a quarter of the ids."""
    ids = rng.integers(0, n, (b, e)).astype(np.int32)
    ids[:, : e // 4] = n // 2
    row_ptr, perm = cuda_segment.scatter_csr(torch.from_numpy(ids), n)
    assert row_ptr.dtype == perm.dtype == torch.int32
    assert row_ptr.shape == (b, n + 1) and perm.shape == (b, e)
    for g in range(b):
        want_ptr = np.concatenate([[0], np.cumsum(np.bincount(ids[g], minlength=n))])
        np.testing.assert_array_equal(row_ptr[g].numpy(), want_ptr)
        np.testing.assert_array_equal(perm[g].numpy(), np.argsort(ids[g], kind="stable"))


def _csr_range_sum(rows, row_ptr, perm):
    """Each row's CSR range summed in f32 in CSR order, as K3's second launch
    sums it (a warp per row of at most K3_LONG ids, a block per longer row:
    the same adds in the same order either way)."""
    b, e, f = rows.shape
    n = row_ptr.shape[1] - 1
    out = torch.zeros(b, n, f)
    for g in range(b):
        row_of = torch.repeat_interleave(torch.arange(n), (row_ptr[g, 1:] - row_ptr[g, :-1]).long())
        out[g].index_add_(0, row_of, rows[g].float()[perm[g].long()])
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["flagship", "large protein", "one row"])
def test_scatter_csr_range_sum_equals_plain(dtype, case):
    """The range-sum over the CSR equals K3's plain version bit for bit, on
    the merged src||dst ids that training gives K3 (padding puts ~700 ids on
    rows 0 and N-1 at the flagship, ~30,000 at the large protein) and with
    all ids of a graph on one row: rows of more than K3_LONG ids are summed
    in edge order too, not split (scripts/k3_split_sum_error.py: a split
    misses the 1e-5 tolerance there)."""
    if case == "one row":
        ids, n = torch.full((2, 16384), 4, dtype=torch.int32), 9
    else:
        size = (dict(b=32, n_p=512, e_p=4096, n_m=64, e_m=256) if case == "flagship" else
                dict(b=4, n_p=4608, e_p=65536, n_m=128, e_m=1024))
        p = synthetic_pair_batch(**size, seed=0).protein
        ids, n = torch.cat([p.edge_src, p.edge_dst], 1).to(torch.int32), p.n_pad
    gen = torch.Generator().manual_seed(4)
    rows = torch.randn(*ids.shape, 28, generator=gen).to(getattr(torch, dtype))
    row_ptr, perm = cuda_segment.scatter_csr(ids, n)
    counts = row_ptr[:, 1:] - row_ptr[:, :-1]
    assert int(counts.max()) > 100 * cuda_segment.K3_LONG or case == "flagship"
    got = _csr_range_sum(rows, row_ptr, perm)
    assert torch.equal(got, cuda_segment.scatter_rows_plain(rows, ids, n))


@pytest.mark.parametrize("bad", [-1, 9], ids=["negative", "N"])
def test_scatter_csr_rejects_out_of_range_id(bad):
    ids = torch.zeros(2, 5, dtype=torch.int32)
    ids[0, 4] = bad
    with pytest.raises(IndexError, match="outside"):
        cuda_segment.scatter_csr(ids, 9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("b,n,e,f", [(3, 96, 200, 12), (2, 300, 515, 28)])
def test_gather_windowed_plain_matches_pallas(rng, dtype, order, b, n, e, f):
    """K7's plain version against the TPU kernel (gather_windowed, interpret
    mode), bit for bit: sorted indices (dst), unsorted ones (src), and a
    table over two of its 128-row windows."""
    table = rng.normal(size=(b, n, f)).astype(np.float32)
    idx = rng.integers(0, n, (b, e)).astype(np.int32)
    if order == "sorted":
        idx = np.sort(idx, axis=1)
    jt = jnp.asarray(table).astype(jnp.dtype(dtype))
    want = np.asarray(pallas_segment.gather_windowed(jt, jnp.asarray(idx)).astype(jnp.float32))
    got = cuda_segment.gather_windowed(torch.from_numpy(table).to(getattr(torch, dtype)),
                                       torch.from_numpy(idx))
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, e, f)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("bad", [-1, 9], ids=["negative", "N"])
def test_gather_windowed_rejects_out_of_range_index(bad):
    table = torch.zeros(2, 9, 4)
    idx = torch.zeros(2, 5, dtype=torch.int32)
    idx[1, 4] = bad
    with pytest.raises(IndexError, match="outside"):
        cuda_segment.gather_windowed(table, idx)


@pytest.mark.parametrize("b,n,e_real,e_pad,f", [(2, 70, 150, 200, 12), (1, 300, 515, 600, 28),
                                                (2, 16, 0, 8, 3), (2, 40, 50, 2000, 28),
                                                (1, 9, 100, 5000, 16)])
def test_segment_sum_2d_plain_matches_pallas(rng, b, n, e_real, e_pad, f):
    """K8's plain version against the TPU kernel (_pallas_segment_sum_2d,
    interpret mode) on masked messages: empty rows, padding edges at N-1
    (zero messages), a row's edges across the kernel's 512-edge chunks.
    f32 sums in another order: rtol/atol 1e-5."""
    msgs, dst, mask = _padded_case(rng, b, n, e_real, e_pad, f, empty_stride=3)
    msgs = np.where(mask[..., None], msgs, 0).astype(np.float32)
    want = np.asarray(pallas_segment._pallas_segment_sum_2d(jnp.asarray(msgs),
                                                             jnp.asarray(dst), n))
    got = cuda_segment.segment_sum_2d(torch.from_numpy(msgs), torch.from_numpy(dst), n)
    assert got.dtype == torch.float32 and got.shape == (b, n, f)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the same sums as K1's plain version over the unmasked messages
    k1 = cuda_segment.segment_sum_sorted_plain(torch.from_numpy(msgs), torch.from_numpy(dst),
                                               torch.from_numpy(mask), n)
    assert torch.equal(got, k1)


def test_segment_sum_2d_takes_f32_only():
    msgs = torch.zeros(1, 4, 3, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        cuda_segment.segment_sum_2d(msgs, torch.zeros(1, 4, dtype=torch.int32), 2)


def _raw_graph(rng, n, e, nv):
    return dict(
        node_s=rng.normal(size=(n, 5)).astype(np.float32),
        node_v=rng.normal(size=(n, nv, 3)).astype(np.float32) if nv else None,
        edge_index=rng.integers(0, n, size=(2, e)),
        edge_s=rng.normal(size=(e, 3)).astype(np.float32),
        edge_v=rng.normal(size=(e, 1, 3)).astype(np.float32) if nv else None,
        node_type=rng.integers(0, 4, n), edge_type=rng.integers(0, 2, e))


def test_pad_and_stack_match_jax(rng):
    """Same graphs give the same arrays: (dst, src) sort order, padding edges
    at N-1 and masked, zero-width vector channels."""
    for nv in (2, 0):
        raws = [_raw_graph(rng, n, e, nv) for n, e in [(7, 15), (10, 30), (3, 0)]]
        jb = jgraphs.stack_graphs([jgraphs.pad_graph(**r, n_pad=12, e_pad=32) for r in raws])
        tb = tgraphs.stack_graphs([tgraphs.pad_graph(**r, n_pad=12, e_pad=32) for r in raws])
        for name in ("node_s", "node_v", "node_type", "node_mask", "edge_src", "edge_dst",
                     "edge_s", "edge_v", "edge_type", "edge_mask"):
            want = np.asarray(getattr(jb, name))
            got = getattr(tb, name).numpy()
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(tb.n_node.numpy(), np.asarray(jb.n_node))
        np.testing.assert_array_equal(tb.n_edge.numpy(), np.asarray(jb.n_edge))
        assert np.all(np.diff(tb.edge_dst.numpy(), axis=1) >= 0)


def test_pad_graph_rejects_oversized(rng):
    raw = _raw_graph(rng, 7, 15, 1)
    with pytest.raises(ValueError, match="nodes"):
        tgraphs.pad_graph(**raw, n_pad=6, e_pad=32)
    with pytest.raises(ValueError, match="edges"):
        tgraphs.pad_graph(**raw, n_pad=8, e_pad=14)


def test_synthetic_batch_matches_graft_entry():
    """One seed gives the same pair batch in both packages."""
    want = graft._synthetic_batch(3, 24, 200, 10, 40, seed=5)
    got = synthetic_pair_batch(3, 24, 200, 10, 40, seed=5)
    for side in ("protein", "molecule"):
        for name in ("node_s", "node_v", "node_type", "node_mask", "edge_src", "edge_dst",
                     "edge_s", "edge_v", "edge_type", "edge_mask"):
            np.testing.assert_array_equal(getattr(getattr(got, side), name).numpy(),
                                          np.asarray(getattr(getattr(want, side), name)))
    np.testing.assert_array_equal(got.target.numpy(), want.target)
    np.testing.assert_array_equal(got.weight.numpy(), want.weight)
    np.testing.assert_array_equal(got.pair_idx.numpy(), want.pair_idx)
    assert got.bucket == want.bucket
    moved = got.to("cpu")
    assert moved.protein.edge_dst.dtype == torch.int32
