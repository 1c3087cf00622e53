"""Port parity: the segment ops and batch containers of caster_dta_torch
against caster_dta_tpu on the same numpy inputs.

On the CPU the port's K1 (sorted segment-sum), K2 (row gather) and K3
(unsorted scatter-add) wrappers take their plain PyTorch versions; they are
held here against the JAX package's XLA path and its Pallas kernels in
interpret mode (``segment.USE_PALLAS = True``), forward and gradient. The
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


CASES = [(2, 70, 150, 200, 12), (1, 300, 515, 515, 28), (3, 33, 40, 64, 5), (2, 16, 0, 8, 3)]


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
    msgs, dst, mask = _padded_case(rng, 1, 8, 6, 8, 2)
    with pytest.raises(NotImplementedError):
        tseg.aggregate(*map(torch.from_numpy, (msgs, dst, mask)), 8, "max")


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
    assert cuda_segment.LAUNCHES == {cuda_segment.K1: 0, cuda_segment.K2: 0, cuda_segment.K3: 0}


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
