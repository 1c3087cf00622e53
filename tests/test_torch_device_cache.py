"""Port parity for the device-resident graph store: caster_dta_torch's
data/device_cache.py against caster_dta_tpu's DeviceResidentLoader on the same
seeded synthetic dataset, on the CPU.

Everything here is exact: the stores are the same padded graphs stacked in
the same order, and the megabatches the same host arrays (rows, targets,
weights, pair indices) in the same bucket order.
"""
import types

import numpy as np
import pytest
import torch

from caster_dta_tpu.data import batching as jbatching
from caster_dta_tpu.data.device_cache import DeviceResidentLoader as JaxDeviceResidentLoader
from caster_dta_tpu.data.pairs import ProteinMoleculeDataset
from caster_dta_torch.data import batching, device_cache
from caster_dta_torch.data.device_cache import DeviceResidentLoader

GRAPH_FIELDS = ("node_s", "node_v", "node_type", "node_mask", "edge_src", "edge_dst", "edge_s",
                "edge_v", "edge_type", "edge_mask")
LADDERS = dict(protein_node_ladder=(16, 32, 48), edge_ladder=(128, 256, 512),
               molecule_node_ladder=(8, 16), molecule_edge_ladder=(32, 64))
LOADER = dict(max_num=3000, max_batch_size=6, shuffle=True, seed=5, coalesce_min_batches=1,
              **LADDERS)


@pytest.fixture(scope="module")
def dataset():
    """Pairs of 6 proteins (10-40 residues) and 5 molecules (6-14 atoms)."""
    return batching.synthetic_pair_dataset(40, 6, 5, protein_nodes=[(10, 40)],
                                           molecule_nodes=(6, 14), seed=3)


def _loaders(dataset, **kw):
    kw = {**LOADER, **kw}
    idx = list(range(len(dataset)))
    return (JaxDeviceResidentLoader(jbatching.BucketedLoader(dataset, idx, **kw)),
            DeviceResidentLoader(batching.BucketedLoader(dataset, idx, **kw), device="cpu"))


def _assert_graphs_equal(port, jax_graph, what):
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(jax_graph, name)),
                                      err_msg=f"{what}.{name}")


def test_metadata_dict_is_the_jax_datasets(dataset):
    """The widths and type counts that both packages' byte estimates read,
    by the JAX ProteinMoleculeDataset's own method on the same graphs."""
    view = types.SimpleNamespace(protein_data=dataset.protein_data,
                                 molecule_data=dataset.molecule_data)
    view._num_types = lambda *a: ProteinMoleculeDataset._num_types(view, *a)
    assert dataset.metadata_dict == ProteinMoleculeDataset._get_feature_metadata(view)
    assert dataset.metadata_dict["protein_node_features"] == (17, 3)
    assert dataset.metadata_dict["molecule_node_features"] == 41


def test_megabatches_match_jax_over_two_epochs(dataset):
    """The same bucket order (seeded per epoch) and the same per-step arrays
    and real-edge counts, over two epochs of a shuffled loader."""
    jl, tl = _loaders(dataset)
    assert len(tl.buckets()) >= 2
    assert (DeviceResidentLoader.estimate_store_bytes(tl.loader)
            == JaxDeviceResidentLoader.estimate_store_bytes(jl.loader) > 0)
    orders = []
    for _ in range(2):
        order = []
        pairs = zip(jl.iter_megabatches(), tl.iter_megabatches(), strict=True)
        for (jm, j_edges), (tm, t_edges) in pairs:
            assert t_edges == j_edges and tm.n_steps == jm.n_steps == len(t_edges)
            assert tm.bucket == (jm.p_store.node_s.shape[1], jm.p_store.edge_src.shape[1],
                                 jm.m_store.node_s.shape[1], jm.m_store.edge_src.shape[1])
            for name in ("p_rows", "m_rows", "target", "weight", "pair_idx"):
                got, want = getattr(tm, name), getattr(jm, name)
                assert got.dtype == want.dtype, name
                np.testing.assert_array_equal(got, want, err_msg=name)
            order.append(tm.bucket)
        orders.append(order)
    assert orders[0] != orders[1]     # the bucket order is shuffled per epoch


def test_stores_match_jax(dataset):
    jl, tl = _loaders(dataset)
    assert list(tl._p_store) == list(jl._p_store)
    for b in tl._p_store:
        _assert_graphs_equal(tl._p_store[b], jl._p_store[b], f"protein store {b}")
        _assert_graphs_equal(tl._m_store[b], jl._m_store[b], f"molecule store {b}")
        assert tl._p_rows[b] == jl._p_rows[b] and tl._m_rows[b] == jl._m_rows[b]
    # the stores hold every padded graph; the loader's host copies are gone
    assert tl.loader._pad_cache.nbytes == 0 and not tl.loader._pad_cache._d


def test_maybe_returns_the_plain_loader_over_budget(dataset):
    plain = batching.BucketedLoader(dataset, None, **LOADER)
    assert DeviceResidentLoader.maybe(plain, 10, device="cpu") is plain
    wrapped = DeviceResidentLoader.maybe(plain, device="cpu")
    assert isinstance(wrapped, DeviceResidentLoader) and wrapped.loader is plain
    assert isinstance(DeviceResidentLoader.maybe(plain, None, device="cpu"),
                      DeviceResidentLoader)


def test_store_batches_equal_the_loaders_batches(dataset):
    """Each StoreBatch, gathered from the stores, is the BucketedLoader's
    batch field by field, as is its PairBatch after ``.to``."""
    mk = lambda: batching.BucketedLoader(dataset, None, max_num=200_000, max_batch_size=8,
                                         shuffle=True, seed=3, **LADDERS)
    host, store = mk(), DeviceResidentLoader(mk(), device="cpu")
    seen = []
    for hb, sb in zip(host, store, strict=True):
        assert sb.bucket == hb.bucket
        assert store.last_batch_edges == host.last_batch_edges
        for pb in (sb, sb.to("cpu")):
            for side in ("protein", "molecule"):
                for name in GRAPH_FIELDS:
                    assert torch.equal(getattr(getattr(pb, side), name),
                                       getattr(getattr(hb, side), name)), f"{side}.{name}"
            for name in ("target", "weight", "pair_idx"):
                assert torch.equal(getattr(pb, name), getattr(hb, name)), name
        seen += sb.pair_idx[sb.weight > 0].tolist()
    assert sorted(seen) == list(range(len(dataset)))


def test_packed_rows_round_trip_with_aligned_fields():
    """A batch's (or k batches') rows, targets and weights in one int32
    array: views that give them back exactly, each field 64-byte aligned."""
    rng = np.random.default_rng(0)
    k, b = 3, 21
    p_rows, m_rows = rng.integers(0, 100, (2, k, b)).astype(np.int32)
    target, weight = rng.normal(size=(2, k, b)).astype(np.float32)
    packed = torch.from_numpy(device_cache.pack_batch_rows(p_rows, m_rows, target, weight))
    assert packed.shape == (k, 4 * device_cache.field_words(b)) and packed.dtype == torch.int32
    assert packed.shape[1] % device_cache.FIELD_ALIGN == 0
    for j in range(k):
        fields = device_cache.unpack_batch_rows(packed[j], b)
        for got, want in zip(fields, (p_rows[j], m_rows[j], target[j], weight[j])):
            assert np.array_equal(got.numpy(), want) and got.dtype == torch.from_numpy(want).dtype
            assert (got.storage_offset() - packed[j].storage_offset()) \
                % device_cache.FIELD_ALIGN == 0


def test_pad_cache_clear_resets_its_bytes():
    cache = batching._LRUPadCache(1 << 20)
    cache.put("a", {"x": np.zeros(100, np.float32)})
    assert cache.nbytes == 400 and cache.get("a") is not None
    cache.clear()
    assert cache.nbytes == 0 and cache.get("a") is None
