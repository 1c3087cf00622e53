"""Multi-device ``fit`` of the port (caster_dta_torch/parallel/, train/loop.py)
on the CPU, gloo ranks from tests/torch_ranks.py, against the port's
single-rank run, with dropout on (global-canonical masks):

- ``n_dp=2``: the store path (scan_steps, device-resident loader) and the
  per-batch path, within tests/test_multichip_fit.py's rtol 2e-3 / atol 2e-4;
- ``gp=2``: every protein overflows the ladder and trains edge-partitioned,
  against the single-rank run on a ladder that fits them, within
  tests/test_gp_fit.py's 2e-3 (its design: the partitioned node space equals
  the single run's pad, so the masks are the same);
- ``n_dp=2 x gp=2`` (4 ranks): standard buckets split over all four ranks,
  overflow pairs partitioned with 2 pairs a dp row, against the single-rank
  run of the same two sub-epochs (chip_smoke.two_sub_epoch_reference, which
  the card's multidevice phase runs too).

No JAX ``fit(n_dp=2)`` runs here: JAX's tests hold it to JAX's single-device
run, and tests/test_torch_train.py and test_torch_scan.py hold that to the
port's. ``PartitionedLoader`` gives JAX's buckets and batches, and
``BucketedLoader(batch_multiple=...)`` JAX's batch sizes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import torch_rank_jobs as jobs
from caster_dta_torch.data.batching import (BucketedLoader, PartitionedLoader,
                                            split_overflow_indices)
from caster_dta_torch.train.loop import TrainConfig, fit
from caster_dta_tpu.data.batching import BucketedLoader as JaxBucketedLoader
from caster_dta_tpu.data.batching import PartitionedLoader as JaxPartitionedLoader
from torch_ranks import RankPool

FIT_TOL = dict(rtol=2e-3, atol=2e-4)
GP_TOL = dict(rtol=2e-3)
CFG = dict(n_epochs=3, lr=1e-2, seed=0, scheduler=None, early_stop_epochs=100,
           print_unscaled_loss=False, save_state_every=0)
# proteins of 20-40 residues, within the default ladder
DP_DATA = dict(n_pairs=30, n_proteins=3, n_molecules=5, protein_nodes=[(20, 40)],
               molecule_nodes=(6, 10), seed=2)
# 40-55 residues: every one overflows the (16, 32) ladder of the gp run; with
# gp=2 the shards are laddered to 32 nodes, a 64-row node space, the pad of
# the single run's (16, 32, 64) ladder
GP_DATA = dict(DP_DATA, protein_nodes=[(40, 55)])
SMALL_LADDER, BIG_LADDER = (16, 32), (16, 32, 64)
# 24-72 residues: the proteins of at most 48 fit the (16, 48) ladder, the
# others overflow into 48-node shards (a 96-row node space)
MIXED_DATA = dict(DP_DATA, n_proteins=6, protein_nodes=[(24, 44), (52, 72)], seed=4)
MIXED_LADDER = (16, 48)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pool2(tmp_path_factory):
    p = RankPool(2, tmp_path_factory.mktemp("ranks2"))
    yield p
    p.close()


def _single(spec, tmp, cfg=None, **fit_kw):
    ds = jobs.dataset(spec)
    return jobs.summary(fit(jobs.model(ds.metadata_dict), ds, "synthetic", str(tmp),
                            TrainConfig(**(cfg or CFG)), verbose=False, device="cpu", **fit_kw))


def _close(a, b, tol):
    np.testing.assert_allclose(a["train"], b["train"], **tol)
    np.testing.assert_allclose(a["val"], b["val"], **tol)


@pytest.mark.parametrize("path", ["store", "per_batch"])
def test_dp2_fit_matches_single_rank(pool2, tmp_path, path):
    cfg = dict(CFG) if path == "store" else dict(CFG, scan_steps=False,
                                                  device_data_budget=None)
    fit_kw = dict(max_num=1_000_000_000, max_batch_size=4)
    ref = _single(DP_DATA, tmp_path / "ref", cfg, **fit_kw)
    res = pool2.run(jobs.fit_job, 2, 1, DP_DATA, {}, dict(cfg, n_dp=2), fit_kw,
                    str(tmp_path / "dp"))
    for r in res:
        _close(r, ref, FIT_TOL)
        np.testing.assert_allclose(r["test_mse"], ref["test_mse"], **FIT_TOL)
    assert res[0]["train"] == res[1]["train"]
    assert ref["train"][-1] < ref["train"][0]


def test_gp2_overflow_fit_with_dropout_matches_extended_ladder(pool2, tmp_path):
    cfg = dict(CFG, device_data_budget=None)
    fit_kw = dict(max_num=1_000_000_000, max_batch_size=2)
    ref = _single(GP_DATA, tmp_path / "ref", cfg,
                  ladder_kwargs={"protein_node_ladder": BIG_LADDER}, **fit_kw)
    res = pool2.run(jobs.fit_job, 1, 2, GP_DATA, {}, dict(cfg, gp=2),
                    dict(fit_kw, ladder_kwargs={"protein_node_ladder": SMALL_LADDER}),
                    str(tmp_path / "gp"))
    assert res[0]["overflow_pairs"]["train"] > 0 and ref["overflow_pairs"]["train"] == 0
    for r in res:
        _close(r, ref, GP_TOL)
        np.testing.assert_allclose(r["test_mse"], ref["test_mse"], rtol=5e-3)


def test_dp2_gp2_mixed_fit_matches_single_rank(tmp_path):
    cfg = dict(CFG, device_data_budget=None)
    pool4 = RankPool(4, tmp_path)
    try:
        res = pool4.run(jobs.fit_job, 2, 2, MIXED_DATA, {}, dict(cfg, n_dp=2, gp=2),
                        dict(max_num=1_000_000_000, max_batch_size=4,
                             ladder_kwargs={"protein_node_ladder": MIXED_LADDER}),
                        str(tmp_path / "mixed"))
    finally:
        pool4.close()
    ds = jobs.dataset(MIXED_DATA)
    ref = chip_smoke.two_sub_epoch_reference(jobs.model(ds.metadata_dict), ds, cfg, MIXED_LADDER,
                                             2, 4, "cpu")
    assert 0 < ref["n_overflow"] == res[0]["overflow_pairs"]["train"] < 21
    for r in res:
        _close(r, ref, GP_TOL)
        assert np.isfinite(r["test_mse"])


def _fields(batch) -> dict:
    out = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x for k, x in _fields(v).items()})
        else:
            out[f.name] = np.asarray(v)
    return out


def test_loaders_match_jax():
    ds = jobs.dataset(dict(MIXED_DATA, n_pairs=40))
    _, ovf = split_overflow_indices(ds, range(len(ds)), protein_node_ladder=MIXED_LADDER)
    kw = dict(gp=2, max_num=400_000, max_batch_size=5, seed=3, batch_multiple=2,
              protein_node_ladder=MIXED_LADDER)
    port, jax_loader = PartitionedLoader(ds, ovf, **kw), JaxPartitionedLoader(ds, ovf, **kw)
    assert port.buckets() == jax_loader.buckets() and len(port) == len(jax_loader)
    assert all(port.bucket_batch_size(b) % 2 == 0 for b in port.buckets())
    for _ in range(2):   # two epochs' shuffles
        got, want = list(port), list(jax_loader)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            fa, fb = _fields(a), _fields(b)
            assert fa.keys() == fb.keys()
            for k in fa:
                np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        assert port.last_batch_edges == jax_loader.last_batch_edges
    kw = dict(max_num=100_000, max_batch_size=12, shuffle=False, batch_multiple=4)
    port, jax_loader = BucketedLoader(ds, **kw), JaxBucketedLoader(ds, **kw)
    assert {b: port.bucket_batch_size(b) for b in port.buckets()} == {
        b: jax_loader.bucket_batch_size(b) for b in jax_loader.buckets()}
    assert all(port.bucket_batch_size(b) % 4 == 0 for b in port.buckets())
