"""The port's dataset layer (caster_dta_torch/data/datasets.py, synthetic.py,
pairs.py) against the JAX package's, on the CPU: the same input files give
the same rows (records against the JAX DataFrame's columns), and
``ProteinMoleculeDataset`` on the synthetic set gives the same graphs,
metadata, scale parameters and scaled targets, bit for bit. The canned
Davis, Metz, BindingDB and BELKA files are written as tests/test_datasets.py
writes them, with more rows.
"""
import json
import os
import pickle

import numpy as np
import pandas as pd
import pytest

from caster_dta_torch.data import datasets as t_ds
from caster_dta_torch.data.pairs import ProteinMoleculeDataset as TorchPMD
from caster_dta_tpu.data import datasets as j_ds
from caster_dta_tpu.data.pairs import ProteinMoleculeDataset as JaxPMD

SEQ = "ACDEFGHIKLMNPQRSTVWYACDEFGHIKL"
SMILES = ["CCO", "CCN", "c1ccccc1", "CC(=O)O", "c1ccncc1", "C1CC1"]
DATASET_KWARGS = dict(sparse_edges=False, protein_dist_units="angstroms",
                      protein_edge_thresh=4, protein_thresh_type="dist",
                      protein_keep_selfloops=True, protein_vector_features=True,
                      protein_include_esm2=False, protein_include_residue_posenc=False,
                      protein_include_aa_props=True, molecule_full_atomtype=False,
                      molecule_onehot_ordinal_feats=False, molecule_include_selfloops=True,
                      scale_output=["standardize"])


def _rows(df: pd.DataFrame) -> dict:
    return {c: df[c].tolist() for c in df.columns}


def _assert_same_rows(records: dict, df: pd.DataFrame):
    assert list(records) == list(df.columns)
    assert records == _rows(df)


def test_davis_format_loader(tmp_path):
    d = tmp_path / "deepdta_data" / "davis"
    d.mkdir(parents=True)
    prots = {"P1": "ACDEFGHIKL", "P2": "MNPQRSTVWY", "P3": "WYACDE"}
    ligs = {"L1": "CCO", "L2": "CCN", "L3": "c1ccccc1", "L4": "CC(=O)O"}
    json.dump(prots, open(d / "proteins.txt", "w"))
    json.dump(ligs, open(d / "ligands_iso.txt", "w"))
    y = np.array([[5.0, np.nan, 7.7], [7.2, 6.1, 5.0], [np.nan, 8.3, 5.0], [5.0, 5.0, 5.0]])
    with open(d / "Y", "wb") as f:
        pickle.dump(y, f)
    (tmp_path / "structs").mkdir()
    for pid in ("P1", "P3"):
        (tmp_path / "structs" / f"{pid}.pdb").write_text("END\n")
    for kw in ({}, {"structures_dir": str(tmp_path / "structs")},
               {"do_mostcommon_filter": True}):
        _assert_same_rows(t_ds.load_dataset("davis", data_root=str(tmp_path), **kw),
                          j_ds.load_dataset("davis", data_root=str(tmp_path), **kw))


def test_metz_loader(tmp_path):
    d = tmp_path / "other_data" / "metz"
    d.mkdir(parents=True)
    pd.DataFrame({"name": ["KA", "KB"], "sequence": ["ACDEFG", "HIKLMN"]}).to_csv(
        d / "prot_info.csv", index=False)
    pd.DataFrame({"PUBCHEM_SID": [101, 102, None, 104],
                  "Canonical_Smiles": ["CCO", "CCN", "CCC", "c1ccccc1"],
                  "KA": ["5.1", "<4", "6.0", ""], "KB": ["7.25", "6.5", "5.5", "4.75"]}).to_csv(
        d / "Metz_interaction.csv", index=False)
    _assert_same_rows(t_ds.load_dataset("metz", data_root=str(tmp_path)),
                      j_ds.load_dataset("metz", data_root=str(tmp_path)))


def _bindingdb_rows():
    rows = []
    for i, (smi, kd) in enumerate(zip(SMILES, [10.0, 100.0, 1000.0, 10.0, 3.3, 0.0])):
        rows.append({"BindingDB Ligand Name": f"lig{i % 4}", "Ligand SMILES": smi,
                     "Target Name": f"targ{i % 2}",
                     "BindingDB Target Chain Sequence": SEQ if i % 2 else SEQ.lower() + "AA",
                     "Kd (nM)": kd})
    # repeated pairs -> averaged (three values: a Kahan-compensated sum)
    rows.append(dict(rows[0], **{"Kd (nM)": 1000.0}))
    rows.append(dict(rows[0], **{"Kd (nM)": 7.0}))
    rows.append(dict(rows[1], **{"Kd (nM)": ">10000"}))   # not a number: dropped
    rows.append(dict(rows[2], **{"Ligand SMILES": "C1CC"}))   # invalid SMILES: dropped
    rows.append(dict(rows[3], **{"BindingDB Target Chain Sequence": "ACD"}))   # too short
    return rows


def test_bindingdb_loader(tmp_path):
    d = tmp_path / "other_data" / "bindingdb"
    d.mkdir(parents=True)
    pd.DataFrame(_bindingdb_rows()).to_csv(d / "BindingDB_All.tsv", sep="\t", index=False)
    want = j_ds.load_dataset("bindingdb", data_root=str(tmp_path))
    got = t_ds.load_dataset("bindingdb", data_root=str(tmp_path))
    _assert_same_rows(got, want)
    assert len(got["affinity_score"]) >= 4
    # each package's parse cache, read back on the second load
    assert sorted(os.listdir(d)) == ["BindingDB_All.tsv", "BindingDB_All.tsv_parsed_kd.pkl",
                                     "BindingDB_All.tsv_parsed_kd_records.pkl"]
    _assert_same_rows(t_ds.load_dataset("bindingdb", data_root=str(tmp_path)), want)
    (tmp_path / "empty" / "other_data" / "bindingdb").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="BindingDB_All.tsv"):
        t_ds.load_dataset("bindingdb_ic50", data_root=str(tmp_path / "empty"))


def test_belka_loader(tmp_path):
    pytest.importorskip("pyarrow")
    d = tmp_path / "belka_data" / "belka"
    d.mkdir(parents=True)
    rows = []
    for smi, binds in zip(SMILES + ["C1CC"], [0, 1, 0, 1, 1, 0, 1]):
        for prot in ("sEH", "BRD4", "HSA"):
            rows.append({"molecule_smiles": smi, "protein_name": prot, "binds": binds})
    pd.DataFrame(rows[:-1]).to_parquet(d / "train.parquet")
    want = j_ds.load_dataset("belka", data_root=str(tmp_path))
    got = t_ds.load_dataset("belka", data_root=str(tmp_path))
    _assert_same_rows(got, want)
    assert os.path.exists(d / "train.parquet_parsed_pivot_records.pkl")
    _assert_same_rows(t_ds.load_dataset("belka", data_root=str(tmp_path)), want)


def test_filters():
    rec = {"protein_id": ["a", "b", "c", "a", "b", "d"],
           "protein_sequence": ["AAAA", "AAAA", "CCCC", "AAAA", "AAAA", "CCCC"],
           "protein_file": [""] * 6,
           "molecule_id": ["m", "m", "m", "n", "n", "n"],
           "molecule_smiles": ["CCO"] * 6,
           "affinity_score": [1.0, 2.0, 3.0, 5.0, 2.0, 3.0]}
    df = pd.DataFrame(rec)
    _assert_same_rows(t_ds.apply_proteinseqdupe_filter(rec), j_ds.apply_proteinseqdupe_filter(df))
    _assert_same_rows(t_ds.apply_mostcommon_filter(rec, 0.3), j_ds.apply_mostcommon_filter(df, 0.3))
    _assert_same_rows(t_ds.apply_mostcommon_filter(rec), j_ds.apply_mostcommon_filter(df))


def test_plinder_refused(tmp_path):
    """Without a processed CSV a fresh PLINDER parse needs the plinder
    package: both packages refuse with the same ImportError (the cached CSV
    is read: tests/test_torch_acquire.py)."""
    with pytest.raises(ImportError, match="plinder") as t_err:
        t_ds.load_dataset("plinder", data_root=str(tmp_path))
    with pytest.raises(ImportError) as j_err:
        j_ds.load_dataset("plinder", data_root=str(tmp_path))
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("kw", [{}, dict(n_pairs=60, n_proteins=5, n_molecules=9, seed=3)])
def test_synthetic_rows_and_pdb_bytes(tmp_path, kw):
    got = t_ds.load_dataset("synthetic", data_root=str(tmp_path / "t"), **kw)
    want = j_ds.load_dataset("synthetic", data_root=str(tmp_path / "j"), **kw)
    assert got["protein_file"] == [p.replace(str(tmp_path / "j"), str(tmp_path / "t"))
                                   for p in want["protein_file"]]
    got["protein_file"] = want["protein_file"].tolist()
    _assert_same_rows(got, want)
    for name in sorted(os.listdir(tmp_path / "j" / "synthetic_pdbs")):
        with open(tmp_path / "t" / "synthetic_pdbs" / name, "rb") as a, \
                open(tmp_path / "j" / "synthetic_pdbs" / name, "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("native", [True, False])
def test_protein_molecule_dataset_equals_jax(tmp_path, native):
    kw = dict(n_pairs=60, n_proteins=5, n_molecules=12, seed=1)
    rec = t_ds.load_dataset("synthetic", data_root=str(tmp_path), **kw)
    df = j_ds.load_dataset("synthetic", data_root=str(tmp_path), **kw)
    # 12 molecules and 5 proteins: the molecules go through a pool of 2
    # spawned workers, the proteins through this process
    ds = TorchPMD(rec, n_workers=2, native_host=native, **DATASET_KWARGS)
    jd = JaxPMD(df, n_workers=0, **DATASET_KWARGS)
    assert ds.metadata_dict == jd.metadata_dict
    assert ds._report_scale_data() == jd._report_scale_data()
    assert json.dumps(ds._report_scale_data()) == json.dumps(jd._report_scale_data())
    np.testing.assert_array_equal(ds.affinity_data, jd.affinity_data)
    assert ds.affinity_data.dtype == jd.affinity_data.dtype
    np.testing.assert_array_equal(ds.unscale_target(ds.affinity_data),
                                  jd.unscale_target(jd.affinity_data))
    assert list(ds.protein_data) == list(jd.protein_data)
    assert list(ds.molecule_data) == list(jd.molecule_data)
    for store_t, store_j in ((ds.protein_data, jd.protein_data),
                             (ds.molecule_data, jd.molecule_data)):
        for key in store_j:
            for field, want in store_j[key].items():
                if want is None:
                    assert store_t[key][field] is None
                elif isinstance(want, np.ndarray):
                    assert store_t[key][field].dtype == want.dtype
                    np.testing.assert_array_equal(store_t[key][field], want)
                else:
                    assert store_t[key][field] == want
    assert ds.pair_indices == jd.pair_indices
    np.testing.assert_array_equal(ds.idx_protein_strat, jd.idx_protein_strat)
    np.testing.assert_array_equal(ds.idx_molecule_strat, jd.idx_molecule_strat)
    assert str(ds) == str(jd)
    for i in (0, len(ds) - 1):
        for a, b in zip(ds[i][:2], jd[i][:2]):
            assert a is b or a["n_edges"] == b["n_edges"]
        assert ds[i][2] == jd[i][2]

    # another run's scaling adopted, as create_dataset_with_checkpoint_params does
    other = {"scale_output": ["standardize"],
             "standardize": {"scale_mean_factor": 6.5, "scale_std_factor": 0.75}}
    ds._load_scale_data_from_dict(other)
    jd._load_scale_data_from_dict(other)
    np.testing.assert_array_equal(ds.unscale_target(np.array([0.5, -1.0], np.float32)),
                                  jd.unscale_target(np.array([0.5, -1.0], np.float32)))
    assert ds._report_scale_data() == jd._report_scale_data()
