"""The port's acquisition layer (caster_dta_torch/data/acquire.py), its
PLINDER cache reader (data/plinder.py) and the ESM2 block's placement
against the JAX package's, on the CPU, with no network: every HTTP call
goes to canned answers through the same seams (``_http_get``,
``_http_post_json``) in both packages.

- Every case of tests/test_acquire.py, run on the port.
- ``get_rcsb_res``'s JSON payload equals JAX's for the same inputs.
- ``download_pdb_files`` and ``process_data`` in two directories from the
  same canned answers: the structures, the accession sidecars and the search
  records (but their date line) byte for byte JAX's, and
  ``processed_data_full.csv`` and ``processed_data.csv`` byte for byte.
- The PLINDER cache as records with its split, through ``load_dataset`` and
  ``split_dataset``; a fresh parse raises JAX's ImportError.
- The ESM2 block with a stub embedder: ``compute_residue_node_features`` and
  ``build.protein_file_to_graph`` against JAX's (``pairs._protein_file_to_graph``),
  bit for bit.
"""
import json
import os
import re

import numpy as np
import pandas as pd
import pytest

from caster_dta_torch.data import acquire, datasets, plinder, tables
from caster_dta_tpu.data import acquire as j_acquire


class _Resp:
    def __init__(self, content=b"", payload=None):
        self.content = content
        self._payload = payload

    def json(self):
        return self._payload


def _seq_result(identifier, identity=1.0, score=1.0, qlen=10, slen=10):
    return {
        "identifier": identifier,
        "score": score,
        "services": [{
            "service_type": "sequence",
            "nodes": [{"match_context": [{
                "sequence_identity": identity,
                "query_length": qlen,
                "subject_length": slen,
            }]}],
        }],
    }


# ---------------------------------------------------------------- query JSON

def test_attr_and_seq_nodes():
    n = acquire._attr_node("a.b", "equals", 0)
    assert n == {"type": "terminal", "service": "text",
                 "parameters": {"attribute": "a.b", "operator": "equals", "value": 0}}
    s = acquire._seq_node("MKV", identity=0.9)
    assert s["service"] == "sequence"
    assert s["parameters"]["identity_cutoff"] == 0.9
    assert s["parameters"]["value"] == "MKV"
    assert s == j_acquire._seq_node("MKV", identity=0.9)


@pytest.mark.parametrize("qtype", ["experimental", "computational"])
@pytest.mark.parametrize("allow_complex", [False, True])
@pytest.mark.parametrize("seq", ["MKVL" * 10, "M" * 50, "ACDEFGHIKLMNPQRSTVWY" * 7])
def test_get_rcsb_res_payload_equals_jax(monkeypatch, qtype, allow_complex, seq):
    captured = {}

    def fake_post(side):
        def post(url, payload, timeout=60):
            captured[side] = (url, json.dumps(payload, sort_keys=False))
            return {"result_set": [{"identifier": "1ABC_1"}]}
        return post

    monkeypatch.setattr(acquire, "_http_post_json", fake_post("torch"))
    monkeypatch.setattr(j_acquire, "_http_post_json", fake_post("jax"))
    res = acquire.get_rcsb_res(seq, qtype, allow_complex)
    assert res == j_acquire.get_rcsb_res(seq, qtype, allow_complex) == [{"identifier": "1ABC_1"}]
    assert captured["torch"] == captured["jax"]
    p = json.loads(captured["torch"][1])
    assert p["return_type"] == "polymer_entity"
    assert p["request_options"]["results_content_type"] == [qtype]
    assert p["request_options"]["results_verbosity"] == "verbose"
    assert seq in captured["torch"][1]


def test_get_rcsb_res_experimental_allow_complex(monkeypatch):
    captured = {}
    monkeypatch.setattr(acquire, "_http_post_json",
                        lambda u, p, timeout=60: captured.update(p=p) or {})
    acquire.get_rcsb_res("M" * 50, "experimental", allow_complex=True)
    dump = json.dumps(captured["p"]["query"])
    assert "unmodeled_polymer_monomer_count" in dump
    assert '"value": 10' in dump
    assert "Homo sapiens" in dump


def test_get_rcsb_res_network_error_returns_empty(monkeypatch):
    def boom(url, payload, timeout=60):
        raise RuntimeError("no network")
    monkeypatch.setattr(acquire, "_http_post_json", boom)
    assert acquire.get_rcsb_res("MKV", "experimental") == []


# ------------------------------------------------------------ result checking

def test_check_pdb_result_filters():
    results = [
        _seq_result("GOOD_1"),
        _seq_result("PARTIAL_1", identity=0.95),
        _seq_result("SCORE_1", score=0.9),
        _seq_result("LEN_1", qlen=10, slen=12),
        {"identifier": "NOSEQ_1", "score": 1.0, "services": []},
        {"identifier": "NOCTX_1", "score": 1.0,
         "services": [{"service_type": "sequence", "nodes": [{"match_context": []}]}]},
        _seq_result("GOOD2_2"),
    ]
    assert acquire.check_pdb_result(results) == ["GOOD_1", "GOOD2_2"]
    assert acquire.check_pdb_result(results) == j_acquire.check_pdb_result(results)


# ----------------------------------------------------------------- selection

ENTRIES = {
    "1AAA": {"rcsb_entry_info": {"deposited_modeled_polymer_monomer_count": 90,
                                 "resolution_combined": [2.0]}},
    "1BBB": {"rcsb_entry_info": {"deposited_modeled_polymer_monomer_count": 100,
                                 "resolution_combined": [3.0]}},
    "1CCC": {"rcsb_entry_info": {"deposited_modeled_polymer_monomer_count": 100,
                                 "resolution_combined": [1.5]}},
    "1DDD": {"rcsb_entry_info": {"deposited_modeled_polymer_monomer_count": 100}},
}


def test_select_experimental_ordering(monkeypatch):
    """Modeled count first, resolution breaks the tie, a missing resolution
    ranks last among equals, an entry that fails to load is passed over."""
    for mod in (acquire, j_acquire):
        monkeypatch.setattr(mod, "_entry_json", lambda e: ENTRIES[e])
    for ids, want in ((["1AAA_1", "1BBB_1", "1CCC_1"], "1CCC_1"),
                      (["1DDD_1", "1CCC_1"], "1CCC_1"), (["1DDD_1", "1AAA_1"], "1DDD_1"),
                      (["1XXX_1", "1AAA_1"], "1AAA_1")):
        assert acquire._select_experimental_pdb(ids) == want == \
            j_acquire._select_experimental_pdb(ids)


def test_select_computational_plddt(monkeypatch):
    def entry(e):
        data = {"AF_A": ("AlphaFoldDB", 77.0), "AF_B": ("AlphaFoldDB", 91.5),
                "MA_C": ("ModelArchive", 99.0)}[e]
        return {"rcsb_comp_model_provenance": {"source_db": data[0]},
                "rcsb_ma_qa_metric_global": [{"ma_qa_metric_global": [{"value": data[1]}]}]}
    for mod in (acquire, j_acquire):
        monkeypatch.setattr(mod, "_entry_json", entry)
    ids = ["AF_A_1", "AF_B_1", "MA_C_1"]
    assert acquire._select_computational_pdb(ids) == "AF_B_1" == \
        j_acquire._select_computational_pdb(ids)


# ------------------------------------------------------------------ download

def test_select_and_download_cif_fallback(monkeypatch, tmp_path):
    calls = []

    def fake_get(url, **kw):
        calls.append(url)
        if url.endswith(".pdb"):
            raise RuntimeError("404")
        return _Resp(content=b"data_cif")

    monkeypatch.setattr(acquire, "_http_get", fake_get)
    out = str(tmp_path / "x.pdb")
    assert acquire._select_and_download_pdb(["1ABC_1"], out) == "1ABC_1"
    assert open(out, "rb").read() == b"data_cif"
    assert calls[0].endswith("1ABC.pdb") and calls[1].endswith("1ABC.cif")
    assert "1ABC_1" in open(str(tmp_path / "x_accession.txt")).read()


def test_download_pdb_files_sidecar_resume(monkeypatch, tmp_path):
    searches = []

    def fake_search(seq, qtype, allow_complex=False):
        searches.append((seq, qtype))
        return [] if qtype == "experimental" else [_seq_result("AF_X_1")]

    monkeypatch.setattr(acquire, "get_rcsb_res", fake_search)
    monkeypatch.setattr(acquire, "_select_and_download_pdb",
                        lambda lst, out, ver=None, **k: open(out, "w").write("pdb") and lst[0])
    out = str(tmp_path / "p1.pdb")
    assert acquire.download_pdb_files(["p1"], ["MSEQ"], [out], overwrite=False) == ["p1"]
    assert [q for _, q in searches] == ["experimental", "computational"]
    record = str(tmp_path / "p1_search_record.txt")
    assert "AF_X_1" in open(record).read()

    searches.clear()
    assert acquire.download_pdb_files(["p1"], ["MSEQ"], [out], overwrite=False) == ["p1"]
    assert searches == []

    with open(str(tmp_path / "p2_search_record.txt"), "w") as f:
        f.write("Search options: []\nChosen: None\n")
    assert acquire.download_pdb_files(["p2"], ["MSEQ2"], [str(tmp_path / "p2.pdb")],
                                      overwrite=False) == []
    assert searches == []


def test_download_known_pdb_ids(monkeypatch, tmp_path):
    downloaded = []
    monkeypatch.setattr(acquire, "_select_and_download_pdb",
                        lambda lst, out, ver=None, **k: (
                            downloaded.append(lst) or open(out, "w").write("pdb") or lst[0]))
    outs = [str(tmp_path / "a.pdb"), str(tmp_path / "b.pdb")]
    acquire.download_pdb_files(["a", "b"], None, outs, known_pdb_ids=["1AAA", "2BBB"],
                               overwrite=True)
    assert downloaded == [["1AAA_1"], ["2BBB_1"]]
    assert os.path.exists(str(tmp_path / "a_search_record.txt"))


# ---------------------------------------- both packages on the same answers

def _canned(mod, monkeypatch, log):
    """Seams answering the same canned RCSB traffic: the sequence "MKV..."
    has an experimental hit (two entries, PDB download 404 for one), "MLE..."
    only a computational one, "MQQ..." none."""
    def post(url, payload, timeout=60):
        seq = json.dumps(payload)
        kind = payload["request_options"]["results_content_type"][0]
        log.append(("post", kind))
        if "MKV" in seq and kind == "experimental":
            return {"result_set": [_seq_result("1AAA_1"), _seq_result("1CCC_2"),
                                   _seq_result("9ZZZ_1", identity=0.5)]}
        if "MLE" in seq and kind == "computational":
            return {"result_set": [_seq_result("AF_A_1"), _seq_result("AF_B_1")]}
        return {}

    def get(url, **kw):
        log.append(("get", url))
        m = re.search(r"entry/(\w+)$", url)
        if m:
            e = m.group(1)
            if e.startswith("AF_"):
                return _Resp(payload={
                    "rcsb_comp_model_provenance": {
                        "source_db": "AlphaFoldDB",
                        "source_url": f"https://models.example/{e}.cif.gz"},
                    "rcsb_ma_qa_metric_global": [{"ma_qa_metric_global": [
                        {"value": {"AF_A": 70.0, "AF_B": 88.0}[e]}]}]})
            return _Resp(payload=ENTRIES[e])
        if url.endswith("1CCC.pdb"):
            raise RuntimeError("404")
        return _Resp(content=f"MODEL {url}\n".encode())

    monkeypatch.setattr(mod, "_http_post_json", post)
    monkeypatch.setattr(mod, "_http_get", get)


def _tree(root):
    """Every file under ``root``: relative path -> bytes, search records
    without their date line."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            data = open(p, "rb").read()
            if f.endswith("_search_record.txt"):
                data = re.sub(rb"\nDate: [^\n]*$", b"", data)
            out[os.path.relpath(p, root)] = data
    return out


def test_download_pdb_files_equals_jax_on_canned_answers(monkeypatch, tmp_path):
    ids = ["p1", "p2", "p3"]
    seqs = ["MKV" + "A" * 20, "MLE" + "C" * 20, "MQQ" + "D" * 20]
    logs = {}
    for side, mod in (("torch", acquire), ("jax", j_acquire)):
        logs[side] = []
        _canned(mod, monkeypatch, logs[side])
        d = tmp_path / side
        d.mkdir()
        outs = [str(d / f"{i}.pdb") for i in ids]
        got = mod.download_pdb_files(ids, seqs, outs, overwrite=False)
        assert got == ["p1", "p2"], side
    assert logs["torch"] == [(k, v.replace(str(tmp_path / "jax"), str(tmp_path / "torch")))
                             for k, v in logs["jax"]]
    torch_tree, jax_tree = _tree(tmp_path / "torch"), _tree(tmp_path / "jax")
    assert torch_tree == jax_tree
    assert b"1CCC_2" in torch_tree["p1_accession.txt"]        # the experimental winner
    assert torch_tree["p2.pdb"].endswith(b"AF_B.pdb\n")      # pLDDT 88 over 70
    record = open(tmp_path / "torch" / "p3_search_record.txt").read()
    assert re.search(r"\nDate: \d{4}-\d\d-\d\d \d\d:\d\d:\d\d(\.\d{6})?$", record)


@pytest.mark.parametrize("case", ["floats", "ints_and_nan", "skip_dl_reread"])
def test_process_data_csvs_equal_jax(monkeypatch, tmp_path, case):
    proteins = {"p1": "MKV" + "A" * 20, "p/2 x": "MLE" + "C" * 20, "p3": "MQQ" + "D" * 20}
    ligands = {"m1": "CCO", "m2": "CCC", "m3": "c1ccccc1"}
    if case == "floats":
        affinity = np.array([[5.0, np.nan, 7.3979400086720375], [6.25, 1e-5, -9999.0],
                             [0.1 + 0.2, 1e16, 3.0]])
    else:
        affinity = [[5, None, 7], [6, 8, np.nan], [1, 2, 3]]
        affinity = np.array(affinity, dtype=object) if case == "ints_and_nan" else \
            np.array([[5, 6, 7], [6, 8, 9], [1, 2, 3]])
    out = {}
    for side, mod in (("torch", acquire), ("jax", j_acquire)):
        _canned(mod, monkeypatch, [])
        d = tmp_path / side
        kw = dict(data_path=str(d), skip_pdb_dl=case == "skip_dl_reread")
        if case == "skip_dl_reread":
            (d / "pdb_files").mkdir(parents=True)
            (d / "pdb_files" / "p3.pdb").write_text("x")
        res = mod.process_data(proteins, ligands, affinity, **kw)
        if case == "skip_dl_reread":
            res = mod.process_data(proteins, ligands, affinity, overwrite_csv=False, **kw)
        out[side] = res
    t, j = out["torch"], out["jax"]
    assert list(t) == list(j.columns)
    for c in j.columns:
        want = [x.replace(str(tmp_path / "jax"), str(tmp_path / "torch"))
                if isinstance(x, str) else x for x in j[c].tolist()]
        assert t[c] == want, c
    for name in ("processed_data_full.csv", os.path.join("pdb_files", "processed_data.csv")):
        a = (tmp_path / "torch" / name).read_bytes()
        b = (tmp_path / "jax" / name).read_bytes().replace(
            str(tmp_path / "jax").encode(), str(tmp_path / "torch").encode())
        assert a == b, name
    assert _tree(tmp_path / "torch").keys() == _tree(tmp_path / "jax").keys()


def test_process_data_skip_dl(tmp_path):
    """tests/test_acquire.py's orchestration case on the port."""
    proteins = {"p1": "MKV", "p2": "MLE"}
    ligands = {"m1": "CCO", "m2": "CCC"}
    affinity = np.array([[5.0, np.nan], [6.0, 7.0]])
    pdb_dir = tmp_path / "pdb_files"
    pdb_dir.mkdir(parents=True)
    (pdb_dir / "p1.pdb").write_text("x")
    rec = acquire.process_data(proteins, ligands, affinity, data_path=str(tmp_path),
                               skip_pdb_dl=True)
    assert set(rec["protein_id"]) == {"p1"}
    assert sorted(rec["affinity_score"]) == [5.0, 6.0]
    assert list(rec) == ["protein_id", "protein_sequence", "protein_file", "molecule_id",
                         "molecule_smiles", "affinity_score"]
    assert len(pd.read_csv(tmp_path / "processed_data_full.csv")) == 3
    rec2 = acquire.process_data(proteins, ligands, affinity, data_path=str(tmp_path),
                                skip_pdb_dl=True, overwrite_csv=False)
    assert len(rec2["protein_id"]) == 2


def test_http_seams_use_urllib_only():
    """The seams are urllib's: the module imports no HTTP package."""
    import sys
    import caster_dta_torch.data.acquire as mod
    src = open(mod.__file__).read()
    assert "requests" not in re.findall(r"^\s*(?:import|from) (\w+)", src, re.M)
    assert "urllib" in sys.modules


# -------------------------------------------------------------------- PLINDER

def _plinder_csv(d):
    d.mkdir(parents=True)
    pd.DataFrame({
        "protein_id": ["a", "b", "c", "7"],
        "protein_sequence": ["ACDEFGHIKL", "MNPQRSTVWY", "ACDEFGHIKL", "MKV"],
        "protein_file": ["x.pdb", "y.pdb", "z.pdb", "NOSTRUCTREQUESTED"],
        "molecule_id": ["m1", "m2", "m1", "m3"],
        "molecule_smiles": ["CCO", "CCN", "CCO", "C"],
        "affinity_score": [5.0, 6, 7.25, 8],
        "split": ["train", "val", "test", "train"],
    }).to_csv(d / "processed_data_plinderdl.csv", index=False)


def test_plinder_csv_cache_and_split_match_jax(tmp_path):
    from caster_dta_torch.train.loop import split_dataset
    from caster_dta_tpu.data import datasets as j_datasets
    from caster_dta_tpu.data.plinder import parse_plinder as j_parse

    _plinder_csv(tmp_path / "plinder_data")
    rec = plinder.parse_plinder(str(tmp_path / "plinder_data"))
    df = j_parse(str(tmp_path / "plinder_data"))
    assert list(rec) == list(df.columns)
    for c in df.columns:
        assert rec[c] == df[c].tolist(), c
    assert all(isinstance(a, float) for a in rec["affinity_score"])
    assert rec["split"] == ["train", "val", "test", "train"]

    rec2 = datasets.load_dataset("plinder", data_root=str(tmp_path), structures_dir=None)
    df2 = j_datasets.load_dataset("plinder", data_root=str(tmp_path), structures_dir=None)
    assert {c: rec2[c] for c in rec2} == {c: df2[c].tolist() for c in df2.columns}

    class Labelled:
        split = rec2["split"]
    assert split_dataset(Labelled(), seed=0) == ([0, 3], [1], [2])


def test_plinder_fresh_parse_raises_jax_import_error(tmp_path):
    from caster_dta_tpu.data.plinder import parse_plinder as j_parse
    with pytest.raises(ImportError) as t_err:
        plinder.parse_plinder(str(tmp_path / "empty"), force_reparse=True)
    with pytest.raises(ImportError) as j_err:
        j_parse(str(tmp_path / "empty"), force_reparse=True)
    assert str(t_err.value) == str(j_err.value)
    assert "plinder" in str(t_err.value)


def test_read_csv_infers_types_as_pandas(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("a,b,c,d,e,f\n1,1.5,x,True,,NA\n2,,y,False,3,7\n")
    rec = tables.read_csv(str(p))
    df = pd.read_csv(p)
    for c in df.columns:
        got, want = rec[c], df[c].tolist()
        assert [type(x).__name__ for x in got if not tables.is_na(x)] == \
            [type(x).__name__ for x in (v.item() if hasattr(v, "item") else v
                                        for v in want) if not pd.isna(x)], c
        assert [None if tables.is_na(x) else x for x in got] == \
            [None if pd.isna(x) else x for x in want], c


# ----------------------------------------------------------------------- ESM2

def _stub_esm(letters):
    out = np.arange(len(letters) * 320, dtype=np.float32).reshape(-1, 320)
    return out / 1000.0 + np.float32(len(letters))


@pytest.mark.parametrize("vectorize", [True, False])
def test_esm2_block_placement_matches_jax(monkeypatch, vectorize):
    from caster_dta_torch.data.featurize import protein as t_protein
    from caster_dta_tpu.data.featurize import protein as j_protein

    calls = {}
    for side, mod in (("torch", t_protein), ("jax", j_protein)):
        monkeypatch.setattr(mod, "_esm2_embeddings",
                            lambda letters, side=side: calls.setdefault(side, list(letters))
                            and _stub_esm(letters))
    rng = np.random.default_rng(3)
    n = 9
    ca = np.cumsum(rng.normal(scale=2.2, size=(n, 3)), axis=0)
    coords = np.stack([ca + rng.normal(scale=0.8, size=(n, 3)), ca,
                       ca + rng.normal(scale=0.8, size=(n, 3)),
                       ca + rng.normal(scale=1.2, size=(n, 3))], axis=1).astype(np.float32)
    idents = rng.integers(0, 20, n)
    for posenc in (False, True):
        t = t_protein.compute_residue_node_features(coords, idents, vectorize, True, posenc)
        j = j_protein.compute_residue_node_features(coords, idents, vectorize, True, posenc)
        for a, b in zip(t if vectorize else [t], j if vectorize else [j]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert calls["torch"] == calls["jax"]
    scalars = t[0] if vectorize else t
    width = 6 + 11 + 8                   # angles, aa properties, posenc
    assert np.array_equal(scalars[:, width:width + 320], _stub_esm(calls["torch"]))


def test_esm2_flag_through_the_graph_build_matches_jax(monkeypatch, tmp_path):
    from caster_dta_torch.data import build as t_build
    from caster_dta_torch.data import synthetic as t_synth
    from caster_dta_torch.data.featurize import protein as t_protein
    from caster_dta_tpu.data import pairs as j_pairs
    from caster_dta_tpu.data.featurize import protein as j_protein

    for mod in (t_protein, j_protein):
        monkeypatch.setattr(mod, "_esm2_embeddings", _stub_esm)
    seq = "ACDEFGHIKLMNPQRSTVWYAC"
    path = str(tmp_path / "h.pdb")
    t_synth.write_pdb(path, t_synth.helix_backbone(len(seq), np.random.default_rng(0)), seq)
    args = (path, "angstroms", 4, "dist", True, True, True, False, True)
    t, j = t_build.protein_file_to_graph(*args), j_pairs._protein_file_to_graph(*args)
    assert t["node_s"].shape == (len(seq), 17 + 320)
    assert t.keys() == j.keys()
    for k in t:
        if isinstance(t[k], np.ndarray):
            assert np.array_equal(t[k], np.asarray(j[k])), k
        else:
            assert t[k] == j[k], k


def test_esm2_embedder_says_what_it_needs():
    from caster_dta_torch.data.featurize import protein as t_protein
    with pytest.raises(NotImplementedError, match="ESM2 weights"):
        t_protein._esm2_embeddings(list("ACD"))
