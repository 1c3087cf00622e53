"""The analyses' input layers in the port against the JAX package's, on the
CPU, with no network (HTTP answers are canned through each package's seams):

- ``load_drugbank`` on a small DrugBank XML and on a ZIP of it, column by
  column against JAX's DataFrame; ``drugs_from_drugbank``;
- ``variant_to_protein_seq`` from canned Ensembl and Mutalyzer answers, the
  caches it writes byte for byte JAX's, and from the full caches with every
  HTTP seam made to fail;
- ``acquire_pdbs`` (a path spelled another way counts as missing) and
  ``get_af2_from_uniprot_accession`` (local ``.pdb.gz``, sequence offsets,
  ``_failed.txt`` flags, the API off and on) against JAX's rows and files;
- ``_mol_layout`` against networkx's layout in JAX's within 1e-6;
- the common filters on the trained model's kwargs, the ``NA`` ligand and
  fragment SMILES included, and ``load_biolip_tables`` against pandas'
  reading of the same tables;
- the drawing functions write their PNGs (matplotlib is here).
"""
import gzip
import json
import os
import shutil
import zipfile

import numpy as np
import pandas as pd
import pytest

import chip_smoke
from caster_dta_torch.analysis import biolip as t_biolip
from caster_dta_torch.analysis import common as t_common
from caster_dta_torch.data import acquire as t_acquire
from caster_dta_torch.data import synthetic as t_synth
from caster_dta_torch.data import tables
from caster_dta_torch.inference import structures as t_structures
from caster_dta_torch.inference import variant_to_protein as t_v2p
from caster_dta_torch.inference import visualization as t_viz
from caster_dta_torch.inference.load_drugbank import load_drugbank
from caster_dta_tpu.analysis import biolip as j_biolip
from caster_dta_tpu.analysis import common as j_common
from caster_dta_tpu.data import acquire as j_acquire
from caster_dta_tpu.inference import structures as j_structures
from caster_dta_tpu.inference import variant_to_protein as j_v2p
from caster_dta_tpu.inference import visualization as j_viz
from caster_dta_tpu.inference.load_drugbank import load_drugbank as j_load_drugbank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "runs", "davis_seed9")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return chip_smoke.analysis_inputs(str(tmp_path_factory.mktemp("inputs")),
                                      residues=(20, 60))


def _assert_same(records: dict, df: pd.DataFrame, path_map=None):
    assert list(records) == list(df.columns)
    for c in df.columns:
        want = df[c].tolist()
        if path_map:
            want = [x.replace(*path_map) if isinstance(x, str) else x for x in want]
        got = records[c]
        assert len(got) == len(want), c
        for g, w in zip(got, want):
            if isinstance(w, float) and np.isnan(w):
                assert tables.is_na(g), c
            else:
                assert g == w, (c, g, w)


# ------------------------------------------------------------------ DrugBank

def test_load_drugbank_xml_and_zip_match_jax(inputs, tmp_path):
    xml = inputs["binders"]["drugbank_file"]
    zpath = str(tmp_path / "drugbank.zip")
    with zipfile.ZipFile(zpath, "w") as z:
        z.writestr("readme.txt", "not the database")
        z.write(xml, "full database.xml")
    for path in (xml, zpath):
        rec, df = load_drugbank(path), j_load_drugbank(path)
        _assert_same(rec, df)
    assert rec["smiles"][-1] == ["CCO", "CCN"] and rec["smiles"][-2] == ""
    assert rec["target_sequence"][0] == ["MKVLAWFQRD"]    # FASTA header dropped
    assert rec["target_id"][0] == ["P00001"]               # the mouse target left out
    assert "antibody" not in rec["name"]
    with zipfile.ZipFile(str(tmp_path / "empty.zip"), "w") as z:
        z.writestr("readme.txt", "x")
    with pytest.raises(ValueError, match="No XML"):
        load_drugbank(str(tmp_path / "empty.zip"))


def test_drugs_from_drugbank_matches_jax(inputs):
    from caster_dta_torch.analysis.binders import drugs_from_drugbank
    from caster_dta_tpu.analysis.binders import drugs_from_drugbank as j_drugs
    xml = inputs["binders"]["drugbank_file"]
    for approved in (True, False):
        got, want = drugs_from_drugbank(xml, approved), j_drugs(xml, approved)
        assert got == want and list(got) == list(want)
    assert len(drugs_from_drugbank(xml)) == 16
    assert "withdrawn" not in drugs_from_drugbank(xml)
    assert "experimental" in drugs_from_drugbank(xml, only_approved=False)


# ------------------------------------------------------------------ variants

ENSEMBL = [
    {"T": {"hgvsp": ["NP_000002.2:p.Val174Ala", "ENSP0001:p.Val174Ala",
                     "NP_000001.1:p.Val174Ala"], "id": ["rs5"]},
     "warnings": ["a string, not an allele"]},
    {"C": {"hgvsp": ["NP_000003.1:p.Gly3Arg"]}, "G": {"hgvsp": []}},
]
SEQS = {"NP_000001.1": "MKVLAWFQRD*TAIL", "NP_000002.2": "MKVLAW",
        "NP_000003.1": "MGGSS", "NP_000002.2:p.Val174Ala": "MKALAW*",
        "NP_000001.1:p.Val174Ala": "MKALAWFQRD", "NP_000003.1:p.Gly3Arg": "MGRSS*X"}


def _mutalyzer(hgvs):
    return {"sequence": {"seq": SEQS[hgvs.replace(":p.=", "")]}}


def test_variant_to_protein_from_canned_answers_matches_jax(monkeypatch, tmp_path):
    import requests

    class Answer:
        def __init__(self, payload):
            self.payload = payload

        def json(self):
            return self.payload

        def raise_for_status(self):
            pass

    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(requests, "post", lambda url, **kw: calls["jax"].append(
        ("post", url, json.loads(kw["data"]))) or Answer(ENSEMBL))
    monkeypatch.setattr(requests, "get", lambda url, **kw: calls["jax"].append(
        ("get", url)) or Answer(_mutalyzer(url.rsplit("/", 1)[1])))
    monkeypatch.setattr(t_v2p, "_post_json", lambda url, payload, timeout=120: calls[
        "torch"].append(("post", url, payload)) or ENSEMBL)
    monkeypatch.setattr(t_v2p, "_get_json", lambda url, timeout=120: calls["torch"].append(
        ("get", url)) or _mutalyzer(url.rsplit("/", 1)[1]))
    var = {"DRUGA_var": "rs5", "DRUGB_var": "rs7", "DRUGB_again": "rs7"}
    t = t_v2p.variant_to_protein_seq(var, str(tmp_path / "torch"))
    j = j_v2p.variant_to_protein_seq(var, str(tmp_path / "jax"))
    assert t == j and list(t[0]) == list(j[0]) and list(t[1]) == list(j[1])
    assert calls["torch"] == calls["jax"]
    assert t[1]["NP_000001.1"] == "MKVLAWFQRD"            # trimmed at '*'
    for sub in ("variants", "sequences"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert sorted(os.listdir(tmp_path / "torch" / sub)) == names
        for n in names:
            assert (tmp_path / "torch" / sub / n).read_bytes() == \
                (tmp_path / "jax" / sub / n).read_bytes(), n

    # the full caches answer everything: no request, no HTTP package needed
    def refuse(*a, **k):
        raise AssertionError("an HTTP call with full caches")
    for mod, names in ((t_v2p, ("_post_json", "_get_json")), (requests, ("post", "get"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    again = t_v2p.variant_to_protein_seq(var, str(tmp_path / "torch"))
    assert again == j_v2p.variant_to_protein_seq(var, str(tmp_path / "jax")) == t


# ---------------------------------------------------------------- structures

def _helix(path, seq, seed=0):
    t_synth.write_pdb(path, t_synth.helix_backbone(len(seq), np.random.default_rng(seed)), seq)


def test_acquire_pdbs_matches_jax(monkeypatch, tmp_path):
    """Present files pass, a missing one is searched (no hit) and folded by a
    stand-in, a path spelled with ``./`` counts as missing as in JAX."""
    folded = {}
    for side, acq, st in (("torch", t_acquire, t_structures), ("jax", j_acquire, j_structures)):
        monkeypatch.setattr(acq, "_http_post_json", lambda *a, **k: {})
        folded[side] = []

        def fold(ids, seqs, files, verbose_comp_fold=False, side=side):
            ids, files = list(ids), list(files)
            folded[side].append(ids)
            for i, f in zip(ids, files):
                if i == "p3":
                    _helix(f, "MKVLAW")
        monkeypatch.setattr(st, "create_comp_models", fold)
        d = tmp_path / side
        d.mkdir()
        _helix(str(d / "p1.pdb"), "ACDEFG")
        _helix(str(d / "p2.pdb"), "ACDEFG")
        prot = {"id": ["p1", "p2", "p3", "p4"], "seq": ["ACDEFG", "ACDEFG", "MKVLAW", "GGG"],
                "file": [str(d / "p1.pdb"), os.path.join(str(d), ".", "p2.pdb"),
                         str(d / "p3.pdb"), str(d / "p4.pdb")]}
        if side == "torch":
            got = st.acquire_pdbs(prot, str(d))
            with pytest.raises(ValueError, match="require_completeness"):
                st.acquire_pdbs(prot, str(d), do_comp_folds=False, require_completeness=True)
        else:
            want = st.acquire_pdbs(pd.DataFrame(prot), str(d))
    _assert_same(got, want.reset_index(drop=True), (str(tmp_path / "jax"),
                                                    str(tmp_path / "torch")))
    assert got["id"] == ["p1", "p2", "p3"]
    assert folded["torch"] == folded["jax"] == [["p2", "p3", "p4"]]


def test_af2_by_uniprot_accession_matches_jax(monkeypatch, tmp_path):
    """Local AF files (the requested sequence from an offset, a sequence not
    in the file), an existing structure, an existing failed flag, the API
    off (no flag) and on (canned answers, one empty)."""
    import requests
    full = "MKVLAWFQRDACDEFGHIKL"
    pre = tmp_path / "pre"
    pre.mkdir()
    for acc, seq in (("A1", full), ("A2", full)):
        raw = str(tmp_path / f"{acc}.pdb")
        _helix(raw, seq)
        with open(raw, "rb") as f_in, gzip.open(str(pre / f"AF-{acc}-F1-model_v4.pdb.gz"),
                                                 "wb") as f_out:
            shutil.copyfileobj(f_in, f_out)
    api_pdb = str(tmp_path / "api.pdb")
    _helix(api_pdb, full)
    api_text = open(api_pdb, "rb").read()

    class Answer:
        def __init__(self, status, payload=None, content=b""):
            self.status_code, self.payload, self.content = status, payload, content

        def json(self):
            return self.payload

    def jax_get(url, timeout=10):
        if url.endswith("A5"):
            return Answer(200, [{"pdbUrl": "https://af.example/A5.pdb"}])
        if url.endswith("A6"):
            return Answer(404)
        return Answer(200, content=api_text)

    def port_get(url, timeout=10):
        a = jax_get(url)
        return a.status_code, json.dumps(a.payload).encode() if a.payload else a.content

    monkeypatch.setattr(requests, "get", jax_get)
    monkeypatch.setattr(t_structures, "_get", port_get)
    rows = {}
    for side in ("torch", "jax"):
        d = tmp_path / side
        d.mkdir()
        _helix(str(d / "A3.pdb"), "GGGG")
        (d / "A4_failed.txt").write_text("earlier failure")
        df = {"id": ["A1", "A2", "A3", "A4", "A5", "A6", "A7"],
              "seq": [full[5:], "WWWW", "GGGG", "X", full[3:], "MK", "MK"],
              "file": [str(d / f"A{k}.pdb") for k in range(1, 8)]}
        for do_api in (False, True):
            if side == "torch":
                rows[side, do_api] = t_structures.get_af2_from_uniprot_accession(
                    df, local_predownload=str(pre), do_api=do_api)
            else:
                rows[side, do_api] = j_structures.get_af2_from_uniprot_accession(
                    pd.DataFrame(df), local_predownload=str(pre), do_api=do_api)
    for do_api in (False, True):
        _assert_same(rows["torch", do_api], rows["jax", do_api].reset_index(drop=True),
                     (str(tmp_path / "jax"), str(tmp_path / "torch")))
    assert rows["torch", True]["id"] == ["A1", "A3", "A5"]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names
    assert "A7_failed.txt" in names and "A2_failed.txt" in names
    for n in names:
        assert (tmp_path / "torch" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    seq, _ = t_structures._pdb_sequence_and_residue_keys(open(tmp_path / "torch" / "A1.pdb").read())
    assert seq == full[5:]


def test_pdb_sequence_and_subset_match_jax(tmp_path):
    path = str(tmp_path / "h.pdb")
    _helix(path, "MKVLAWFQRDACDEFG")
    text = open(path).read()
    het = "HETATM 9999  CA  MSE B   1       1.000   1.000   1.000  1.00  0.00           C"
    text = text.replace("END\n", f"{het}\n{'TER    9999      MSE B   1':<80}\nEND\n")
    t = t_structures._pdb_sequence_and_residue_keys(text)
    assert t == j_structures._pdb_sequence_and_residue_keys(text)
    keep = set(t[1][4:])
    assert t_structures._subset_pdb_from_residue(text, keep) == \
        j_structures._subset_pdb_from_residue(text, keep)


# -------------------------------------------------------------------- layout

LAYOUT_SMILES = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "C12C3C4C1C5C2C3C45", "CC.O",
                 "[Na+]", "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "C1CC2CCC1C2",
                 "CCN(CC)CCNC(=O)c1ccc(N)cc1"]


@pytest.mark.parametrize("smiles", LAYOUT_SMILES)
def test_mol_layout_matches_networkx_in_jax(smiles):
    from caster_dta_torch.data.featurize.chem import mol_from_smiles as t_mol
    from caster_dta_tpu.data.featurize.chem import mol_from_smiles as j_mol
    got, want = t_viz._mol_layout(t_mol(smiles)), j_viz._mol_layout(j_mol(smiles))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------------- filters

FILTER_SMILES = ["CCO", "CC.O", "[Na+]", "[Se]CC", "C[Si](C)(C)C", "not a smiles", "",
                 "c1ccccc1", "C#N", "[Na+].[Cl-]", "OC(=O)CCc1ccccc1"]
FILTER_SEQS = ["ACDEFG", "ACDXEF", "ACDBEF", "MKV"]


def test_vocab_filters_on_the_trained_kwargs_match_jax():
    with open(os.path.join(RUN, "model_kwargs.json")) as f:
        kwargs = json.load(f)
    prot = {"id": [f"p{k}" for k in range(len(FILTER_SEQS))], "seq": FILTER_SEQS}
    drug = {"id": [f"d{k}" for k in range(len(FILTER_SMILES))], "smiles": FILTER_SMILES}
    for pk_types in (kwargs["protein_gnn_kwargs"]["num_ntypes"], 20):
        kw = json.loads(json.dumps(kwargs))
        kw["protein_gnn_kwargs"]["num_ntypes"] = pk_types
        tp, td = t_common.apply_vocab_sanity_filters(prot, drug, kw)
        jp, jd = j_common.apply_vocab_sanity_filters(pd.DataFrame(prot), pd.DataFrame(drug), kw)
        _assert_same(tp, jp)
        _assert_same(td, jd)
    assert "[Na+]" not in td["smiles"] and "[Se]CC" not in td["smiles"]
    for s in FILTER_SMILES:
        for allow in (False, True):
            assert t_common.validate_smiles_strict(s, allow) == \
                j_common.validate_smiles_strict(s, allow), s
        assert t_common.has_unknown_atom(s) == j_common.has_unknown_atom(s), s
        assert t_common.has_unknown_bond(s) == j_common.has_unknown_bond(s), s
    for s in FILTER_SEQS:
        assert t_common.has_unknown_residue(s) == j_common.has_unknown_residue(s)


def test_sequence_from_pdb_matches_jax(tmp_path):
    path = str(tmp_path / "h.pdb")
    _helix(path, "MKVLAWFQRDACDEFGHIKLNPSTY")
    assert t_common.sequence_from_pdb(path) == j_common.sequence_from_pdb(path)


def test_biolip_tables_read_as_pandas_reads_them(inputs):
    """The NA ligand (sodium) becomes NaN, the first of two SMILES is kept,
    the fragment, the empty SMILES and the over-long row go; integer-looking
    and missing cells typed as pandas types them."""
    b = inputs["biolip"]
    tp, tl = t_biolip.load_biolip_tables(b["biolip_file"], b["biolip_ligand_file"])
    jp, jl = j_biolip.load_biolip_tables(b["biolip_file"], b["biolip_ligand_file"])
    _assert_same(tp, jp.reset_index(drop=True))
    _assert_same(tl, jl.reset_index(drop=True))
    assert tables.is_na(tl["id"][-1]) and tl["smiles"][-1] == "[Na+]"
    assert sum(tables.is_na(c) for c in tp["#CCD"]) == 2


def test_read_csv_types_and_bad_lines_as_pandas(tmp_path):
    p = tmp_path / "t.tsv.gz"
    text = ("#CCD\tSMILES\tname\tn\tf\nNA\t[Na+]\t10074640\t1\t\n"
            "010\tCCO\t10113978\t2\t2.5\nNULL\tC; CC\tNone\t3\t-inf\n"
            "X\tY\tZ\t4\t5\textra\n\nnan\tN/A\t7\t\t1e5\n")
    with gzip.open(p, "wt") as f:
        f.write(text)
    got = tables.read_csv(str(p), sep="\t", on_bad_lines="skip")
    want = pd.read_csv(p, sep="\t", compression="infer", on_bad_lines="skip")
    _assert_same(got, want)
    for c in want.columns:
        kinds = {type(v).__name__ for v in got[c]}
        assert kinds <= ({"int"} if want[c].dtype.kind == "i" else
                         {"float"} if want[c].dtype.kind == "f" else {"str", "float"}), c


# ------------------------------------------------------------------- drawing

def test_drawings_write_pngs(tmp_path):
    path = str(tmp_path / "h.pdb")
    _helix(path, "MKVLAWFQRDACDEFG")
    attn = np.linspace(0, 1, 16, dtype=np.float32)
    outs = [t_viz.draw_mol_with_attn("CC(=O)Oc1ccccc1C(=O)O", np.arange(13, dtype=np.float32),
                                     str(tmp_path / "m.png")),
            t_viz.draw_protein_with_attn(path, attn, str(tmp_path / "p.png")),
            t_viz.draw_protein_difference(path, path, attn, attn[::-1], str(tmp_path / "d.png"))]
    for o in outs:
        assert open(o, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
