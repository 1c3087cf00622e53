"""The port's host featurization (caster_dta_torch/data/featurize/**,
native/host.py, data/build.py) against the JAX package's, on the CPU: the same
SMILES and PDB files give the same arrays, bit for bit.

SMILES: the synthetic pool, the chemistry tests' molecules and more written
here (charged atoms, aromatic N/S/O heterocycles, fused, bridged and spiro
ring systems, cubane's five-of-six faces, stereo bonds, explicit H). The ring
sets must come back in networkx's order: the port's own minimum cycle basis
is also held against ``networkx.minimum_cycle_basis`` on random graphs.
Proteins: 8 Davis structures from the smallest to the largest, seeded helix
PDBs and a gzip copy, through the native host library (each package's own
build) and the dense numpy path (``process_pdb``), each against its JAX twin.
"""
import gzip
import os
import random
import shutil

import networkx as nx
import numpy as np
import pytest

from caster_dta_torch.data import build as t_build
from caster_dta_torch.data import synthetic as t_synth
from caster_dta_torch.data.featurize import pdb as t_pdb
from caster_dta_torch.data.featurize import smiles as t_smiles
from caster_dta_torch.data.featurize.chem import mol_from_smiles as t_mol
from caster_dta_torch.data.featurize.chem import perception as t_perception
from caster_dta_torch.native import host as t_host
from caster_dta_tpu.data import build as j_build
from caster_dta_tpu.data import synthetic as j_synth
from caster_dta_tpu.data.featurize import pdb as j_pdb
from caster_dta_tpu.data.featurize import smiles as j_smiles
from caster_dta_tpu.data.featurize.chem import mol_from_smiles as j_mol
from caster_dta_tpu.native import host as j_host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAVIS = os.path.join(REPO, "data", "structures_davis")

# tests/test_chem.py's molecules
CHEM_TEST_SMILES = [
    "CCO", "c1ccccc1", "C1=CC=CC=C1", "C1=CC2=CC=CC=C2C=C1", "c1ccncc1", "c1cc[nH]c1",
    "CC#N", "CC(=O)O", "C[N+](C)(C)C", "[O-]C(=O)C", "F/C=C/F", "F/C=C\\F",
    "N[C@@H](C)C(=O)O", "N[C@H](C)C(=O)O", "C1CC1", "CC(C)(C)C", "C%10CCCCC%10", "CC.O",
    "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "CF",
]
MORE_SMILES = [
    "c1ccsc1",                              # thiophene
    "c1ccoc1",                              # furan
    "c1cnc[nH]1",                           # imidazole
    "c1ccc2[nH]ccc2c1",                     # indole
    "c1ccc2c(c1)oc1ccccc12",                # dibenzofuran (fused, O)
    "c1ccc2c(c1)ccc1ccccc12",               # phenanthrene
    "c1ccc2cc3ccccc3cc2c1",                 # anthracene
    "C1CC2CCC1C2",                          # norbornane (bridged)
    "C1C2CC3CC1CC(C2)C3",                   # adamantane (bridged)
    "C12C3C4C1C5C2C3C45",                   # cubane: 5 of 6 equal faces
    "C1CCC2(CC1)CCCC2",                     # spiro[4.5]decane
    "C1CC11CC1",                            # spiropentane
    "O=C1NC(=O)c2ccccc12",                  # phthalimide
    "[O-][N+](=O)c1ccccc1",                 # nitrobenzene (charges)
    "[NH4+].[Cl-]",                         # ions, explicit H
    "[2H]C([2H])([2H])O",                   # isotopes, explicit H atoms
    "C/C=C/C(=O)O",                         # crotonic acid (E)
    "F/C=C(\\Cl)Br",                        # stereo with branches
    "OC(=O)[C@@H]1CCCN1",                   # proline (chiral ring atom)
    "CC(=O)Nc1ccc(O)cc1",                   # paracetamol
    "c1ccc(cc1)-c1ccccc1",                  # biphenyl
    "Cc1nc2ccccc2s1",                       # 2-methylbenzothiazole (S, N)
    "C[n+]1ccccc1",                         # N-methylpyridinium
    "O=C1C=CC(=O)C=C1",                     # benzoquinone
    "C1CC2CC3CCC2C13",                      # fused tricycle
    "CC(C)C[C@H](NC(=O)[C@@H](Cc1ccccc1)NC(=O)c1cnccn1)B(O)O",   # bortezomib
]
ALL_SMILES = list(dict.fromkeys(j_synth.SMILES_POOL + CHEM_TEST_SMILES + MORE_SMILES))
FEATURE_OPTIONS = [(False, False, True), (True, True, False)]


def _assert_graph_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        elif isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("smiles", ALL_SMILES)
def test_process_smiles_equals_jax(smiles):
    for full_atomtype, one_hot, selfloops in FEATURE_OPTIONS:
        got = t_smiles.process_smiles(smiles, full_atomtype, one_hot, selfloops)
        want = j_smiles.process_smiles(smiles, full_atomtype, one_hot, selfloops)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    tm, jm = t_mol(smiles), j_mol(smiles)
    assert tm.rings == jm.rings
    assert [b.in_ring for b in tm.bonds] == [b.in_ring for b in jm.bonds]
    assert [(a.aromatic, a.hybridization, a.implicit_hs) for a in tm.atoms] == \
        [(a.aromatic, a.hybridization, a.implicit_hs) for a in jm.atoms]
    assert t_smiles.validate_smiles(smiles) and j_smiles.validate_smiles(smiles)
    _assert_graph_equal(t_build.molecule_smiles_to_graph(smiles, False, False, True),
                        j_build.dense_to_graph(*j_smiles.process_smiles(smiles, False, False,
                                                                       True)))


def test_ring_systems_have_their_rings():
    """The bridged and caged systems keep their basis sizes (cubane: 5 of
    its 6 faces; adamantane: 3 rings; norbornane: 2)."""
    sizes = {s: sorted(len(r) for r in t_mol(s).rings)
             for s in ("C12C3C4C1C5C2C3C45", "C1C2CC3CC1CC(C2)C3", "C1CC2CCC1C2")}
    assert sizes == {"C12C3C4C1C5C2C3C45": [4] * 5, "C1C2CC3CC1CC(C2)C3": [6, 6, 6],
                     "C1CC2CCC1C2": [5, 5]}


@pytest.mark.parametrize("bad", ["C1CC", "C(", "Xx", "c1cc", ""])
def test_invalid_smiles_refused_by_both(bad):
    assert not t_smiles.validate_smiles(bad)
    assert not j_smiles.validate_smiles(bad)


def test_cycle_basis_and_bridges_equal_networkx_on_random_graphs():
    """Random graphs, connected or not, sparse to dense: the same cycles in
    the same order with their nodes in the same order, and the same bridges."""
    for trial in range(400):
        rnd = random.Random(trial)
        n = rnd.randint(1, 30)
        g = nx.Graph()
        g.add_nodes_from(range(n))
        adj = {i: {} for i in range(n)}
        for _ in range(rnd.randint(0, 2 * n)):
            u, v = rnd.randrange(n), rnd.randrange(n)
            if u != v:
                g.add_edge(u, v)
                adj[u][v] = adj[v][u] = None
        assert t_perception.minimum_cycle_basis(adj) == nx.minimum_cycle_basis(g), trial
        assert t_perception._bridges(adj) == {frozenset(e) for e in nx.bridges(g)}, trial


def _davis_files():
    names = sorted(os.listdir(DAVIS), key=lambda f: (os.path.getsize(os.path.join(DAVIS, f)), f))
    return [names[round(i * (len(names) - 1) / 7)] for i in range(8)]


PDB_ARGS = ("angstroms", 4, "dist", True, True)
DENSE_MAX_BYTES = 400_000   # the dense n×n path up to ~1,200 residues


@pytest.mark.parametrize("name", _davis_files())
def test_davis_protein_graphs_equal_jax(name):
    path = os.path.join(DAVIS, name)
    want = j_build.protein_graph_fused(path, *PDB_ARGS)
    assert want is not None and j_host.available()
    _assert_graph_equal(t_build.protein_file_to_graph(path, *PDB_ARGS, False, False, True),
                        want)
    if os.path.getsize(path) <= DENSE_MAX_BYTES:
        dense_t = t_pdb.process_pdb(path, *PDB_ARGS)
        dense_j = j_pdb.process_pdb(path, *PDB_ARGS)
        for g, w in zip(dense_t, dense_j):
            for a, b in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple)
                            else (w,)):
                np.testing.assert_array_equal(a, b)
        graph = t_build.protein_file_to_graph(path, *PDB_ARGS, False, False, True, native=False)
        _assert_graph_equal(graph, j_build.dense_to_graph(*dense_j))
        _assert_graph_equal(graph, want)    # the dense path gives the native graph


def test_synthetic_pdbs_byte_identical_and_featurize_alike(tmp_path):
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    for i, n_res in enumerate((12, 37, 90)):
        seq = "".join(np.random.default_rng(i).choice(t_synth._AA, n_res))
        t_path, j_path = str(tmp_path / f"t{i}.pdb"), str(tmp_path / f"j{i}.pdb")
        t_synth.write_pdb(t_path, t_synth.helix_backbone(n_res, rng_t), seq)
        j_synth.write_pdb(j_path, j_synth.helix_backbone(n_res, rng_j), seq)
        with open(t_path, "rb") as a, open(j_path, "rb") as b:
            assert a.read() == b.read()
        for units, thresh, kind, loops, vec in (PDB_ARGS, ("nanometers", 8, "num", False, False),
                                               ("angstroms", 0.3, "prop", False, True)):
            args = (units, thresh, kind, loops, vec)
            _assert_graph_equal(t_build.protein_file_to_graph(t_path, *args, False, False, True),
                                j_build.protein_graph_fused(j_path, *args))
            _assert_graph_equal(
                t_build.protein_file_to_graph(t_path, *args, False, False, True, native=False),
                j_build.dense_to_graph(*j_pdb.process_pdb(j_path, *args)))


def test_gzip_and_mmcif_read_as_the_plain_file(tmp_path):
    src = os.path.join(DAVIS, _davis_files()[0])
    gz = str(tmp_path / "x.pdb.gz")
    with open(src, "rb") as f, gzip.open(gz, "wb") as g:
        shutil.copyfileobj(f, g)
    plain = t_build.protein_file_to_graph(src, *PDB_ARGS, False, False, True)
    _assert_graph_equal(t_build.protein_file_to_graph(gz, *PDB_ARGS, False, False, True), plain)
    _assert_graph_equal(t_build.protein_file_to_graph(gz, *PDB_ARGS, False, False, True),
                        j_build.protein_graph_fused(gz, *PDB_ARGS))
    # a minimal mmCIF atom_site loop of the same backbone
    names, coords, resnames, reskeys = t_pdb.parse_pdb_backbone(src)
    lines = ["data_x", "loop_"] + [f"_atom_site.{c}" for c in (
        "group_PDB", "label_atom_id", "label_comp_id", "auth_asym_id", "auth_seq_id",
        "Cartn_x", "Cartn_y", "Cartn_z", "pdbx_PDB_model_num")]
    for name, xyz, res, key in zip(names, coords, resnames, reskeys):
        lines.append(f"ATOM {name} {res} {key[0]} {key[1]} {xyz[0]:.3f} {xyz[1]:.3f} "
                     f"{xyz[2]:.3f} 1")
    cif = str(tmp_path / "x.cif")
    with open(cif, "w") as f:
        f.write("\n".join(lines) + "\n#\n")
    got = t_pdb.load_backbone_coords(cif)
    want = j_pdb.load_backbone_coords(cif)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_native_sort_and_build_against_numpy():
    dst = np.random.default_rng(0).integers(0, 50, 2000).astype(np.int32)
    np.testing.assert_array_equal(t_host.sort_edges_by_dst(dst),
                                  t_host.sort_edges_by_dst(dst, native=False))
    np.testing.assert_array_equal(t_host.sort_edges_by_dst(dst), j_host.sort_edges_by_dst(dst))
    assert os.path.dirname(t_host.library_path()) == t_host.BUILD_DIR
    assert os.path.isfile(t_host.library_path())


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No silent numpy fallback: a source that does not compile raises."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_host, "SOURCE", str(bad))
    monkeypatch.setattr(t_host, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(t_host, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_host.load_library()


def test_esm2_embeddings_refused():
    """The embedder needs weights the repository does not carry, and says so
    (the block's placement: tests/test_torch_acquire.py, stub embedder)."""
    path = os.path.join(DAVIS, _davis_files()[0])
    with pytest.raises(NotImplementedError, match="ESM2 weights"):
        t_build.protein_file_to_graph(path, "angstroms", 4, "dist", True, True, True, False,
                                      True)
