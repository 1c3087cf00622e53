"""Featurizer output -> graph dicts (counterpart of
caster_dta_tpu/data/build.py).

The featurizers (featurize/pdb.py, featurize/smiles.py) emit the reference's
dense n×n NaN-marked edge form (utils/create_graphs.py:6-62 consumed this to
build ragged PyG COO graphs). Here the dense form is converted once, at
preprocessing time, into the unpadded COO dict that data/graphs.py pads into
static buckets, the graph dict that ``PairDataset``, ``BucketedLoader`` and
``DeviceResidentLoader`` take. Proteins take the native fused path
(``protein_graph_fused``) unless a caller asks for the dense numpy one.
"""
from __future__ import annotations

import numpy as np

from caster_dta_torch.data.featurize import definitions as protein_maps
from caster_dta_torch.data.featurize import pdb as pdb_feat
from caster_dta_torch.data.featurize import smiles as smiles_feat
from caster_dta_torch.data.featurize.protein import compute_residue_node_features
from caster_dta_torch.native import host


def dense_to_graph(node_features, edge_features, ntypes, etypes) -> dict:
    """Dense features -> unpadded graph dict (reference create_graphs.py:6-62:
    full edge_index with all-NaN edges dropped).

    node_features: array or (s, V) tuple; edge_features: [n, n, f] or tuple
    ([n,n,fs], [n,n,1,3]); etypes: [n, n].
    Returns dict(node_s, node_v, edge_index[2,E], edge_s, edge_v, node_type,
    edge_type, n_nodes, n_edges).
    """
    if isinstance(node_features, tuple):
        node_s, node_v = node_features
    else:
        node_s, node_v = node_features, None
    node_s = np.asarray(node_s, np.float32)
    n = node_s.shape[0]

    if isinstance(edge_features, tuple):
        edge_s_dense, edge_v_dense = edge_features
        nan_checker = edge_s_dense
    else:
        edge_s_dense, edge_v_dense = edge_features, None
        nan_checker = edge_features

    keep = ~np.isnan(np.asarray(nan_checker)).all(axis=-1)   # [n, n]
    src, dst = np.nonzero(keep)
    edge_s = np.asarray(edge_s_dense, np.float32)[src, dst]
    edge_v = None if edge_v_dense is None else np.asarray(edge_v_dense, np.float32)[src, dst]
    etypes = np.asarray(etypes)
    edge_type = etypes[src, dst] if etypes.ndim == 2 else etypes.reshape(-1)[src * n + dst]

    return {
        "node_s": node_s,
        "node_v": None if node_v is None else np.asarray(node_v, np.float32),
        "edge_index": np.stack([src, dst]).astype(np.int32),
        "edge_s": edge_s,
        "edge_v": edge_v,
        "node_type": np.asarray(ntypes).reshape(-1).astype(np.int32),
        "edge_type": np.nan_to_num(edge_type).astype(np.int32),
        "n_nodes": int(n),
        "n_edges": int(len(src)),
    }


def graph_feature_shapes(g: dict):
    """(scalar_dim, vector_channels) feature metadata for model construction
    (mirrors dual_dataset.py:269-313 metadata semantics)."""
    ds = g["node_s"].shape[1]
    dv = 0 if g["node_v"] is None else g["node_v"].shape[1]
    es = g["edge_s"].shape[1]
    ev = 0 if g["edge_v"] is None else g["edge_v"].shape[1]
    return (ds, dv), (es, ev)


def protein_graph_fused(pdb_file, dist_units, edge_thresh, thresh_type,
                        keep_self_loops, vectorize_features,
                        add_esm2_embeds=False, add_residue_posenc=False,
                        include_aa_props=True):
    """PDB -> graph dict via the native fused edge kernel (csrc/), skipping
    the reference's dense n*n edge tensors entirely.

    Node features (O(n)) stay in numpy; edge thresholding + featurization run
    in C++ emitting COO directly. The library is built at first use; a failed
    build raises.
    """
    res_coords, res_names = pdb_feat.load_backbone_coords(pdb_file)
    if dist_units == "angstroms":
        res_coords = res_coords * 10
    elif dist_units != "nanometers":
        raise ValueError(f"Distance units {dist_units!r} not recognized. "
                         "Must be 'angstroms' or 'nanometers'")
    res_1letter = [protein_maps.PROTEIN_3LETTER_1LETTER_MAP[r] for r in res_names]
    res_idents = [protein_maps.PROTEIN_1LETTER_INT_MAP[r] for r in res_1letter]
    n = res_coords.shape[0]

    nf = compute_residue_node_features(
        res_coords, res_idents, vectorize_features, add_esm2_embeds,
        add_residue_posenc, include_aa_props)
    src, dst, edge_s, edge_v = host.protein_edges(
        res_coords[:, 1, :], edge_thresh if edge_thresh is not None else np.inf,
        thresh_type if edge_thresh is not None else "dist", keep_self_loops)

    if vectorize_features:
        node_s, node_v = nf
    else:
        node_s, node_v = nf, None
        edge_s = np.concatenate([edge_s, edge_v.reshape(-1, 3)], axis=-1)
        edge_v = None

    return {
        "node_s": np.asarray(node_s, np.float32),
        "node_v": None if node_v is None else np.asarray(node_v, np.float32),
        "edge_index": np.stack([src, dst]).astype(np.int32),
        "edge_s": edge_s,
        "edge_v": edge_v,
        "node_type": np.asarray(res_idents, np.int32),
        "edge_type": np.zeros(len(src), np.int32),
        "n_nodes": int(n),
        "n_edges": int(len(src)),
    }


def protein_file_to_graph(protein_file, dist_units, edge_thresh, thresh_type,
                          keep_self_loops, vectorize_features, add_esm2_embeds,
                          add_residue_posenc, include_aa_props, native: bool = True):
    """PDB -> graph dict: the native fused path, or with ``native=False`` the
    dense numpy path (``process_pdb`` + ``dense_to_graph``), which gives the
    same graph."""
    if native:
        return protein_graph_fused(
            protein_file, dist_units, edge_thresh, thresh_type, keep_self_loops,
            vectorize_features, add_esm2_embeds, add_residue_posenc, include_aa_props)
    nf, ef, nt, et = pdb_feat.process_pdb(
        protein_file, dist_units, edge_thresh, thresh_type, keep_self_loops,
        vectorize_features, add_esm2_embeds, add_residue_posenc, include_aa_props)
    return dense_to_graph(nf, ef, nt, et)


def molecule_smiles_to_graph(smiles, molecule_full_atomtype,
                             molecule_onehot_ordinal_feats,
                             molecule_include_selfloops):
    """SMILES -> graph dict."""
    nf, ef, nt, et = smiles_feat.process_smiles(
        smiles, molecule_full_atomtype, molecule_onehot_ordinal_feats,
        molecule_include_selfloops)
    return dense_to_graph(nf, ef, nt, et)
