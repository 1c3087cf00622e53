"""Residue-level node and edge featurization from backbone coordinates.

Behavioral spec: reference utils/create_protein_features.py. The numerics are
reproduced exactly (golden-tested): dihedral sin/cos features from backbone
cross products, orientation and sidechain direction vectors, normalized CRC
amino-acid property scalars, sinusoidal positional encodings, 16 Gaussian
RBFs of CA-pairwise distance over [0, 20], 32-dim signed sequence-offset
encodings, and dist/num/prop edge thresholding with NaN marking of non-edges.

Output is the reference's dense-n²-then-filter form here; data/build.py turns
it into the COO graph dict. A copy of caster_dta_tpu/data/featurize/protein.py
without its ESM2 branch.
"""
from __future__ import annotations

import numpy as np
import scipy.spatial.distance as sp_dist

from caster_dta_torch.data.featurize import definitions as pd_maps


def normalize_vecs(in_vec: np.ndarray, axis=None) -> np.ndarray:
    """Zero-safe vector normalization (reference create_protein_features.py:360-365)."""
    norms = np.linalg.norm(in_vec, axis=axis, keepdims=True)
    return np.divide(in_vec, norms, out=np.zeros_like(in_vec), where=norms != 0)


def calc_pos_encoding(indices: np.ndarray, n_embeds: int = 16) -> np.ndarray:
    """Transformer-style sin/cos encoding of (possibly signed) indices
    (reference create_protein_features.py:368-385)."""
    per_sincos = n_embeds // 2
    enc_freqs = np.exp(2 * np.arange(per_sincos) * -(np.log(10000.0) / per_sincos))
    enc_expand = tuple(np.arange(len(np.shape(indices))))
    idx_freqs = np.expand_dims(indices, -1) * np.expand_dims(enc_freqs, enc_expand)
    return np.concatenate([np.cos(idx_freqs), np.sin(idx_freqs)], axis=-1)


def compute_residue_node_features(res_coords, res_idents, vectorize_features,
                                  add_esm2_embeds=False, add_residue_posenc=False,
                                  include_aa_props=True):
    """Per-residue features (reference create_protein_features.py:12-198).

    res_coords: [n_res, 4, 3] backbone N/CA/C/O; res_idents: int residue types.
    Returns (scalars [n,17], vectors [n,3,3]) when vectorize_features, else the
    concatenated scalar form. Default trained dims: (17, 3).
    """
    res_coords = np.asarray(res_coords, dtype=np.float32)

    # Dihedrals phi/psi/omega from N,CA,C chain (reference :27-66)
    dihedral_coords = res_coords[:, :3, :].reshape(-1, 3)
    shifted = normalize_vecs(dihedral_coords[1:] - dihedral_coords[:-1], axis=-1)
    u0, u1, u2 = shifted[2:], shifted[1:-1], shifted[:-2]
    n1 = normalize_vecs(np.cross(u1, u0, axis=-1), axis=-1)
    n2 = normalize_vecs(np.cross(u2, u1, axis=-1), axis=-1)
    cos_ang = np.clip(np.sum(n1 * n2, axis=-1), -1.0, 1.0)
    angles = np.arccos(cos_ang) * np.sign(np.sum(n1 * u2, axis=-1))
    angles = np.pad(angles, [1, 2], "constant", constant_values=0.0).reshape(-1, 3)
    angle_feats = np.concatenate([np.cos(angles), np.sin(angles)], axis=-1)

    # Orientations: CA forward/backward unit vectors (:69-77)
    alpha = res_coords[:, 1, :]
    forward = normalize_vecs(alpha[1:] - alpha[:-1], axis=-1)
    fwd_feats = np.pad(forward, [(0, 1), (0, 0)], "constant")
    bwd_feats = np.pad(-forward, [(1, 0), (0, 0)], "constant")

    # Sidechain direction: -bisector*sqrt(1/3) - perp*sqrt(2/3) (:80-92)
    n_c = normalize_vecs(res_coords[:, 0, :] - alpha, axis=-1)
    c_c = normalize_vecs(res_coords[:, 2, :] - alpha, axis=-1)
    bisector = normalize_vecs(n_c + c_c, axis=-1)
    perp = normalize_vecs(np.cross(c_c, n_c, axis=-1), axis=-1)
    side_feats = -bisector * np.sqrt(1 / 3) - perp * np.sqrt(2 / 3)

    # CRC amino-acid property scalars (:95-111)
    letters = [pd_maps.PROTEIN_INT_1LETTER_MAP[r] for r in np.asarray(res_idents).tolist()]
    if include_aa_props:
        aa_feats = np.asarray([[d[r] for d in pd_maps.AA_PROPERTY_DICTS]
                               for r in letters], dtype=np.float32)
    else:
        aa_feats = np.empty((len(letters), 0), dtype=np.float32)

    n_res = len(letters)
    if add_residue_posenc:
        pos_feats = calc_pos_encoding(np.arange(n_res), n_embeds=8)
    else:
        pos_feats = np.empty((n_res, 0), dtype=np.float32)

    if add_esm2_embeds:
        esm_feats = _esm2_embeddings(letters)
    else:
        esm_feats = np.empty((n_res, 0), dtype=np.float32)

    if vectorize_features:
        scalars = np.concatenate([angle_feats, aa_feats, pos_feats, esm_feats], axis=-1)
        vectors = np.stack([fwd_feats, bwd_feats, side_feats], axis=1)
        return scalars.astype(np.float32), vectors.astype(np.float32)
    return np.concatenate([angle_feats, aa_feats, pos_feats, esm_feats,
                           fwd_feats, bwd_feats, side_feats], axis=-1).astype(np.float32)


def _esm2_embeddings(letters):
    """ESM2-t6-8M residue embeddings (reference :131-158). The block's place
    in the residue features is the JAX package's (above); the embedder itself
    needs the facebook/esm2_t6_8M_UR50D weights and the ``transformers``
    package, neither of which this repository carries."""
    raise NotImplementedError(
        "protein_include_esm2=True needs the ESM2 weights (facebook/esm2_t6_8M_UR50D) "
        "and the transformers package to embed residues; this repository carries "
        "neither, so the port has no ESM2 embedder")


def compute_residue_edge_features(res_coords, res_idents, edge_thresh,
                                  thresh_type, keep_self_loops,
                                  vectorize_features):
    """Dense n×n edge features with NaN non-edges
    (reference create_protein_features.py:201-357).

    Scalars: 16 RBFs of CA distance + 32-dim signed-offset posenc; vectors:
    unit CA->CA direction. Thresholding by 'dist' (<= thresh), 'num' (kNN) or
    'prop' (ceil(frac*n) nearest).
    """
    res_coords = np.asarray(res_coords, dtype=np.float32)
    alpha = res_coords[:, 1, :]
    n_res = len(np.asarray(res_idents))

    dist = sp_dist.squareform(sp_dist.pdist(alpha))
    dist = np.expand_dims(dist, -1)

    d_min, d_max, d_count = 0.0, 20.0, 16
    d_step = (d_max - d_min) / d_count
    d_mu = np.linspace(d_min, d_max, d_count).reshape(1, 1, -1)
    rbf = np.exp(-np.square((dist - d_mu) / d_step))

    dirs = normalize_vecs(alpha[:, np.newaxis] - alpha[np.newaxis, :], axis=-1)

    inds = np.arange(n_res)
    ind_diffs = inds[np.newaxis, :] - inds[:, np.newaxis]
    posenc = calc_pos_encoding(ind_diffs, n_embeds=16)

    feats = np.concatenate([rbf, posenc, dirs], axis=-1)

    if not keep_self_loops:
        feats[inds, inds, :] = np.nan
        dist[inds, inds, :] = np.nan

    if edge_thresh is not None:
        if thresh_type == "dist":
            mask = (dist <= edge_thresh).astype(np.float32)
            mask[mask == 0] = np.nan
            feats = feats * mask
        else:
            if thresh_type == "prop":
                n_edges = int(np.ceil(edge_thresh * n_res))
            elif thresh_type == "num":
                n_edges = int(edge_thresh)
            else:
                raise ValueError(f"unknown thresh_type {thresh_type!r}")
            nearest = np.argsort(dist.squeeze(-1), axis=-1)[:, :n_edges]
            masked = np.full_like(feats, np.nan)
            for i in range(n_res):
                masked[i, nearest[i], :] = feats[i, nearest[i], :]
            feats = masked

    if vectorize_features:
        scalars = feats[:, :, :-3]
        vectors = np.expand_dims(feats[:, :, -3:], axis=-2)
        return scalars.astype(np.float32), vectors.astype(np.float32)
    return feats.astype(np.float32)
