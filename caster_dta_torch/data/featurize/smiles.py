"""SMILES -> atom graph featurization.

Behavioral spec: reference utils/smiles_utils.py:12-63 and
utils/create_smiles_features.py:7-111, re-implemented on the in-tree chem
module (no RDKit dependency). Identical feature layout: 41 atom scalars
(with Gasteiger), 9 bond features, node types from atomic number, bond types
single/double/triple/aromatic with optional self-loop type 0 (+1 offset).
"""
from __future__ import annotations

import numpy as np

from caster_dta_torch.data.featurize import definitions as smiles_maps
from caster_dta_torch.data.featurize.chem import mol_from_smiles
from caster_dta_torch.data.featurize.chem.gasteiger import compute_gasteiger_charges


def compute_atom_node_features(mol, one_hot_ordinal_feats,
                               include_gasteiger_charges=True) -> np.ndarray:
    """Per-atom features (reference create_smiles_features.py:7-71):
    one-hot chirality(3)/hybridization(7)/numH(6)/degree(12)/implicit
    valence(8) + formal charge & radicals (ordinal or one-hot) + in-ring +
    aromatic + optional Gasteiger charge. 41 features in the trained config."""
    node_features = []
    for atom in mol.GetAtoms():
        feats = []
        feats.extend(smiles_maps.SMILES_CHIRALITY_MAP[str(atom.GetChiralTag())])
        feats.extend(smiles_maps.SMILES_HYBRID_MAP[str(atom.GetHybridization())])
        feats.extend(smiles_maps.SMILES_H_MAP[atom.GetTotalNumHs()])
        feats.extend(smiles_maps.SMILES_DEGREE_MAP[atom.GetDegree()])
        feats.extend(smiles_maps.SMILES_VALENCE_MAP[atom.GetImplicitValence()])
        if one_hot_ordinal_feats:
            feats.extend(smiles_maps.SMILES_CHARGE_MAP[atom.GetFormalCharge()])
            feats.extend(smiles_maps.SMILES_RADICAL_MAP[atom.GetNumRadicalElectrons()])
        else:
            feats.append(atom.GetFormalCharge())
            feats.append(atom.GetNumRadicalElectrons())
        feats.append(int(atom.IsInRing()))
        feats.append(int(atom.GetIsAromatic()))
        if include_gasteiger_charges:
            g = atom.gasteiger_charge
            if not np.isfinite(g):
                g = 0.0
            feats.append(g)
        node_features.append(feats)
    return np.asarray(node_features, dtype=np.float32)


def compute_bond_edge_features(mol, include_selfloops=False) -> np.ndarray:
    """Dense n×n bond features with NaN non-edges
    (reference create_smiles_features.py:74-111): one-hot stereo(7) +
    conjugated + in-ring; all-zero self-loops if requested."""
    n_atoms = mol.GetNumAtoms()
    edge_features = np.full((n_atoms, n_atoms, 9), np.nan)
    for bond in mol.GetBonds():
        feats = list(smiles_maps.SMILES_STEREO_MAP[str(bond.GetStereo())])
        feats.append(int(bond.GetIsConjugated()))
        feats.append(int(bond.IsInRing()))
        feats = np.asarray(feats, dtype=np.float32)
        edge_features[bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()] = feats
        edge_features[bond.GetEndAtomIdx(), bond.GetBeginAtomIdx()] = feats
    if include_selfloops:
        for i in range(n_atoms):
            edge_features[i, i] = np.zeros(9)
    return edge_features


def process_smiles(smiles_str: str, molecule_full_atomtype: bool,
                   one_hot_ordinal_feats: bool, molecule_include_selfloops: bool,
                   include_gasteiger_charges: bool = True):
    """SMILES -> (node_features, dense edge_features, node_types, edge_types)
    (reference smiles_utils.py:12-63)."""
    mol = mol_from_smiles(smiles_str)
    if include_gasteiger_charges:
        compute_gasteiger_charges(mol)

    node_features = compute_atom_node_features(mol, one_hot_ordinal_feats,
                                               include_gasteiger_charges)
    map_dict = (smiles_maps.ALL_ATOMICNUM_TO_NTYPE if molecule_full_atomtype
                else smiles_maps.SELECT_ATOMICNUM_TO_NTYPE)
    node_types = [map_dict[a.GetAtomicNum()] for a in mol.GetAtoms()]

    edge_features = compute_bond_edge_features(
        mol, include_selfloops=molecule_include_selfloops)
    edge_types = np.full_like(edge_features[:, :, -1], np.nan)
    offset = 1 if molecule_include_selfloops else 0
    if molecule_include_selfloops:
        for i in range(mol.GetNumAtoms()):
            edge_types[i, i] = 0
    for bond in mol.GetBonds():
        start, end = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        bt = smiles_maps.SMILES_BOND_MAP[str(bond.GetBondType())] + offset
        edge_types[start, end] = bt
        edge_types[end, start] = bt
    return node_features, edge_features, node_types, edge_types


def validate_smiles(smiles: str) -> bool:
    """Parse check (reference load_data.py:19-26)."""
    try:
        mol_from_smiles(smiles)
        return True
    except Exception:
        return False
