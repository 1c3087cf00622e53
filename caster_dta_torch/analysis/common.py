"""Shared pieces of the downstream tasks: model-vocabulary sanity filters
and sequence extraction (counterpart of caster_dta_tpu/analysis/common.py).

Behavioral spec: reference test_biolip_binding.py:145-196 and
test_protein_binders.py:250-301: when a model was trained without the
"unknown" residue/atom/bond classes, drop inputs that would need them.
Tables are records (data/tables.py).
"""
from __future__ import annotations

from caster_dta_torch.data import tables
from caster_dta_torch.data.featurize import definitions as defs
from caster_dta_torch.data.featurize.chem import mol_from_smiles


def _n_components(n: int, edges) -> int:
    """Connected components of the graph on nodes 0..n-1 (union-find)."""
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    count = n
    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
            count -= 1
    return count


def validate_smiles_strict(smiles: str, allow_fragments: bool = False) -> bool:
    """Parse + optional single-fragment requirement
    (reference test_biolip_binding.py:65-79)."""
    try:
        mol = mol_from_smiles(smiles)
    except Exception:
        return False
    if allow_fragments:
        return True
    return _n_components(mol.GetNumAtoms(), ((b.a1, b.a2) for b in mol.bonds)) == 1


def has_unknown_residue(seq: str) -> bool:
    unk = defs.PROTEIN_1LETTER_INT_MAP["X"]
    return any(defs.PROTEIN_1LETTER_INT_MAP.get(c, unk) == unk for c in seq)


def has_unknown_atom(smiles: str) -> bool:
    try:
        mol = mol_from_smiles(smiles)
    except Exception:
        return True
    keep = set(defs.SELECT_ATOMICNUMS_TO_KEEP)
    return any(a.GetAtomicNum() not in keep for a in mol.GetAtoms())


def has_unknown_bond(smiles: str) -> bool:
    try:
        mol = mol_from_smiles(smiles)
    except Exception:
        return True
    return any(str(b.GetBondType()) not in defs.SMILES_BOND_MAP
               for b in mol.GetBonds())


def apply_vocab_sanity_filters(prot_df: dict, drug_df: dict, model_kwargs: dict,
                               seq_col="seq", smiles_col="smiles"):
    """Drop proteins/drugs whose types the trained model has no embedding for
    (reference test_biolip_binding.py:140-196)."""
    pk = model_kwargs["protein_gnn_kwargs"]
    mk = model_kwargs["molecule_gnn_kwargs"]
    if pk["num_ntypes"] == defs.PROTEIN_1LETTER_INT_MAP["X"]:
        prot_df = tables.where(prot_df, [not has_unknown_residue(s)
                                         for s in prot_df[seq_col]])
    unk_atom_val = len(defs.SELECT_ATOMICNUMS_TO_KEEP)  # "other" bucket index
    if mk["num_ntypes"] == unk_atom_val:
        drug_df = tables.where(drug_df, [not has_unknown_atom(s) for s in drug_df[smiles_col]])
    # the unknown bond's index, +1 for the self-loop offset (the JAX package
    # reads it as SMILES_BOND_MAP["X"], which the defaultdict then keeps)
    unk_bond_val = defs.SMILES_BOND_MAP.default_factory() + 1
    if mk["num_etypes"] == unk_bond_val:
        drug_df = tables.where(drug_df, [not has_unknown_bond(s) for s in drug_df[smiles_col]])
    return prot_df, drug_df


def sequence_from_pdb(pdb_file: str) -> str:
    """Protein sequence from a structure file (replaces the reference's
    mdtraj residue iteration, test_protein_binders.py:213-225)."""
    from caster_dta_torch.data.featurize.pdb import load_backbone_coords
    _, res_names = load_backbone_coords(pdb_file)
    return "".join(defs.PROTEIN_3LETTER_1LETTER_MAP[r] for r in res_names)
