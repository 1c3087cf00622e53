"""Self-contained cheminformatics: SMILES parsing, molecular perception
(rings, aromaticity, implicit hydrogens, hybridization, stereo), and
Gasteiger-Marsili partial charges.

The reference uses RDKit (utils/smiles_utils.py, utils/create_smiles_features.py);
the package does not depend on RDKit, so the needed subset is implemented from the public
specifications (OpenSMILES, Gasteiger-Marsili PEOE 1980). Property names and
feature semantics mirror the RDKit calls the reference makes, so the feature
extraction layer (features.py) is a drop-in behavioral equivalent.
"""
from caster_dta_torch.data.featurize.chem.mol import Atom, Bond, Mol
from caster_dta_torch.data.featurize.chem.smiles import mol_from_smiles

__all__ = ["Atom", "Bond", "Mol", "mol_from_smiles"]
