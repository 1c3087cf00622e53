"""Molecule object model: atoms, bonds, rings.

Property names follow the RDKit API surface the reference consumes
(utils/create_smiles_features.py:23-56): chiral tag, hybridization, total/
implicit H counts, degree, formal charge, radicals, ring membership,
aromaticity, Gasteiger charge, bond type/stereo/conjugation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

# element data: symbol -> (atomic number, valence-electron count, default valences)
# default valences per the OpenSMILES "normal valence" table
ELEMENTS = {
    "H": (1, 1, (1,)), "He": (2, 2, (0,)),
    "Li": (3, 1, (1,)), "Be": (4, 2, (2,)), "B": (5, 3, (3,)),
    "C": (6, 4, (4,)), "N": (7, 5, (3, 5)), "O": (8, 6, (2,)),
    "F": (9, 7, (1,)), "Ne": (10, 8, (0,)),
    "Na": (11, 1, (1,)), "Mg": (12, 2, (2,)), "Al": (13, 3, (3,)),
    "Si": (14, 4, (4,)), "P": (15, 5, (3, 5)), "S": (16, 6, (2, 4, 6)),
    "Cl": (17, 7, (1,)), "Ar": (18, 8, (0,)),
    "K": (19, 1, (1,)), "Ca": (20, 2, (2,)),
    "Fe": (26, 8, (2, 3)), "Co": (27, 9, (2, 3)), "Ni": (28, 10, (2,)),
    "Cu": (29, 11, (1, 2)), "Zn": (30, 12, (2,)),
    "Ga": (31, 3, (3,)), "Ge": (32, 4, (4,)), "As": (33, 5, (3, 5)),
    "Se": (34, 6, (2, 4, 6)), "Br": (35, 7, (1,)), "Kr": (36, 8, (0,)),
    "Rb": (37, 1, (1,)), "Sr": (38, 2, (2,)),
    "Ru": (44, 8, (2,)), "Rh": (45, 9, (2,)), "Pd": (46, 10, (2,)),
    "Ag": (47, 11, (1,)), "Cd": (48, 12, (2,)),
    "In": (49, 3, (3,)), "Sn": (50, 4, (2, 4)), "Sb": (51, 5, (3, 5)),
    "Te": (52, 6, (2, 4, 6)), "I": (53, 7, (1,)), "Xe": (54, 8, (0,)),
    "Cs": (55, 1, (1,)), "Ba": (56, 2, (2,)),
    "Pt": (78, 10, (2, 4)), "Au": (79, 11, (1, 3)), "Hg": (80, 12, (1, 2)),
    "Tl": (81, 3, (1, 3)), "Pb": (82, 4, (2, 4)), "Bi": (83, 5, (3, 5)),
}

ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
AROMATIC_SYMBOLS = {"b", "c", "n", "o", "p", "s", "se", "as", "te"}

# chiral tags (RDKit naming)
CHI_UNSPECIFIED = "CHI_UNSPECIFIED"
CHI_TETRAHEDRAL_CCW = "CHI_TETRAHEDRAL_CCW"  # @
CHI_TETRAHEDRAL_CW = "CHI_TETRAHEDRAL_CW"    # @@

BOND_ORDER = {"SINGLE": 1.0, "DOUBLE": 2.0, "TRIPLE": 3.0, "QUADRUPLE": 4.0,
              "AROMATIC": 1.5}


@dataclass
class Atom:
    symbol: str
    aromatic: bool = False
    formal_charge: int = 0
    isotope: int = 0
    chiral_tag: str = CHI_UNSPECIFIED
    explicit_hs: Optional[int] = None   # H count given in brackets; None = organic subset
    atom_map: int = 0
    idx: int = -1
    # perception results
    implicit_hs: int = 0
    radicals: int = 0
    in_ring: bool = False
    hybridization: str = "UNSPECIFIED"
    gasteiger_charge: float = 0.0
    bonds: List["Bond"] = field(default_factory=list)

    @property
    def atomic_num(self) -> int:
        return ELEMENTS[self.symbol][0]

    @property
    def valence_electrons(self) -> int:
        return ELEMENTS[self.symbol][1]

    @property
    def default_valences(self):
        return ELEMENTS[self.symbol][2]

    def GetChiralTag(self):
        return self.chiral_tag

    def GetHybridization(self):
        return self.hybridization

    def GetTotalNumHs(self) -> int:
        explicit = self.explicit_hs or 0
        h_neighbors = sum(1 for b in self.bonds
                          if b.other(self.idx).symbol == "H")
        return explicit + self.implicit_hs + h_neighbors

    def GetDegree(self) -> int:
        return len(self.bonds)

    def GetImplicitValence(self) -> int:
        return self.implicit_hs

    def GetFormalCharge(self) -> int:
        return self.formal_charge

    def GetNumRadicalElectrons(self) -> int:
        return self.radicals

    def IsInRing(self) -> bool:
        return self.in_ring

    def GetIsAromatic(self) -> bool:
        return self.aromatic

    def GetAtomicNum(self) -> int:
        return self.atomic_num

    def bond_order_sum(self) -> float:
        return sum(b.order for b in self.bonds)

    def total_sigma(self) -> int:
        return len(self.bonds) + self.implicit_hs + (self.explicit_hs or 0)


@dataclass
class Bond:
    a1: int
    a2: int
    bond_type: str = "SINGLE"           # SINGLE/DOUBLE/TRIPLE/AROMATIC
    stereo: str = "STEREONONE"
    conjugated: bool = False
    in_ring: bool = False
    direction: str = "NONE"             # ENDUPRIGHT (/), ENDDOWNRIGHT (\)
    mol: Optional["Mol"] = None

    @property
    def order(self) -> float:
        return BOND_ORDER[self.bond_type]

    def other(self, idx: int) -> Atom:
        o = self.a2 if idx == self.a1 else self.a1
        return self.mol.atoms[o]

    def GetBondType(self):
        return self.bond_type

    def GetStereo(self):
        return self.stereo

    def GetIsConjugated(self) -> bool:
        return self.conjugated

    def IsInRing(self) -> bool:
        return self.in_ring

    def GetBeginAtomIdx(self) -> int:
        return self.a1

    def GetEndAtomIdx(self) -> int:
        return self.a2


@dataclass
class Mol:
    atoms: List[Atom] = field(default_factory=list)
    bonds: List[Bond] = field(default_factory=list)
    rings: List[List[int]] = field(default_factory=list)   # SSSR atom-index rings

    def GetAtoms(self):
        return self.atoms

    def GetBonds(self):
        return self.bonds

    def GetNumAtoms(self) -> int:
        return len(self.atoms)

    def add_atom(self, atom: Atom) -> int:
        atom.idx = len(self.atoms)
        self.atoms.append(atom)
        return atom.idx

    def add_bond(self, a1: int, a2: int, bond_type: str, direction: str = "NONE") -> Bond:
        b = Bond(a1, a2, bond_type, direction=direction, mol=self)
        self.bonds.append(b)
        self.atoms[a1].bonds.append(b)
        self.atoms[a2].bonds.append(b)
        return b

    def bond_between(self, a1: int, a2: int) -> Optional[Bond]:
        for b in self.atoms[a1].bonds:
            if {b.a1, b.a2} == {a1, a2}:
                return b
        return None
