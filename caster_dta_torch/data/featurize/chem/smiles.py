"""SMILES parser (OpenSMILES grammar subset sufficient for drug-like
molecules: organic subset + brackets, branches, ring closures incl. %nn,
aromatic lowercase atoms, charges, isotopes, tetrahedral chirality @/@@,
directional bonds / \\, dot-disconnected components)."""
from __future__ import annotations

import re

from caster_dta_torch.data.featurize.chem.mol import (
    Atom, Mol, AROMATIC_SYMBOLS, ORGANIC_SUBSET, ELEMENTS,
    CHI_TETRAHEDRAL_CCW, CHI_TETRAHEDRAL_CW)
from caster_dta_torch.data.featurize.chem import perception

_BRACKET_RE = re.compile(
    r"^(?P<isotope>\d+)?"
    r"(?P<symbol>[A-Z][a-z]?|[a-z]{1,2}|\*)"
    r"(?P<chiral>@{1,2}(?:TH[12]|AL[12]|SP[1-3]|TB\d{1,2}|OH\d{1,2})?)?"
    r"(?P<hcount>H\d*)?"
    r"(?P<charge>\+{1,3}|-{1,3}|\+\d+|-\d+)?"
    r"(?P<map>:\d+)?$")

_TWO_LETTER = {s for s in ELEMENTS if len(s) == 2}

_BOND_SYMBOLS = {"-": "SINGLE", "=": "DOUBLE", "#": "TRIPLE", "$": "QUADRUPLE",
                 ":": "AROMATIC", "/": "SINGLE", "\\": "SINGLE"}


class SmilesParseError(ValueError):
    pass


def _parse_bracket(token: str) -> Atom:
    m = _BRACKET_RE.match(token)
    if not m:
        raise SmilesParseError(f"bad bracket atom: [{token}]")
    sym = m.group("symbol")
    aromatic = sym[0].islower()
    symbol = sym.capitalize() if aromatic else sym
    if symbol == "*":
        raise SmilesParseError("wildcard atoms not supported")
    if symbol not in ELEMENTS:
        raise SmilesParseError(f"unknown element {symbol!r}")
    chiral = m.group("chiral")
    if chiral is None:
        tag = "CHI_UNSPECIFIED"
    elif chiral.startswith("@@"):
        tag = CHI_TETRAHEDRAL_CW
    else:
        tag = CHI_TETRAHEDRAL_CCW
    hc = m.group("hcount")
    hcount = 0 if hc is None else (1 if hc == "H" else int(hc[1:]))
    ch = m.group("charge")
    if ch is None:
        charge = 0
    elif ch in ("+", "++", "+++"):
        charge = len(ch)
    elif ch in ("-", "--", "---"):
        charge = -len(ch)
    else:
        charge = int(ch)
    iso = int(m.group("isotope")) if m.group("isotope") else 0
    mp = int(m.group("map")[1:]) if m.group("map") else 0
    return Atom(symbol=symbol, aromatic=aromatic, formal_charge=charge,
                isotope=iso, chiral_tag=tag, explicit_hs=hcount, atom_map=mp)


def mol_from_smiles(smiles: str, sanitize: bool = True) -> Mol:
    """Parse SMILES into a Mol and (by default) run perception: rings,
    aromaticity, implicit Hs, hybridization, conjugation, bond stereo."""
    mol = Mol()
    prev: list = [None]           # stack of previous atom indices (branching)
    pending_bond: str | None = None
    pending_dir = "NONE"
    ring_bonds: dict = {}         # ring-closure digit -> (atom_idx, bond, dir)

    i, n = 0, len(smiles)
    while i < n:
        c = smiles[i]

        if c == "[":
            j = smiles.find("]", i)
            if j < 0:
                raise SmilesParseError("unterminated bracket atom")
            atom = _parse_bracket(smiles[i + 1:j])
            i = j + 1
            _attach(mol, atom, prev, pending_bond, pending_dir)
            pending_bond, pending_dir = None, "NONE"
        elif c.isalpha():
            # organic subset (possibly two letters: Cl, Br)
            two = smiles[i:i + 2]
            if two in ("Cl", "Br"):
                sym, i = two, i + 2
            else:
                sym, i = c, i + 1
            if sym.islower():
                if sym not in AROMATIC_SYMBOLS:
                    raise SmilesParseError(f"unknown aromatic symbol {sym!r}")
                atom = Atom(symbol=sym.capitalize(), aromatic=True)
            else:
                if sym not in ORGANIC_SUBSET:
                    raise SmilesParseError(
                        f"element {sym!r} must be written in brackets")
                atom = Atom(symbol=sym)
            _attach(mol, atom, prev, pending_bond, pending_dir)
            pending_bond, pending_dir = None, "NONE"
        elif c in _BOND_SYMBOLS:
            pending_bond = _BOND_SYMBOLS[c]
            if c == "/":
                pending_dir = "ENDUPRIGHT"
            elif c == "\\":
                pending_dir = "ENDDOWNRIGHT"
            i += 1
        elif c.isdigit() or c == "%":
            if c == "%":
                num = smiles[i + 1:i + 3]
                if len(num) < 2 or not num.isdigit():
                    raise SmilesParseError("bad %nn ring closure")
                i += 3
            else:
                num = c
                i += 1
            _ring_closure(mol, prev, ring_bonds, num, pending_bond, pending_dir)
            pending_bond, pending_dir = None, "NONE"
        elif c == "(":
            prev.append(prev[-1])
            i += 1
        elif c == ")":
            if len(prev) <= 1:
                raise SmilesParseError("unbalanced parentheses")
            prev.pop()
            i += 1
        elif c == ".":
            prev[-1] = None
            i += 1
        elif c in " \t":
            break  # SMILES ends at whitespace (title/comment follows)
        else:
            raise SmilesParseError(f"unexpected character {c!r} at {i}")

    if ring_bonds:
        raise SmilesParseError(f"unclosed ring bonds: {sorted(ring_bonds)}")
    if len(prev) > 1:
        raise SmilesParseError("unclosed branch '('")
    if not mol.atoms:
        raise SmilesParseError("empty SMILES")
    if sanitize:
        perception.sanitize(mol)
    return mol


def _attach(mol: Mol, atom: Atom, prev: list, pending_bond, pending_dir):
    idx = mol.add_atom(atom)
    if prev[-1] is not None:
        p = prev[-1]
        btype = pending_bond
        if btype is None:
            btype = "AROMATIC" if (mol.atoms[p].aromatic and atom.aromatic) else "SINGLE"
        mol.add_bond(p, idx, btype, direction=pending_dir)
    prev[-1] = idx


def _ring_closure(mol: Mol, prev: list, ring_bonds: dict, num: str,
                  pending_bond, pending_dir):
    cur = prev[-1]
    if cur is None:
        raise SmilesParseError("ring closure with no current atom")
    if num in ring_bonds:
        other, obond, odir = ring_bonds.pop(num)
        btype = pending_bond or obond
        if btype is None:
            btype = ("AROMATIC" if (mol.atoms[other].aromatic
                                    and mol.atoms[cur].aromatic) else "SINGLE")
        direction = pending_dir if pending_dir != "NONE" else odir
        if other == cur:
            raise SmilesParseError("self ring closure")
        mol.add_bond(other, cur, btype, direction=direction)
    else:
        ring_bonds[num] = (cur, pending_bond, pending_dir)
