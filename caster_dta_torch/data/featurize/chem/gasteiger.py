"""Gasteiger-Marsili PEOE partial charges.

Implements the published iterative partial-equalization-of-orbital-
electronegativity algorithm (Gasteiger & Marsili, Tetrahedron 36:3219, 1980):
chi(q) = a + b q + c q^2 per atom orbital state; each iteration transfers
charge along every bond proportional to the electronegativity difference,
scaled by the cation electronegativity of the less electronegative atom and
damped by 0.5^k. Implicit/explicit hydrogens participate as attached
pseudo-atoms; heavy-atom charges are reported (matching what the reference
reads via RDKit's _GasteigerCharge, utils/create_smiles_features.py:45-56).
"""
from __future__ import annotations

import numpy as np

from caster_dta_torch.data.featurize.chem.mol import Mol

# (a, b, c) by element and orbital state, Gasteiger-Marsili 1980 Table 1
_PARAMS = {
    ("H", "*"): (7.17, 6.24, -0.56),
    ("C", "SP3"): (7.98, 9.18, 1.88),
    ("C", "SP2"): (8.79, 9.32, 1.51),
    ("C", "SP"): (10.39, 9.45, 0.73),
    ("N", "SP3"): (11.54, 10.82, 1.36),
    ("N", "SP2"): (12.87, 11.15, 0.85),
    ("N", "SP"): (15.68, 11.70, -0.27),
    ("O", "SP3"): (14.18, 12.92, 1.39),
    ("O", "SP2"): (17.07, 13.79, 0.47),
    ("F", "*"): (14.66, 13.85, 2.31),
    ("Cl", "*"): (11.00, 9.69, 1.35),
    ("Br", "*"): (10.08, 8.47, 1.16),
    ("I", "*"): (9.90, 7.96, 0.96),
    ("S", "*"): (10.14, 9.13, 1.38),
    ("P", "*"): (8.90, 8.24, 0.96),
}
_H_CATION_CHI = 20.02
_DEFAULT = (7.98, 9.18, 1.88)  # fall back to C sp3 for unparameterized atoms


def _abc(symbol: str, hyb: str):
    for key in ((symbol, hyb), (symbol, "*"), (symbol, "SP3")):
        if key in _PARAMS:
            return _PARAMS[key]
    return _DEFAULT


def compute_gasteiger_charges(mol: Mol, n_iter: int = 12) -> np.ndarray:
    """Assign .gasteiger_charge on each heavy atom; returns the array."""
    n = len(mol.atoms)
    abc = np.array([_abc(a.symbol, a.hybridization) for a in mol.atoms])
    n_hs = np.array([a.implicit_hs + (a.explicit_hs or 0) for a in mol.atoms],
                    dtype=np.int64)
    h_abc = np.array(_PARAMS[("H", "*")])

    q = np.array([float(a.formal_charge) for a in mol.atoms])
    qh = np.zeros(n)  # aggregated charge of each atom's attached hydrogens

    edges = [(b.a1, b.a2) for b in mol.bonds]
    damp = 1.0
    for _ in range(n_iter):
        damp *= 0.5
        chi = abc[:, 0] + abc[:, 1] * q + abc[:, 2] * q * q
        chi_plus = abc.sum(axis=1)          # chi at q=+1
        # special cation electronegativity for hydrogen
        with np.errstate(invalid="ignore"):
            h_q = np.divide(qh, n_hs, out=np.zeros(n), where=n_hs > 0)
        chi_h = h_abc[0] + h_abc[1] * h_q + h_abc[2] * h_q * h_q

        dq = np.zeros(n)
        dqh = np.zeros(n)
        for i, j in edges:
            if chi[j] > chi[i]:
                t = (chi[j] - chi[i]) / chi_plus[i] * damp
                dq[i] += t
                dq[j] -= t
            else:
                t = (chi[i] - chi[j]) / chi_plus[j] * damp
                dq[j] += t
                dq[i] -= t
        # heavy-atom <-> hydrogen transfers (per attached H)
        for i in range(n):
            if n_hs[i] == 0:
                continue
            if chi[i] > chi_h[i]:
                t = (chi[i] - chi_h[i]) / _H_CATION_CHI * damp * n_hs[i]
                dqh[i] += t
                dq[i] -= t
            else:
                t = (chi_h[i] - chi[i]) / chi_plus[i] * damp * n_hs[i]
                dq[i] += t
                dqh[i] -= t
        q += dq
        qh += dqh

    for a, qi in zip(mol.atoms, q):
        a.gasteiger_charge = float(qi)
    return q
