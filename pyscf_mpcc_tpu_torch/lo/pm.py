"""Pipek-Mezey orbital localization with Lowdin populations.

Role of the reference's pyscf/lo/pipek.py (consumed by the MP-CC workflow,
examples/cc/44-mpcc/n2_rohf_umpccsd.py:12) as an input-producing step:
maximize sum_A sum_i q_A(i)^2 by pairwise Jacobi rotations — robust,
deterministic, and adequate for the fragment workflows.  Populations are
Lowdin (S^1/2-orthogonalized) charges, close to the reference's default
'meta-lowdin' for valence-dominated fragments.

A host copy of the JAX package's lo/pm.py (NumPy and the port's gto).
"""

from __future__ import annotations

import numpy as np


def _sqrtm(S):
    w, v = np.linalg.eigh(S)
    return (v * np.sqrt(w)) @ v.T


def lowdin_populations(mol, mo_coeff, S=None):
    """q[A, i]: Lowdin population of orbital i on atom A."""
    from pyscf_mpcc_tpu_torch import gto as _gto
    if S is None:
        S = _gto.intor_ovlp(mol)
    Shalf = _sqrtm(S)
    C = Shalf @ mo_coeff          # orthogonalized coefficients
    natm = mol.natm
    # map AO -> atom
    ao_atom = np.empty(mol.nao, dtype=int)
    p = 0
    for sh in mol.shells:
        n = sh.nao(mol.cart)
        ao_atom[p:p + n] = sh.atom_id
        p += n
    q = np.zeros((natm, mo_coeff.shape[1]))
    for A in range(natm):
        mask = ao_atom == A
        q[A] = (C[mask] ** 2).sum(axis=0)
    return q


def pm_localize(mol, mo_coeff, S=None, max_sweeps=200, conv_tol=1e-10):
    """Jacobi-sweep PM localization.  Returns (C_loc, U) with C_loc = C @ U."""
    from pyscf_mpcc_tpu_torch import gto as _gto
    if S is None:
        S = _gto.intor_ovlp(mol)
    Shalf = _sqrtm(S)
    C = Shalf @ mo_coeff          # work in the orthogonal basis
    nmo = C.shape[1]
    natm = mol.natm
    ao_atom = np.empty(mol.nao, dtype=int)
    p = 0
    for sh in mol.shells:
        n = sh.nao(mol.cart)
        ao_atom[p:p + n] = sh.atom_id
        p += n
    masks = [ao_atom == A for A in range(natm)]
    U = np.eye(nmo)

    def objective(C):
        return sum(((C[m] ** 2).sum(axis=0) ** 2).sum() for m in masks)

    last = objective(C)
    for sweep in range(max_sweeps):
        for i in range(nmo):
            for j in range(i + 1, nmo):
                # optimal 2x2 rotation (Edmiston-Ruedenberg style closed form)
                Ast = 0.0
                Bst = 0.0
                for m in masks:
                    qii = C[m, i] @ C[m, i]
                    qjj = C[m, j] @ C[m, j]
                    qij = C[m, i] @ C[m, j]
                    Ast += qij ** 2 - 0.25 * (qii - qjj) ** 2
                    Bst += qij * (qii - qjj)
                if abs(Ast) < 1e-14 and abs(Bst) < 1e-14:
                    continue
                gamma = 0.25 * np.arctan2(Bst, -Ast)
                c, s = np.cos(gamma), np.sin(gamma)
                ci = c * C[:, i] + s * C[:, j]
                cj = -s * C[:, i] + c * C[:, j]
                C[:, i], C[:, j] = ci, cj
                ui = c * U[:, i] + s * U[:, j]
                uj = -s * U[:, i] + c * U[:, j]
                U[:, i], U[:, j] = ui, uj
        cur = objective(C)
        if abs(cur - last) < conv_tol:
            break
        last = cur
    return mo_coeff @ U, U


class PipekMezey:
    """Object-style facade mirroring the reference's lo.PM usage."""

    def __init__(self, mol, mo_coeff):
        self.mol = mol
        self.mo_coeff = np.asarray(mo_coeff)

    def kernel(self):
        C, _ = pm_localize(self.mol, self.mo_coeff)
        return C
