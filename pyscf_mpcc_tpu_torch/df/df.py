"""Density fitting: 3-center B tensors.

Builds ``B[P, mu, nu]`` with ``(mu nu|lam sig) ~= sum_P B[P,munu] B[P,lamsig]``
via the Coulomb metric: ``B = L^-1 (P|mu nu)`` where ``(P|Q) = L L^T``.
Matches the reference's cholesky_eri semantics (pyscf/df/incore.py:124) and
the DF object surface (pyscf/df/df.py:41,127,194,228,258) that the CC stack
consumes, without HDF5 spill: on TPU the B tensor is the object we shard
over the mesh instead of streaming from disk.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.gto.mole import Mole

# default auxiliary basis per role, mirroring pyscf/df/addons.py DFBASIS
DEFAULT_AUXBASIS = "weigend"  # def2-universal-jfit


def make_auxmol(mol, auxbasis=None):
    """auxbasis: name string, per-element dict, 'etb' for automatic
    even-tempered generation (reference df/addons.py aug_etb), or
    'autoaux' for the ORCA AutoAux recipe (reference df/autoaux.py)."""
    if auxbasis == "etb":
        from pyscf_mpcc_tpu_torch.df.addons import aug_etb
        auxbasis = aug_etb(mol)
    elif auxbasis == "autoaux":
        from pyscf_mpcc_tpu_torch.df.autoaux import autoaux
        auxbasis = autoaux(mol)
    aux = Mole(atom=[[s, c] for s, c in zip(mol.symbols, mol.coords)],
               basis=auxbasis or DEFAULT_AUXBASIS, unit="bohr",
               charge=mol.charge, spin=mol.spin, cart=mol.cart,
               verbose=mol.verbose)
    return aux.build()


class DF:
    def __init__(self, mol, auxbasis=None):
        self.mol = mol
        self.auxbasis = auxbasis or DEFAULT_AUXBASIS
        self.auxmol = None
        self._B = None

    def build(self):
        if self._B is not None:
            return self
        self.auxmol = make_auxmol(self.mol, self.auxbasis)
        j3c = gto.intor_3c2e(self.mol, self.auxmol)      # (nao, nao, naux)
        j2c = gto.intor_2c2e(self.auxmol)                # (naux, naux)
        L = scipy.linalg.cholesky(j2c, lower=True)
        nao, naux = self.mol.nao, self.auxmol.nao
        b = scipy.linalg.solve_triangular(
            L, j3c.reshape(nao * nao, naux).T, lower=True)
        self._B = np.ascontiguousarray(b.reshape(naux, nao, nao))
        return self

    def B_ao(self):
        self.build()
        return self._B

    def get_naoaux(self):
        self.build()
        return self.auxmol.nao

    def loop(self, blksize=None):
        """Stream naux blocks of B (flattened pair index), reference-compatible."""
        B = self.B_ao()
        naux, nao = B.shape[0], B.shape[1]
        blksize = blksize or naux
        for p0 in range(0, naux, blksize):
            yield B[p0:p0 + blksize].reshape(-1, nao * nao)

    def ao2mo_b(self, mo1, mo2):
        """Half-transformed factors B[P, i, j] in MO basis: L^-1(P|mu nu) C C."""
        B = self.B_ao()
        return np.einsum("Lpq,pi,qj->Lij", B, mo1, mo2, optimize=True)
