"""Generalized Hartree-Fock over the doubled (spinor) AO basis.

Role of the reference scf/ghf.py (GHF class :567): one set of spinor MOs
over the [alpha-AO, beta-AO] direct sum, real arithmetic, aufbau
occupation of the ``nelectron`` lowest spinors.  The J build depends only
on the charge density (the alpha-alpha + beta-beta spatial blocks); K
carries the full 2x2 spin structure, including the spin-off-diagonal
blocks that let GHF relax to non-collinear solutions.  Collinear
references reproduce RHF/UHF exactly — the parity anchor in the tests.

``convert_to_ghf`` embeds a converged RHF/UHF into the spinor frame
(reference scf/addons.py convert_to_ghf) for seeding GHF or building
GCCSD inputs.

A host copy of the JAX package's scf/ghf.py (NumPy, its imports pointed at
the port).
"""

import numpy as np
import scipy.linalg

from pyscf_mpcc_tpu_torch.lib.diis import DIIS

from .hf import SCFBase, _JKDF, _JKIncore


class GHF(SCFBase):
    """Generalized HF.  mo_coeff: (2 nao, nso) spinor coefficients with
    the alpha AO block on top; mo_occ in {0, 1}."""

    def __init__(self, mol, verbose=None):
        super().__init__(mol, verbose)
        self.S0 = self.S          # spatial overlap
        self.h0 = self.hcore
        self.S = scipy.linalg.block_diag(self.S0, self.S0)
        self.hcore = scipy.linalg.block_diag(self.h0, self.h0)

    # -- spin-blocked J/K ------------------------------------------------
    def _blocks(self, dm):
        nao = self.S0.shape[0]
        return (dm[:nao, :nao], dm[:nao, nao:],
                dm[nao:, :nao], dm[nao:, nao:])

    def get_jk(self, dm):
        """J from the charge density; K per spin block (the ab/ba blocks
        are generally non-symmetric, so the DF path contracts B directly
        instead of the PSD half-transform)."""
        daa, dab, dba, dbb = self._blocks(np.asarray(dm))
        rho = daa + dbb
        jk = self._get_jk_builder()
        if isinstance(jk, _JKIncore):
            eri = jk.eri
            j_sp = np.einsum("pqrs,rs->pq", eri, rho, optimize=True)
            kb = [np.einsum("prqs,rs->pq", eri, d, optimize=True)
                  for d in (daa, dab, dba, dbb)]
        elif isinstance(jk, _JKDF):
            B = jk.B
            j_sp = np.einsum("Lpq,L->pq", B,
                             np.einsum("Lrs,rs->L", B, rho, optimize=True),
                             optimize=True)
            kb = [np.einsum("Lpr,rs,Lqs->pq", B, d, B, optimize=True)
                  for d in (daa, dab, dba, dbb)]
        else:  # pragma: no cover - future builders
            raise NotImplementedError(type(jk))
        j = scipy.linalg.block_diag(j_sp, j_sp)
        k = np.block([[kb[0], kb[1]], [kb[2], kb[3]]])
        return j, k

    def get_fock(self, dm=None):
        if dm is None:
            dm = self.make_rdm1()
        j, k = self.get_jk(dm)
        return self.hcore + j - k

    def get_occ(self, mo_energy):
        occ = np.zeros_like(mo_energy)
        occ[: self.mol.nelectron] = 1.0
        return occ

    def make_rdm1(self, mo_coeff=None, mo_occ=None):
        c = self.mo_coeff if mo_coeff is None else mo_coeff
        o = self.mo_occ if mo_occ is None else mo_occ
        return (c * o) @ c.T

    def energy_elec(self, dm, f):
        return 0.5 * np.einsum("pq,pq->", dm, self.hcore + f)

    def get_init_dm(self):
        da = super().get_init_dm()
        if da is None:
            return None
        dm = scipy.linalg.block_diag(da * 0.5, da * 0.5)
        na, nb = self.mol.nelec
        if na != nb:
            # tiny spin-mixing seed lets open shells leave the collinear
            # axis when a lower non-collinear solution exists
            nao = self.S0.shape[0]
            dm[:nao, nao:] += 1e-4
            dm[nao:, :nao] += 1e-4
        return dm

    def kernel(self, dm0=None):
        S = self.S
        dm = np.asarray(dm0) if dm0 is not None else self.get_init_dm()
        if dm is None:
            g = self.init_guess()          # GWH on the spatial block
            g2 = scipy.linalg.block_diag(g, g)
            e0, c0 = self.eig(g2, S)
            dm = self.make_rdm1(c0, self.get_occ(e0))
        diis = DIIS(space=self.diis_space)
        e_last = 0.0
        conv_tol_grad = self.conv_tol_grad or np.sqrt(self.conv_tol)
        for cycle in range(self.max_cycle):
            fock = self.get_fock(dm)
            err = fock @ dm @ S - S @ dm @ fock
            fock = diis.update(fock, xerr=err).reshape(S.shape)
            fock = self._shift_fock(fock, dm)   # occupations are 1
            mo_energy, mo_coeff = self.eig(fock, S)
            mo_occ = self.get_occ(mo_energy)
            dm = self.make_rdm1(mo_coeff, mo_occ)
            e = self.energy_elec(dm, self.get_fock(dm)) + self.e_nuc
            gnorm = np.linalg.norm(err)
            self.log.debug("GHF cycle %d  E = %.14f  dE = %.3e  "
                           "|FDS-SDF| = %.3e", cycle, e, e - e_last, gnorm)
            if abs(e - e_last) < self.conv_tol and gnorm < conv_tol_grad:
                self.converged = True
                break
            e_last = e
        fock = self.get_fock(dm)
        self.mo_energy, self.mo_coeff = self.eig(fock, S)
        self.mo_occ = self.get_occ(self.mo_energy)
        dm = self.make_rdm1()
        self.e_tot = float(self.energy_elec(dm, self.get_fock(dm))
                           + self.e_nuc)
        self.log.info("GHF converged=%s  E(GHF) = %.14f", self.converged,
                      self.e_tot)
        return self.e_tot


def convert_to_ghf(mf):
    """Embed a converged RHF/UHF into the spinor frame (reference
    scf/addons.py convert_to_ghf): spinor MOs sorted by orbital energy,
    occupations carried over."""
    from .hf import RHF, UHF
    mol = mf.mol
    out = GHF(mol, verbose=getattr(mf, "verbose", 0))
    nao = out.S0.shape[0]
    if np.asarray(mf.mo_coeff).ndim == 2:      # RHF/ROHF canonical frame
        ca = cb = np.asarray(mf.mo_coeff)
        ea = eb = np.asarray(mf.mo_energy)
        na = nb = mol.nelectron // 2
        occ_a = np.asarray(mf.mo_occ) * 0.5
        occ_b = occ_a
    else:
        ca, cb = np.asarray(mf.mo_coeff)
        ea, eb = np.asarray(mf.mo_energy)
        occ_a, occ_b = np.asarray(mf.mo_occ)
    nmo = ca.shape[1]
    C = np.zeros((2 * nao, 2 * nmo))
    C[:nao, :nmo] = ca
    C[nao:, nmo:] = cb
    e = np.concatenate([ea, eb])
    occ = np.concatenate([occ_a, occ_b])
    order = np.argsort(e, kind="stable")
    out.mo_coeff = C[:, order]
    out.mo_energy = e[order]
    out.mo_occ = occ[order]
    out.converged = bool(getattr(mf, "converged", False))
    dm = out.make_rdm1()
    out.e_tot = float(out.energy_elec(dm, out.get_fock(dm)) + out.e_nuc)
    return out
