"""Textbook spin-orbital CCSD (generalized / GCCSD), NumPy reference code.

This is the framework's in-repo oracle, mirroring the reference's
cross-validation strategy of keeping ``*_slow`` textbook modules next to the
optimized ones (see pyscf/cc/rccsd_slow.py and SURVEY.md section 4).  It is
deliberately simple and dense: antisymmetrized physicists'-notation spin-
orbital integrals, the CCSD equations of Stanton, Gauss, Watts & Bartlett,
J. Chem. Phys. 94, 4334 (1991), Eqs. (1)-(13), and Jacobi+DIIS iteration.

Handles RHF, UHF and ROHF references uniformly (role of pyscf/cc/gccsd.py).
Use for small systems and as the ground truth for the fast JAX RCCSD/UCCSD.

A host copy of the JAX package's cc/gccsd_slow.py (NumPy, its imports pointed at
the port).
"""

from __future__ import annotations

import numpy as np

from pyscf_mpcc_tpu_torch.lib.diis import DIIS
from pyscf_mpcc_tpu_torch.lib import logger as lg


class SpinOrbERIs:
    """Antisymmetrized spin-orbital integrals <pq||rs> + spin-orbital fock."""

    def __init__(self, oovv_full, fock, nocc, spins=None):
        self.ints = oovv_full  # <pq||rs>, (nso,nso,nso,nso)
        self.fock = fock
        self.nocc = nocc
        self.nso = fock.shape[0]
        self.mo_energy = np.diag(fock).copy()
        self.spins = spins     # 0/1 per spin orbital (alpha/beta)

    def block(self, key):
        n, o, v = self.nso, slice(0, self.nocc), slice(self.nocc, self.nso)
        sl = {"o": o, "v": v}
        return self.ints[tuple(sl[c] for c in key)]


def build_eris(eri_ao, mo_a, mo_b, fock_ao, nelec):
    """Spin-orbital ERIs from AO integrals.

    eri_ao: chemists (nao,nao,nao,nao); mo_a/mo_b: (nao,nmo) alpha/beta MO
    coefficients; fock_ao: (fa, fb) AO Fock matrices; nelec: (na, nb).
    Spin orbitals ordered [occ_a, occ_b, vir_a, vir_b].
    """
    na, nb = nelec
    nmo = mo_a.shape[1]
    fa, fb = fock_ao
    # order: alpha occ, beta occ, alpha vir, beta vir
    coeffs = []
    spins = []
    for i in range(na):
        coeffs.append(mo_a[:, i]); spins.append(0)
    for i in range(nb):
        coeffs.append(mo_b[:, i]); spins.append(1)
    for i in range(na, nmo):
        coeffs.append(mo_a[:, i]); spins.append(0)
    for i in range(nb, nmo):
        coeffs.append(mo_b[:, i]); spins.append(1)
    C = np.array(coeffs).T           # (nao, nso)
    spins = np.array(spins)
    nso = C.shape[1]

    # chemists (pr|qs) over spin orbitals, zero unless spins match pairwise
    mo_eri = np.einsum("pqrs,pi,qj,rk,sl->ijkl", eri_ao, C, C, C, C,
                       optimize=True)
    smask = (spins[:, None] == spins[None, :]).astype(float)
    mo_eri = mo_eri * smask[:, :, None, None] * smask[None, None, :, :]
    # physicists <pq|rs> = (pr|qs); antisymmetrize
    phys = mo_eri.transpose(0, 2, 1, 3)
    anti = phys - phys.transpose(0, 1, 3, 2)

    focks = [fa, fb]
    fock_so = np.zeros((nso, nso))
    for p in range(nso):
        for q in range(nso):
            if spins[p] == spins[q]:
                fock_so[p, q] = C[:, p] @ focks[spins[p]] @ C[:, q]
    return SpinOrbERIs(anti, fock_so, na + nb, spins=spins)


def eris_from_scf(mf, frozen=0):
    """Build spin-orbital ERIs directly from a converged mean-field object.

    ``frozen`` drops the lowest ``frozen`` spatial orbitals per spin from the
    correlation space (reference get_frozen_mask semantics for the common
    integer case), so the resulting blocks match frozen-reduced amplitudes."""
    from pyscf_mpcc_tpu_torch import gto
    frozen = int(frozen or 0)
    eri_ao = gto.intor_eri(mf.mol)
    na, nb = mf.mol.nelec
    nelec = (na - frozen, nb - frozen)
    if mf.mo_coeff.ndim == 2:  # RHF
        dm = mf.make_rdm1()
        f = mf.get_fock(dm)
        mo = mf.mo_coeff[:, frozen:]
        return build_eris(eri_ao, mo, mo, (f, f), nelec)
    dm = mf.make_rdm1()
    j, k = mf.get_jk(dm)
    h = mf.get_hcore()
    fa = h + j[0] + j[1] - k[0]
    fb = h + j[0] + j[1] - k[1]
    return build_eris(eri_ao, mf.mo_coeff[0][:, frozen:],
                      mf.mo_coeff[1][:, frozen:], (fa, fb), nelec)


def init_amps(eris):
    nocc = eris.nocc
    f = eris.fock
    eo = np.diag(f)[:nocc]
    ev = np.diag(f)[nocc:]
    d1 = eo[:, None] - ev[None, :]
    d2 = (eo[:, None, None, None] + eo[None, :, None, None]
          - ev[None, None, :, None] - ev[None, None, None, :])
    t1 = f[:nocc, nocc:] / d1
    oovv = eris.block("oovv")
    t2 = oovv / d2
    emp2 = 0.25 * np.einsum("ijab,ijab->", t2, oovv)
    return emp2, t1, t2


def energy(t1, t2, eris):
    nocc = eris.nocc
    oovv = eris.block("oovv")
    fov = eris.fock[:nocc, nocc:]
    e = np.einsum("ia,ia->", fov, t1)
    e += 0.25 * np.einsum("ijab,ijab->", oovv, t2)
    e += 0.5 * np.einsum("ia,jb,ijab->", t1, t1, oovv)
    return e


def update_amps(t1, t2, eris):
    """One Jacobi update; Stanton et al. Eqs. (1)-(13)."""
    nocc = eris.nocc
    f = eris.fock
    fov = f[:nocc, nocc:]
    foo = f[:nocc, :nocc]
    fvv = f[nocc:, nocc:]
    eo = np.diag(foo)
    ev = np.diag(fvv)

    oovv = eris.block("oovv")
    ooov = eris.block("ooov")
    ovvv = eris.block("ovvv")
    oooo = eris.block("oooo")
    vvvv = eris.block("vvvv")
    ovov = eris.block("ovov")
    ovvo = eris.block("ovvo")
    ovoo = eris.block("ovoo")
    vvvo = eris.block("vvvo")

    tau_t = t2 + 0.5 * (np.einsum("ia,jb->ijab", t1, t1)
                        - np.einsum("ib,ja->ijab", t1, t1))
    tau = t2 + (np.einsum("ia,jb->ijab", t1, t1)
                - np.einsum("ib,ja->ijab", t1, t1))

    Fae = fvv - np.diag(ev)
    Fae = Fae - 0.5 * np.einsum("me,ma->ae", fov, t1)
    Fae = Fae + np.einsum("mf,mafe->ae", t1, ovvv)
    Fae = Fae - 0.5 * np.einsum("mnaf,mnef->ae", tau_t, oovv)

    Fmi = foo - np.diag(eo)
    Fmi = Fmi + 0.5 * np.einsum("ie,me->mi", t1, fov)
    Fmi = Fmi + np.einsum("ne,mnie->mi", t1, ooov)
    Fmi = Fmi + 0.5 * np.einsum("inef,mnef->mi", tau_t, oovv)

    Fme = fov + np.einsum("nf,mnef->me", t1, oovv)

    Wmnij = oooo.copy()
    tmp = np.einsum("je,mnie->mnij", t1, ooov)
    Wmnij += tmp - tmp.transpose(0, 1, 3, 2)
    Wmnij += 0.25 * np.einsum("ijef,mnef->mnij", tau, oovv)

    Wabef = vvvv.copy()
    # <am||ef> = -<ma||ef>
    tmp = -np.einsum("mb,maef->abef", t1, ovvv)
    Wabef -= tmp - tmp.transpose(1, 0, 2, 3)
    Wabef += 0.25 * np.einsum("mnab,mnef->abef", tau, oovv)

    oovo = -ooov.transpose(0, 1, 3, 2)  # <mn||ej> = -<mn||je>
    Wmbej = ovvo.copy()
    Wmbej += np.einsum("jf,mbef->mbej", t1, ovvv)
    Wmbej -= np.einsum("nb,mnej->mbej", t1, oovo)
    Wmbej -= np.einsum("jnfb,mnef->mbej", 0.5 * t2
                       + np.einsum("jf,nb->jnfb", t1, t1), oovv)

    # T1
    t1new = fov.copy()
    t1new += np.einsum("ie,ae->ia", t1, Fae)
    t1new -= np.einsum("ma,mi->ia", t1, Fmi)
    t1new += np.einsum("imae,me->ia", t2, Fme)
    t1new -= np.einsum("nf,naif->ia", t1, ovov)
    t1new -= 0.5 * np.einsum("imef,maef->ia", t2, ovvv)
    t1new -= 0.5 * np.einsum("mnae,nmei->ia", t2, oovo)

    # T2
    t2new = oovv.copy()
    tmp = np.einsum("ijae,be->ijab", t2, Fae - 0.5 * np.einsum("mb,me->be", t1, Fme))
    t2new += tmp - tmp.transpose(0, 1, 3, 2)
    tmp = np.einsum("imab,mj->ijab", t2, Fmi + 0.5 * np.einsum("je,me->mj", t1, Fme))
    t2new -= tmp - tmp.transpose(1, 0, 2, 3)
    t2new += 0.5 * np.einsum("mnab,mnij->ijab", tau, Wmnij)
    t2new += 0.5 * np.einsum("ijef,abef->ijab", tau, Wabef)
    tmp = (np.einsum("imae,mbej->ijab", t2, Wmbej)
           - np.einsum("ie,ma,mbej->ijab", t1, t1, ovvo))
    tmp = tmp - tmp.transpose(0, 1, 3, 2)
    t2new += tmp - tmp.transpose(1, 0, 2, 3)
    tmp = np.einsum("ie,abej->ijab", t1, vvvo)
    t2new += tmp - tmp.transpose(1, 0, 2, 3)
    tmp = np.einsum("ma,mbij->ijab", t1, ovoo)
    t2new -= tmp - tmp.transpose(0, 1, 3, 2)

    d1 = eo[:, None] - ev[None, :]
    d2 = (eo[:, None, None, None] + eo[None, :, None, None]
          - ev[None, None, :, None] - ev[None, None, None, :])
    return t1new / d1, t2new / d2


def kernel(eris, max_cycle=100, conv_tol=1e-9, conv_tol_normt=1e-7,
           diis_space=6, verbose=0, t1=None, t2=None):
    log = lg.Logger(verbose=verbose)
    emp2, t1_0, t2_0 = init_amps(eris)
    if t1 is None:
        t1 = t1_0
    if t2 is None:
        t2 = t2_0
    log.info("GCCSD MP2 init E_corr = %.14f", emp2)
    diis = DIIS(space=diis_space)
    nocc, nvir = t1.shape
    e_last = energy(t1, t2, eris)
    converged = False
    for it in range(max_cycle):
        t1new, t2new = update_amps(t1, t2, eris)
        normt = np.linalg.norm(t1new - t1) + np.linalg.norm(t2new - t2)
        vec = np.concatenate([t1new.ravel(), t2new.ravel()])
        vec = diis.update(vec)
        t1 = vec[: nocc * nvir].reshape(nocc, nvir)
        t2 = vec[nocc * nvir:].reshape(t2.shape)
        e = energy(t1, t2, eris)
        log.info("cycle %2d  E_corr = %.14f  dE = %9.3e  |dt| = %9.3e",
                 it, e, e - e_last, normt)
        if abs(e - e_last) < conv_tol and normt < conv_tol_normt:
            converged = True
            break
        e_last = e
    return float(e), t1, t2, converged
