"""Hartree-Fock mean field: RHF, UHF, ROHF with DIIS.

A copy of ``pyscf_mpcc_tpu/scf/hf.py`` (SCFBase, RHF, UHF, ROHF with its
Roothaan effective Fock, ``convert_to_uhf``, the in-core and
density-fitted J/K builders and the atomic guess): that package's
``scf/__init__`` enables the JAX compilation cache on import, so it cannot
be imported where jax is absent.  Host NumPy in fp64, as in the JAX
package: SCF is set-up cost, not the device hot path.  ``diis_scheme``
takes the energy-DIIS schemes of ``scf/diis.py`` (a host copy too).  The
density-fitted J/K takes a device option (``_JKDF(b3c, device=...)``),
off by default as in the JAX package.  ``RHF(mol).as_scanner()`` and
``UHF(mol).as_scanner()`` are the geometry scanner (SCFScanner).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.lib import logger as lg
from pyscf_mpcc_tpu_torch.lib.diis import DIIS
from pyscf_mpcc_tpu_torch.lib.stream import StreamObject
from pyscf_mpcc_tpu_torch.scf.diis import make_scheme


class _JKIncore:
    """Exact J/K from the in-core (pq|rs): J as one GEMM over the
    (pq),(rs) matrix, K over its (pr|qs) relayout, made at the first call
    and kept (a second nao^4 array; the JAX package's two unoptimized
    einsums take 4-5 times as long on a host's cores)."""

    def __init__(self, mol):
        self.eri = gto.intor_eri(mol)
        self._eri_k = None

    def get_jk(self, dm):
        # dm may be (nao,nao) or (2,nao,nao)
        n = self.eri.shape[0]
        if self._eri_k is None:
            self._eri_k = np.ascontiguousarray(
                self.eri.transpose(0, 2, 1, 3)).reshape(n * n, n * n)
        dm = np.asarray(dm)
        d = dm.reshape(-1, n * n).T
        j = (self.eri.reshape(n * n, n * n) @ d).T.reshape(dm.shape)
        k = (self._eri_k @ d).T.reshape(dm.shape)
        return j, k


class _JKDF:
    """Density-fitted J/K from the B tensor (naux, nao, nao).

    K uses the occupied-half-transform algorithm, K = (B C_o)(B C_o)^T with
    dm = 2 C_o C_o^T (Cholesky factor of dm in general), which is
    O(naux nao^2 nocc) instead of O(naux nao^3).

    ``device``: False (the default) contracts on the host in fp64; True
    runs the four contractions with torch on the card, a torch.device on
    that device, in ``dtype`` (lib/device.resolve: fp32 on the card, fp64
    on the CPU).  J and K come back as fp64 NumPy either way."""

    def __init__(self, b3c, device=False, dtype=None):
        self.B = np.asarray(b3c)
        self.device = device
        if device is not False:
            import torch

            from pyscf_mpcc_tpu_torch.lib import device as _dev
            dev, dt = _dev.resolve(None if device is True else device, dtype)
            self._Bd = torch.tensor(self.B, device=dev, dtype=dt)

    def _halfk(self, dm):
        # dm (symmetric PSD up to noise) = sum_i w_i v_i v_i^T; use eigh
        w, v = np.linalg.eigh(dm)
        keep = w > 1e-12
        return v[:, keep] * np.sqrt(w[keep])

    def get_jk(self, dm):
        if dm.ndim == 3:
            js, ks = zip(*(self.get_jk(d) for d in dm))
            return np.array(js), np.array(ks)
        co = self._halfk(dm)
        if self.device is not False:
            return self._get_jk_device(dm, co)
        B = self.B
        rho = np.einsum("Lpq,pq->L", B, dm, optimize=True)
        j = np.einsum("Lpq,L->pq", B, rho, optimize=True)
        lo = np.einsum("Lpr,ri->Lpi", B, co, optimize=True)
        k = np.einsum("Lpi,Lqi->pq", lo, lo, optimize=True)
        return j, k

    def _get_jk_device(self, dm, co):
        import torch
        Bd = self._Bd
        dmd = torch.tensor(dm, device=Bd.device, dtype=Bd.dtype)
        cod = torch.tensor(co, device=Bd.device, dtype=Bd.dtype)
        rho = torch.einsum("Lpq,pq->L", Bd, dmd)
        j = torch.einsum("Lpq,L->pq", Bd, rho)
        lo = torch.einsum("Lpr,ri->Lpi", Bd, cod)
        k = torch.einsum("Lpi,Lqi->pq", lo, lo)
        return (j.to(torch.float64).cpu().numpy(),
                k.to(torch.float64).cpu().numpy())


def _frac_occ(mo_energy, nelec, degen_tol=1e-5):
    """Aufbau occupations with equal spreading over degenerate sets
    (spherical averaging for open-shell atoms: O 2p^4 -> 4/3 each)."""
    occ = np.zeros_like(mo_energy)
    order = np.argsort(mo_energy)
    remaining = float(nelec)
    i = 0
    while i < len(order) and remaining > 1e-12:
        j = i
        while (j + 1 < len(order)
               and mo_energy[order[j + 1]] - mo_energy[order[j]] < degen_tol):
            j += 1
        g = order[i:j + 1]
        take = min(2.0 * len(g), remaining)
        occ[g] = take / len(g)
        remaining -= take
        i = j + 1
    return occ


_ATOM_DM_CACHE = {}


def _atomic_dm_cached(sym, basis):
    key = (sym, str(basis))
    if key not in _ATOM_DM_CACHE:
        _ATOM_DM_CACHE[key] = _atomic_rhf_dm(sym, basis)
    return _ATOM_DM_CACHE[key]


def _atomic_rhf_dm(sym, basis):
    """Spherically-averaged fractional-occupation atomic RHF density in
    the given basis (damped fixed-point iteration; guess quality only)."""
    from pyscf_mpcc_tpu_torch.gto.elements import charge as _elem_charge
    from pyscf_mpcc_tpu_torch.gto.mole import Mole
    mol = Mole(atom=[[sym, (0.0, 0.0, 0.0)]], basis=basis,
               spin=_elem_charge(sym) % 2)
    mol.build()
    S, T = gto.intor_ovlp_kin(mol)
    h = T + gto.intor_nuc(mol)
    eri = gto.intor_eri(mol)
    nelec = int(mol.nelectron)
    e, c = scipy.linalg.eigh(h, S)
    dm = (c * _frac_occ(e, nelec)) @ c.T
    e_last = np.inf
    for _ in range(200):
        j = np.einsum("pqrs,rs->pq", eri, dm, optimize=True)
        k = np.einsum("prqs,rs->pq", eri, dm, optimize=True)
        f = h + j - 0.5 * k
        e, c = scipy.linalg.eigh(f, S)
        dm_new = (c * _frac_occ(e, nelec)) @ c.T
        dm = 0.7 * dm_new + 0.3 * dm
        en = float(np.einsum("pq,pq->", dm, h + 0.5 * (j - 0.5 * k)))
        if abs(en - e_last) < 1e-10:
            break
        e_last = en
    return dm


class SCFBase(StreamObject):
    """Mean-field base.  A StreamObject: ``RHF(mol).set(conv_tol=1e-10)
    .run()`` chains, ``density_fit()`` upgrades J/K to DF."""

    conv_tol = 1e-11
    conv_tol_grad = None
    max_cycle = 100
    diis_space = 8
    # 'cdiis' (commutator, default), 'ediis', 'adiis', or the hybrids
    # 'ediis+cdiis' / 'adiis+cdiis' (energy-DIIS while |FDS-SDF| > 1e-2,
    # CDIIS after); see scf/diis.py
    diis_scheme = "cdiis"
    init_guess_scheme = "atom"
    # virtual-space level shift (Hartree) applied to the DIIS-extrapolated
    # Fock before diagonalization; the converged density/energy are
    # shift-independent.
    level_shift = 0.0

    def _shift_fock(self, fock, dm_half):
        """F + shift * (S - S P S): lifts the virtual subspace."""
        if not self.level_shift:
            return fock
        S = self.S
        return fock + self.level_shift * (S - S @ dm_half @ S)

    def __init__(self, mol, verbose=None):
        self.mol = mol
        self.verbose = mol.verbose if verbose is None else verbose
        self.log = lg.Logger(verbose=self.verbose)
        self.S, self.T = gto.intor_ovlp_kin(mol)
        self.V = gto.intor_nuc(mol)
        self.hcore = self.T + self.V
        self.e_nuc = mol.energy_nuc()
        self._jk = None
        self.with_df = None
        self.converged = False
        self.e_tot = None
        self.mo_coeff = None
        self.mo_energy = None
        self.mo_occ = None
        self._declare_keys()

    # -- hooks ----------------------------------------------------------
    def get_hcore(self):
        return self.hcore

    def get_ovlp(self):
        return self.S

    def density_fit(self, auxbasis=None):
        from pyscf_mpcc_tpu_torch.df import DF
        self.with_df = DF(self.mol, auxbasis=auxbasis)
        self._jk = None
        return self

    def _get_jk_builder(self):
        if self._jk is None:
            if self.with_df is not None:
                self.with_df.build()
                self._jk = _JKDF(self.with_df.B_ao())
            else:
                self._jk = _JKIncore(self.mol)
        return self._jk

    def get_jk(self, dm):
        return self._get_jk_builder().get_jk(dm)

    def init_guess(self):
        """Generalized Wolfsberg-Helmholz (GWH) core guess."""
        h = self.get_hcore()
        S = self.S
        hd = np.diag(h)
        K = 1.75
        guess = K * S * (hd[:, None] + hd[None, :]) * 0.5
        np.fill_diagonal(guess, hd)
        return guess

    def init_guess_by_atom(self):
        """Superposition of spherically-averaged atomic RHF densities
        (the 'atom' guess): solve a small fractional-occupation atomic SCF
        per distinct element in the molecule's own basis and assemble the
        block-diagonal AO density."""
        blocks = [_atomic_dm_cached(sym, self.mol.basis)
                  for sym in self.mol.symbols]
        return scipy.linalg.block_diag(*blocks)

    def get_init_dm(self):
        """Initial density per ``self.init_guess_scheme`` ('atom' with
        automatic fallback to the GWH core guess, or 'gwh'/'hcore' to
        force the core guess)."""
        if self.init_guess_scheme == "atom":
            try:
                return self.init_guess_by_atom()
            except Exception as exc:  # unusual basis: fall back to GWH
                self.log.info("atom init guess failed (%s); using GWH", exc)
        return None

    def eig(self, F, S):
        e, c = scipy.linalg.eigh(F, S)
        return e, c

    def kernel(self, dm0=None):
        raise NotImplementedError

    def run(self, dm0=None):
        self.kernel(dm0)
        return self

    scf = kernel

    def as_scanner(self):
        """Geometry scanner: a callable evaluating E_tot at a new geometry,
        warm-starting the SCF from the previous converged density."""
        return SCFScanner(self)


class RHF(SCFBase):
    def get_occ(self, mo_energy):
        nocc = self.mol.nelectron // 2
        occ = np.zeros_like(mo_energy)
        occ[:nocc] = 2.0
        return occ

    def make_rdm1(self, mo_coeff=None, mo_occ=None):
        c = self.mo_coeff if mo_coeff is None else mo_coeff
        o = self.mo_occ if mo_occ is None else mo_occ
        return (c * o) @ c.T

    def get_veff(self, dm):
        j, k = self.get_jk(dm)
        return j - 0.5 * k

    def get_fock(self, dm=None):
        if dm is None:
            dm = self.make_rdm1()
        return self.get_hcore() + self.get_veff(dm)

    def energy_elec(self, dm, f):
        h = self.get_hcore()
        return 0.5 * np.einsum("pq,pq->", dm, h + f)

    def kernel(self, dm0=None):
        S = self.S
        if dm0 is None:
            dm0 = self.get_init_dm()
        if dm0 is None:
            fock = self.init_guess()
        else:
            fock = self.get_fock(dm0)
        diis = DIIS(space=self.diis_space)
        ediis, hybrid = make_scheme(self.diis_scheme, self.diis_space)
        e_last = 0.0
        conv_tol_grad = self.conv_tol_grad or np.sqrt(self.conv_tol)
        for cycle in range(self.max_cycle):
            mo_energy, mo_coeff = self.eig(fock, S)
            mo_occ = self.get_occ(mo_energy)
            dm = self.make_rdm1(mo_coeff, mo_occ)
            fock = self.get_fock(dm)
            e = self.energy_elec(dm, fock) + self.e_nuc
            # DIIS on the commutator FDS - SDF (orthonormal-basis error)
            err = fock @ dm @ S - S @ dm @ fock
            gnorm0 = np.linalg.norm(err)
            if ediis is not None:
                ediis.push(e, dm, fock)
            fock_cd = diis.update(fock, xerr=err).reshape(S.shape)
            if ediis is not None and (not hybrid or gnorm0 > 1e-2):
                fock = ediis.extrapolate()
            else:
                fock = fock_cd
            fock = self._shift_fock(fock, dm * 0.5)
            gnorm = np.linalg.norm(err)
            self.log.debug("SCF cycle %d  E = %.14f  dE = %.3e  "
                           "|FDS-SDF| = %.3e", cycle, e, e - e_last, gnorm)
            if abs(e - e_last) < self.conv_tol and gnorm < conv_tol_grad:
                self.converged = True
                break
            e_last = e
        # final diagonalization with unextrapolated Fock
        fock = self.get_fock(dm)
        self.mo_energy, self.mo_coeff = self.eig(fock, S)
        self.mo_occ = self.get_occ(self.mo_energy)
        dm = self.make_rdm1()
        self.e_tot = float(self.energy_elec(dm, self.get_fock(dm))
                           + self.e_nuc)
        self.log.info("RHF converged=%s  E(RHF) = %.14f", self.converged,
                      self.e_tot)
        return self.e_tot


class UHF(SCFBase):
    def get_occ(self, mo_energy):
        na, nb = self.mol.nelec
        occ = np.zeros_like(mo_energy)
        occ[0, :na] = 1.0
        occ[1, :nb] = 1.0
        return occ

    def make_rdm1(self, mo_coeff=None, mo_occ=None):
        c = self.mo_coeff if mo_coeff is None else mo_coeff
        o = self.mo_occ if mo_occ is None else mo_occ
        return np.array([(c[0] * o[0]) @ c[0].T, (c[1] * o[1]) @ c[1].T])

    def get_fock(self, dm):
        j, k = self.get_jk(dm)
        jtot = j[0] + j[1]
        h = self.get_hcore()
        return np.array([h + jtot - k[0], h + jtot - k[1]])

    def energy_elec(self, dm, f):
        h = self.get_hcore()
        return 0.5 * (np.einsum("pq,pq->", dm[0], h + f[0])
                      + np.einsum("pq,pq->", dm[1], h + f[1]))

    def kernel(self, dm0=None):
        S = self.S
        if dm0 is None:
            da = self.get_init_dm()
            if da is not None:
                dm0 = np.array([da, da]) * 0.5
        if dm0 is None:
            g = self.init_guess()
            e0, c0 = self.eig(g, S)
            occ = self.get_occ(np.array([e0, e0]))
            # tiny symmetry breaking for open shells
            dm = self.make_rdm1(np.array([c0, c0]), occ)
        else:
            dm = np.asarray(dm0)
        diis = DIIS(space=self.diis_space)
        ediis, hybrid = make_scheme(self.diis_scheme, self.diis_space)
        e_last = 0.0
        conv_tol_grad = self.conv_tol_grad or np.sqrt(self.conv_tol)
        for cycle in range(self.max_cycle):
            fock = self.get_fock(dm)
            err = np.concatenate([
                (fock[0] @ dm[0] @ S - S @ dm[0] @ fock[0]).ravel(),
                (fock[1] @ dm[1] @ S - S @ dm[1] @ fock[1]).ravel()])
            if ediis is not None:
                ediis.push(self.energy_elec(dm, fock), dm, fock)
            fock_cd = diis.update(fock, xerr=err).reshape(2, *S.shape)
            if ediis is not None and (not hybrid
                                      or np.linalg.norm(err) > 1e-2):
                fock = ediis.extrapolate()
            else:
                fock = fock_cd
            fock = np.array([self._shift_fock(fock[0], dm[0]),
                             self._shift_fock(fock[1], dm[1])])
            ea, ca = self.eig(fock[0], S)
            eb, cb = self.eig(fock[1], S)
            mo_energy = np.array([ea, eb])
            mo_coeff = np.array([ca, cb])
            mo_occ = self.get_occ(mo_energy)
            dm = self.make_rdm1(mo_coeff, mo_occ)
            e = self.energy_elec(dm, self.get_fock(dm)) + self.e_nuc
            gnorm = np.linalg.norm(err)
            self.log.debug("UHF cycle %d  E = %.14f  dE = %.3e  |err| = %.3e",
                           cycle, e, e - e_last, gnorm)
            if abs(e - e_last) < self.conv_tol and gnorm < conv_tol_grad:
                self.converged = True
                break
            e_last = e
        fock = self.get_fock(dm)
        ea, ca = self.eig(fock[0], S)
        eb, cb = self.eig(fock[1], S)
        self.mo_energy = np.array([ea, eb])
        self.mo_coeff = np.array([ca, cb])
        self.mo_occ = self.get_occ(self.mo_energy)
        dm = self.make_rdm1()
        self.e_tot = float(self.energy_elec(dm, self.get_fock(dm)) + self.e_nuc)
        self.log.info("UHF converged=%s  E(UHF) = %.14f", self.converged, self.e_tot)
        return self.e_tot


class ROHF(UHF):
    """Restricted open-shell HF: UHF densities, Roothaan effective Fock."""

    def kernel(self, dm0=None):
        S = self.S
        na, nb = self.mol.nelec
        if dm0 is None:
            da = self.get_init_dm()
            if da is not None:
                dm0 = np.array([da, da]) * 0.5
        if dm0 is None:
            g = self.init_guess()
            e0, c0 = self.eig(g, S)
            occ = self.get_occ(np.array([e0, e0]))
            dm = self.make_rdm1(np.array([c0, c0]), occ)
        else:
            dm = np.asarray(dm0)
        diis = DIIS(space=self.diis_space)
        e_last = 0.0
        conv_tol_grad = self.conv_tol_grad or np.sqrt(self.conv_tol)
        mo_coeff = None
        for cycle in range(self.max_cycle):
            fock_uhf = self.get_fock(dm)
            dm_tot = dm[0] + dm[1]
            feff = self._roothaan_fock(fock_uhf, dm, S)
            err = feff @ (dm_tot * 0.5) @ S - S @ (dm_tot * 0.5) @ feff
            feff = diis.update(feff, xerr=err).reshape(S.shape)
            feff = self._shift_fock(feff, dm_tot * 0.5)
            e0, c0 = self.eig(feff, S)
            mo_coeff = np.array([c0, c0])
            mo_occ = self.get_occ(np.array([e0, e0]))
            dm = self.make_rdm1(mo_coeff, mo_occ)
            e = self.energy_elec(dm, self.get_fock(dm)) + self.e_nuc
            gnorm = np.linalg.norm(err)
            self.log.debug("ROHF cycle %d  E = %.14f  dE = %.3e  |err| = %.3e",
                           cycle, e, e - e_last, gnorm)
            if abs(e - e_last) < self.conv_tol and gnorm < conv_tol_grad:
                self.converged = True
                break
            e_last = e
        fock_uhf = self.get_fock(dm)
        feff = self._roothaan_fock(fock_uhf, dm, S)
        e0, c0 = self.eig(feff, S)
        self.mo_energy = np.array([e0, e0])
        self.mo_coeff = np.array([c0, c0])
        self.mo_occ = self.get_occ(self.mo_energy)
        dm = self.make_rdm1()
        self.e_tot = float(self.energy_elec(dm, self.get_fock(dm)) + self.e_nuc)
        self.log.info("ROHF converged=%s  E(ROHF) = %.14f", self.converged, self.e_tot)
        return self.e_tot

    def _roothaan_fock(self, fock, dm, S):
        """Roothaan single-matrix effective Fock (the reference's
        get_roothaan_fock projector algebra)."""
        fa, fb = fock
        dmc = dm[1]                # closed (doubly-occ) projector density
        dmo = dm[0] - dm[1]        # open-shell density
        dmv_proj = np.eye(S.shape[0]) - (dmc + dmo) @ S
        fc = 0.5 * (fa + fb)
        pc = dmc @ S
        po = dmo @ S
        pv = dmv_proj
        # NB: each diagonal block carries coefficient 1.0 in the symmetrized
        # form (the reference writes 0.5*block then adds fock + fock.T).
        f = (pc.T @ fc @ pc
             + po.T @ fc @ po
             + pv.T @ fc @ pv
             + po.T @ fb @ pc + pc.T @ fb @ po
             + po.T @ fa @ pv + pv.T @ fa @ po
             + pv.T @ fc @ pc + pc.T @ fc @ pv)
        return f


class SCFScanner:
    """Callable PES scanner over SCF solutions.

    ``scanner(mol)`` (a built Mole, or an atom spec reusing the template
    molecule's basis/unit/charge/spin) runs a fresh SCF of the template's
    class and settings, seeded with the previous geometry's converged
    density when the AO dimension matches.  Each call makes a new
    mean-field object, exposed as ``scanner.mf``."""

    def __init__(self, mf):
        from pyscf_mpcc_tpu_torch.gto.mole import Mole
        self._mole_cls = Mole
        self.mf = mf
        self.e_tot = mf.e_tot
        self.converged = mf.converged

    def _build_mol(self, mol_or_atom):
        if isinstance(mol_or_atom, self._mole_cls):
            mol = mol_or_atom
            if not mol._built:
                mol.build()
            return mol
        t = self.mf.mol
        mol = self._mole_cls(atom=mol_or_atom, basis=t.basis, unit=t.unit,
                             charge=t.charge, spin=t.spin, cart=t.cart,
                             verbose=t.verbose)
        mol.build()
        return mol

    def __call__(self, mol_or_atom, dm0=None):
        last = self.mf
        mol = self._build_mol(mol_or_atom)
        mf = type(last)(mol, verbose=last.verbose)
        for k in ("conv_tol", "conv_tol_grad", "max_cycle", "diis_space"):
            setattr(mf, k, getattr(last, k))
        if last.with_df is not None:
            mf.density_fit(last.with_df.auxbasis)
        if dm0 is None and last.converged and last.mo_coeff is not None \
                and mol.nao == last.mol.nao:
            dm0 = last.make_rdm1()
        mf.kernel(dm0=dm0)
        self.mf = mf
        self.e_tot = mf.e_tot
        self.converged = mf.converged
        return mf.e_tot


def convert_to_uhf(mf):
    """View an RHF/ROHF solution through the UHF interface (spin-resolved
    mo arrays), as the reference's scf.addons.convert_to_uhf does."""
    out = UHF(mf.mol, verbose=mf.verbose)
    out.with_df = mf.with_df
    out._jk = mf._jk
    if isinstance(mf, UHF):  # includes ROHF
        out.mo_coeff = np.array(mf.mo_coeff)
        out.mo_energy = np.array(mf.mo_energy)
        out.mo_occ = np.array(mf.mo_occ)
    else:
        out.mo_coeff = np.array([mf.mo_coeff, mf.mo_coeff])
        out.mo_energy = np.array([mf.mo_energy, mf.mo_energy])
        out.mo_occ = np.array([(mf.mo_occ > 0).astype(float),
                               (mf.mo_occ > 1).astype(float)])
    out.converged = mf.converged
    out.e_tot = mf.e_tot
    return out
