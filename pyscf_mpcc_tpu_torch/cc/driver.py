"""User-facing CCSD method objects.

Port of ``pyscf_mpcc_tpu/cc/driver.py``: ``CCSD(mf, device=...)``
dispatches on the mean field, RHF to ``RCCSDDriver`` and UHF/ROHF (or a
spin-resolved ``mo_coeff``) to ``UCCSDDriver``.  The restricted driver
runs ``.run()``, ``.ccsd_t()``, ``.solve_lambda()``,
``.make_rdm1()``/``make_rdm2()``/``make_rdm12()``, the T1/D1/D2
diagnostics, chk and DIIS-ring restarts; the unrestricted one ``.run()``
and ``.ccsd_t()`` (its Λ, certified energy and RDMs are the ``*_u``
functions of cc/lambda_ad).  Both have the geometry scanner
(``as_scanner``).  Frozen core via an integer ``frozen`` (lowest orbitals
dropped from the correlation space).  The device defaults to CUDA
(lib/device.resolve; pass ``device=torch.device("cpu")`` for the CPU); the
dtype follows lib/device (fp64 on the CPU, fp32 with TF32 off on CUDA)
unless given.
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch import ao2mo, config, gto
from pyscf_mpcc_tpu_torch.convert import to_numpy
from pyscf_mpcc_tpu_torch.lib import logger
from pyscf_mpcc_tpu_torch.lib.stream import StreamObject
from pyscf_mpcc_tpu_torch.cc import ccsd_t as ccsd_t_mod
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.cc import lambda_ad, rccsd, uccsd
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.scf.hf import UHF


class RCCSDDriver(StreamObject):
    conv_tol = config.CC_CONV_TOL
    conv_tol_normt = config.CC_CONV_TOL_NORMT
    max_cycle = 100
    diis_space = 6
    level_shift = 0.0
    # 0 -> let the memory planner (lib/memory.py) size the DF-ladder tiling
    ntile = 0
    # spill the DIIS ring here every cycle (preemption-safe restarts)
    diis_file = None

    def __init__(self, mf, frozen=0, mo_coeff=None, *, device=None,
                 dtype=None):
        self.device, self.dtype = _dev.resolve(device, dtype)
        self._scf = mf
        self.mol = mf.mol
        self.frozen = int(frozen or 0)
        self.mo_coeff = np.asarray(mf.mo_coeff if mo_coeff is None
                                   else mo_coeff)
        self.nocc = self.mol.nelectron // 2 - self.frozen
        self.nmo = self.mo_coeff.shape[1] - self.frozen
        self.e_corr = None
        self.t1 = self.t2 = None
        self.l1 = self.l2 = None
        self.converged = False
        self.eris = None
        self._eri_ao = None
        self._declare_keys()

    # -- integral handling -------------------------------------------------
    def ao2mo(self, mo_coeff=None):
        mo = self.mo_coeff if mo_coeff is None else np.asarray(mo_coeff)
        mo = mo[:, self.frozen:]
        dm = self._scf.make_rdm1()
        fock_ao = self._scf.get_fock(dm)
        kw = dict(dtype=self.dtype, device=self.device)
        if getattr(self._scf, "with_df", None) is not None:
            b = self._scf.with_df.B_ao()
            self.eris = eris_mod.make_eris_df(b, mo, fock_ao, self.nocc,
                                              **kw)
        else:
            if self._eri_ao is None:
                self._eri_ao = gto.intor_eri(self.mol)
            self.eris = eris_mod.make_eris_incore(
                self._eri_ao, mo, fock_ao, self.nocc, **kw)
        return self.eris

    # -- solvers -----------------------------------------------------------
    def ladder_ntile(self, eris, vjp=False):
        """Tiles a virtual axis of the DF ladder: ``self.ntile`` if set,
        else lib/memory's plan for the device's budget, or one tile on a
        CPU without config.MAX_MEMORY, which has no device memory to plan
        against (and with full integrals, which have no ladder)."""
        if self.ntile:
            return self.ntile
        if eris.Lov is None or (self.device.type != "cuda"
                                and not config.MAX_MEMORY):
            return 1
        from pyscf_mpcc_tpu_torch.lib import memory as _mem
        return _mem.plan_ladder_ntile(self.nocc, self.nmo - self.nocc,
                                      eris.Lov.shape[0], self.dtype,
                                      vjp=vjp, device=self.device)

    def kernel(self, t1=None, t2=None, eris=None):
        log = logger.Logger(verbose=self.verbose)
        tic = log.timer("")
        if eris is None:
            eris = self.eris or self.ao2mo()
            tic = log.timer("CCSD integral transform", *tic)
        self.converged, self.e_corr, self.t1, self.t2 = rccsd.kernel(
            eris, max_cycle=self.max_cycle, conv_tol=self.conv_tol,
            conv_tol_normt=self.conv_tol_normt, diis_space=self.diis_space,
            level_shift=self.level_shift, t1=t1, t2=t2,
            ntile=self.ladder_ntile(eris),
            adiis=getattr(self, "_adiis", None),
            diis_file=self.diis_file, verbose=self.verbose)
        self._adiis = None
        log.timer("CCSD iterations", *tic)
        return self.e_corr, self.t1, self.t2

    ccsd = kernel

    @property
    def e_tot(self):
        return self._scf.e_tot + self.e_corr

    @property
    def emp2(self):
        eris = self.eris or self.ao2mo()
        return float(rccsd.init_amps(eris)[0])

    def ccsd_t(self, t1=None, t2=None, eris=None, tile=0):
        """(T) correction; tile=0 lets the memory planner size the tile
        edge (lib/memory.plan_triples_tile)."""
        if eris is None:
            eris = self.eris or self.ao2mo()
        return ccsd_t_mod.kernel(t1 if t1 is not None else self.t1,
                                 t2 if t2 is not None else self.t2,
                                 eris, tile=tile)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    def solve_lambda(self, t1=None, t2=None, eris=None):
        if eris is None:
            eris = self.eris or self.ao2mo()
        # the backward pass keeps a W block and its cotangent live, so it
        # plans a finer tiling than the forward solve
        conv, self.l1, self.l2 = lambda_ad.kernel(
            t1 if t1 is not None else self.t1,
            t2 if t2 is not None else self.t2, eris,
            conv_tol=self.conv_tol_normt, max_cycle=self.max_cycle,
            ntile=self.ladder_ntile(eris, vjp=True))
        return self.l1, self.l2

    def make_rdm12(self):
        """(rdm1, rdm2) in the MO basis of the correlated orbitals, from
        the full (incore) integrals on the driver's device and dtype."""
        if self.l1 is None:
            self.solve_lambda()
        mo = self.mo_coeff[:, self.frozen:]
        if self._eri_ao is None:
            self._eri_ao = gto.intor_eri(self.mol)
        h_mo = self._tensor(mo.T @ self._scf.get_hcore() @ mo)
        mo64 = torch.as_tensor(mo, dtype=torch.float64, device=self.device)
        eri_mo = ao2mo.full(torch.as_tensor(self._eri_ao, dtype=torch.float64,
                                            device=self.device), mo64)
        return lambda_ad.make_rdm12(h_mo, eri_mo.to(self.dtype), self.t1,
                                    self.t2, self.l1, self.l2, self.nocc)

    def make_rdm1(self):
        return self.make_rdm12()[0]

    def make_rdm2(self):
        return self.make_rdm12()[1]

    def eeccsd(self, nroots=3, tol=1e-6):
        """Lowest EE-EOM-CCSD excitation energies (Jacobian-jvp sigma)."""
        from pyscf_mpcc_tpu_torch.cc import eom
        eris = self.eris or self.ao2mo()
        conv, e, vecs = eom.kernel_ee(self.t1, self.t2, eris, nroots=nroots,
                                      tol=tol, ntile=self.ntile or None)
        return e

    def ipccsd(self, nroots=3, tol=1e-7):
        """Lowest IP-EOM-CCSD ionization energies (continuum-orbital
        embedding of the EE Jacobian; reference eom_rccsd.py:291)."""
        from pyscf_mpcc_tpu_torch.cc import eom
        eris = self.eris or self.ao2mo()
        conv, e, vecs = eom.kernel_ip(self.t1, self.t2, eris,
                                      nroots=nroots, tol=tol,
                                      ntile=self.ntile or None)
        return e

    def eaccsd(self, nroots=3, tol=1e-7):
        """Lowest EA-EOM-CCSD attachment energies (reference
        eom_rccsd.py:606)."""
        from pyscf_mpcc_tpu_torch.cc import eom
        eris = self.eris or self.ao2mo()
        conv, e, vecs = eom.kernel_ea(self.t1, self.t2, eris,
                                      nroots=nroots, tol=tol,
                                      ntile=self.ntile or None)
        return e

    def eomsf_ccsd(self, nroots=2, tol=1e-6):
        """Lowest spin-flip EE-EOM-CCSD roots (Ms -> -1 sector), via the
        spin-orbital Jacobian on the host (reference eom_rccsd
        EOMEESpinFlip role); small systems (spin-orbital einsums)."""
        from pyscf_mpcc_tpu_torch.cc import eom, gccsd_slow
        er = gccsd_slow.eris_from_scf(self._scf, frozen=self.frozen)
        _, t1g, t2g, _ = gccsd_slow.kernel(er, conv_tol=1e-10,
                                           conv_tol_normt=1e-8)
        conv, e, vecs = eom.kernel_sf(t1g, t2g, er, nroots=nroots, tol=tol)
        return e

    def dump_chk(self, path, key="ccsd"):
        """Checkpoint the solution (e_corr, t1, t2, mo_coeff) to HDF5, in
        the JAX package's format."""
        from pyscf_mpcc_tpu_torch.lib import chkfile
        chkfile.dump_cc(path, self.e_corr, to_numpy(self.t1),
                        to_numpy(self.t2), mo_coeff=self.mo_coeff, key=key)

    def restore_from_chk(self, path, key="ccsd"):
        """Warm-start amplitudes from a checkpoint, on the driver's device
        and dtype."""
        from pyscf_mpcc_tpu_torch.lib import chkfile
        data = chkfile.load_cc(path, key=key)
        self.t1 = self._tensor(data["t1"])
        self.t2 = self._tensor(data["t2"])
        return self

    def restore_from_diis_(self, path):
        """Resume from a spilled host DIIS ring (the .npz ``diis_file``
        writes): the next ``kernel()`` starts from the ring's last
        extrapolated amplitudes with its history intact."""
        from pyscf_mpcc_tpu_torch.lib.diis import DIIS
        self._adiis = DIIS.restore(path)
        return self

    # ---------------------------------------------------- diagnostics
    def get_t1_diagnostic(self):
        """T1 amplitude norm per correlated electron."""
        t1 = self.t1
        return float(torch.sqrt(torch.linalg.norm(t1) ** 2
                                / (2 * t1.shape[0])))

    def get_d1_diagnostic(self):
        """D1 diagnostic, Janssen et al. CPL 290 (1998) 423."""
        t1 = self.t1
        dij = torch.linalg.eigvalsh(torch.einsum("ia,ja->ij", t1, t1)).max()
        dab = torch.linalg.eigvalsh(torch.einsum("ia,ib->ab", t1, t1)).max()
        return float(torch.sqrt(torch.maximum(dij, dab)))

    def get_d2_diagnostic(self):
        """D2 diagnostic, Nielsen et al. CPL 310 (1999) 568."""
        t2 = self.t2
        dij = torch.linalg.eigvalsh(
            torch.einsum("ikab,jkab->ij", t2, t2)).max()
        dab = torch.linalg.eigvalsh(
            torch.einsum("ijac,ijbc->ab", t2, t2)).max()
        return float(torch.sqrt(torch.maximum(dij, dab)))

    def as_scanner(self):
        """CCSD geometry scanner; see CCSDScanner."""
        return CCSDScanner(self)


class UCCSDDriver(StreamObject):
    """Unrestricted CCSD on a UHF/ROHF (or RHF) mean field, on the driver's
    device and dtype (lib/device)."""
    conv_tol = config.CC_CONV_TOL
    conv_tol_normt = config.CC_CONV_TOL_NORMT
    max_cycle = 100
    diis_space = 6
    level_shift = 0.0
    # 'host' (lib.diis) or 'device' (lib.device_diis) DIIS ring
    diis_backend = "host"

    def __init__(self, mf, frozen=0, mo_coeff=None, *, device=None,
                 dtype=None):
        self.device, self.dtype = _dev.resolve(device, dtype)
        self._scf = mf
        self.mol = mf.mol
        self.frozen = int(frozen or 0)
        mo = np.asarray(mf.mo_coeff if mo_coeff is None else mo_coeff)
        if mo.ndim == 2:
            mo = np.array([mo, mo])
        self.mo_coeff = mo
        na, nb = self.mol.nelec
        self.nocc = (na - self.frozen, nb - self.frozen)
        self.e_corr = None
        self.t1 = self.t2 = None
        self.converged = False
        self.eris = None
        self._declare_keys()

    def ao2mo(self, mo_coeff=None):
        mo = self.mo_coeff if mo_coeff is None else np.asarray(mo_coeff)
        fa, fb = uccsd.uhf_focks(self._scf)
        f = self.frozen
        kw = dict(dtype=self.dtype, device=self.device)
        if getattr(self._scf, "with_df", None) is not None:
            self.eris = uccsd.make_eris_df(
                self._scf.with_df.B_ao(), mo[0][:, f:], mo[1][:, f:],
                fa, fb, self.nocc[0], self.nocc[1], **kw)
        else:
            self.eris = uccsd.make_eris_incore(
                gto.intor_eri(self.mol), mo[0][:, f:], mo[1][:, f:], fa, fb,
                self.nocc[0], self.nocc[1], **kw)
        return self.eris

    def kernel(self, t1=None, t2=None, eris=None):
        log = logger.Logger(verbose=self.verbose)
        tic = log.timer("")
        if eris is None:
            eris = self.eris or self.ao2mo()
            tic = log.timer("UCCSD integral transform", *tic)
        self.converged, self.e_corr, self.t1, self.t2 = uccsd.kernel(
            eris, max_cycle=self.max_cycle, conv_tol=self.conv_tol,
            conv_tol_normt=self.conv_tol_normt, diis_space=self.diis_space,
            level_shift=self.level_shift, t1=t1, t2=t2,
            diis_backend=self.diis_backend, verbose=self.verbose)
        log.timer("UCCSD iterations", *tic)
        return self.e_corr, self.t1, self.t2

    ccsd = kernel

    @property
    def e_tot(self):
        return self._scf.e_tot + self.e_corr

    def ipccsd(self, nroots=3, tol=1e-7, spin="a"):
        """Lowest IP-EOM-UCCSD roots for ``spin``-electron removal."""
        from pyscf_mpcc_tpu_torch.cc import eom
        eris = self.eris or self.ao2mo()
        conv, e, vecs = eom.kernel_ip_u(self.t1, self.t2, eris,
                                        nroots=nroots, tol=tol, spin=spin)
        return e

    def eaccsd(self, nroots=3, tol=1e-7, spin="a"):
        """Lowest EA-EOM-UCCSD roots for ``spin``-electron attachment."""
        from pyscf_mpcc_tpu_torch.cc import eom
        eris = self.eris or self.ao2mo()
        conv, e, vecs = eom.kernel_ea_u(self.t1, self.t2, eris,
                                        nroots=nroots, tol=tol, spin=spin)
        return e

    def ccsd_t(self, t1=None, t2=None, eris=None, tile=8):
        """UCCSD(T) through the tiled spin-orbital kernel
        (cc/uccsd_t.py), DF-direct when the eris carry 3-center factors;
        frozen > 0 works, since it reads the frozen-sliced eris."""
        from pyscf_mpcc_tpu_torch.cc import uccsd_t
        if eris is None:
            eris = self.eris or self.ao2mo()
        return uccsd_t.kernel(t1 if t1 is not None else self.t1,
                              t2 if t2 is not None else self.t2, eris,
                              tile=tile)

    def as_scanner(self):
        """UCCSD geometry scanner; see CCSDScanner."""
        return CCSDScanner(self)


class CCSDScanner:
    """Callable PES scanner over CCSD solutions: ``scanner(mol_or_atom)``
    runs the SCF scanner, then solves CCSD seeded with the previous
    geometry's amplitudes (same orbital dimensions required; otherwise a
    cold MP2 start).  Each call makes a fresh driver, ``scanner.cc``, on the
    template driver's device and dtype."""

    def __init__(self, cc):
        self.cc = cc
        self._mf_scan = cc._scf.as_scanner()
        self.e_tot = None
        self.converged = cc.converged

    def __call__(self, mol_or_atom, dm0=None):
        old = self.cc
        self._mf_scan(mol_or_atom, dm0=dm0)
        mf = self._mf_scan.mf
        cc = type(old)(mf, frozen=old.frozen, device=old.device,
                       dtype=old.dtype)
        for k in ("conv_tol", "conv_tol_normt", "max_cycle", "diis_space",
                  "level_shift", "verbose"):
            setattr(cc, k, getattr(old, k))
        if hasattr(old, "ntile"):
            cc.ntile = old.ntile
        # the same nao, nelec and frozen give the same amplitude shapes
        t1 = t2 = None
        if old.t1 is not None and mf.mol.nao == old.mol.nao \
                and mf.mol.nelec == old.mol.nelec:
            t1, t2 = old.t1, old.t2
        cc.kernel(t1=t1, t2=t2)
        self.cc = cc
        self.e_tot = cc.e_tot
        self.converged = bool(mf.converged and cc.converged)
        return cc.e_tot


def CCSD(mf, frozen=0, mo_coeff=None, *, device=None, dtype=None):
    """Factory mirroring the reference's cc.CCSD dispatch: UHF/ROHF (or a
    spin-resolved mo_coeff) -> UCCSDDriver, RHF -> RCCSDDriver."""
    if isinstance(mf, UHF) or np.asarray(mf.mo_coeff).ndim == 3:
        return UCCSDDriver(mf, frozen, mo_coeff, device=device, dtype=dtype)
    return RCCSDDriver(mf, frozen, mo_coeff, device=device, dtype=dtype)
