"""User-facing CCSD method object.

Port of the restricted part of ``pyscf_mpcc_tpu/cc/driver.py``:
``CCSD(mf, device=...).run()`` then ``.ccsd_t()``.  Frozen core via an
integer ``frozen`` (lowest orbitals dropped from the correlation space).
The device defaults to CUDA (lib/device.resolve; pass
``device=torch.device("cpu")`` for the CPU); the dtype follows lib/device
(fp64 on the CPU, fp32 with TF32 off on CUDA) unless given.
"""

from __future__ import annotations

import numpy as np

from pyscf_mpcc_tpu_torch import config, gto
from pyscf_mpcc_tpu_torch.lib import logger
from pyscf_mpcc_tpu_torch.lib.stream import StreamObject
from pyscf_mpcc_tpu_torch.cc import ccsd_t as ccsd_t_mod
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.cc import rccsd
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.scf.hf import RHF


def _not_ported(what, item):
    raise NotImplementedError(f"{what} is ROADMAP {item}, not ported yet")


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
    def kernel(self, t1=None, t2=None, eris=None):
        log = logger.Logger(verbose=self.verbose)
        tic = log.timer("")
        if eris is None:
            eris = self.eris or self.ao2mo()
            tic = log.timer("CCSD integral transform", *tic)
        ntile = self.ntile
        if not ntile and eris.Lvv is not None:
            from pyscf_mpcc_tpu_torch.lib import memory as _mem
            ntile = _mem.plan_ladder_ntile(self.nocc, self.nmo - self.nocc,
                                           eris.Lvv.shape[0], self.dtype,
                                           device=self.device)
        self.converged, self.e_corr, self.t1, self.t2 = rccsd.kernel(
            eris, max_cycle=self.max_cycle, conv_tol=self.conv_tol,
            conv_tol_normt=self.conv_tol_normt, diis_space=self.diis_space,
            level_shift=self.level_shift, t1=t1, t2=t2,
            ntile=max(ntile, 1), diis_file=self.diis_file)
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

    def solve_lambda(self, *args, **kwargs):
        _not_ported("Lambda (cc/lambda_ad)", "A6")

    def make_rdm1(self, *args, **kwargs):
        _not_ported("CCSD RDMs (cc/lambda_ad.make_rdm12)", "A6")

    make_rdm2 = make_rdm12 = make_rdm1

    def eeccsd(self, *args, **kwargs):
        _not_ported("EOM-CCSD (cc/eom)", "A14")

    ipccsd = eaccsd = eomsf_ccsd = eeccsd

    def as_scanner(self):
        _not_ported("the CCSD geometry scanner", "A7")


def CCSD(mf, frozen=0, mo_coeff=None, *, device=None, dtype=None):
    """Factory mirroring the reference's cc.CCSD dispatch; closed-shell
    RHF references only (UCCSD is ROADMAP A11)."""
    if not isinstance(mf, RHF) or np.asarray(mf.mo_coeff).ndim != 2:
        _not_ported(f"CCSD on {type(mf).__name__}", "A11 (open shell)")
    return RCCSDDriver(mf, frozen, mo_coeff, device=device, dtype=dtype)
