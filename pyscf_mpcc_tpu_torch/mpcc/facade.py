"""User-facing MPCC object mirroring the reference facade
(pyscf/mpcc/__init__.py:3, mpcc/mpcc.py:5): dispatch on the mean field,
run the DF low-level solver on init, expose the fragmented MP-CC pipeline.

Port of ``pyscf_mpcc_tpu/mpcc/facade.py``.  The Loo/Lov/Lvv factors are
transformed on the device (``cc.eris.df_factors``, fp64 transforms), not
in host NumPy: at (H2O)8/cc-pVTZ the host einsum would be 2 GB.
"""

from __future__ import annotations

import numpy as np

from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.mpcc import lowlevel as lowlevel_mod
from pyscf_mpcc_tpu_torch.mpcc import rmpccsd as rmpccsd_mod
from pyscf_mpcc_tpu_torch.mpcc import workflow as workflow_mod


class MPCC:
    """Restricted MP-CC driver.

    Like the reference, requires a DF mean field (the low-level solver is
    DF-native); rejects unrestricted references, as the JAX package's
    facade does (``mpcc.umpccsd`` and the unrestricted workflow take
    them).  Runs on the CUDA device unless a CPU device is passed, in
    lib/device's dtype unless one is given.
    """

    def __init__(self, mf, run_lowlevel=True, *, device=None, dtype=None):
        if np.asarray(mf.mo_coeff).ndim == 3:
            raise NotImplementedError("MPCC requires an RHF reference")
        self.device, self.dtype = _dev.resolve(device, dtype)
        self._scf = mf
        self.mol = mf.mol
        if getattr(mf, "with_df", None) is None:
            mf.density_fit()
        self.with_df = mf.with_df
        self.nocc = self.mol.nelectron // 2
        self.e_lowlevel = None
        self.t1_ll = self.t2_ll = None
        if run_lowlevel:
            self.run_lowlevel()

    def _mo_factors(self):
        return eris_mod.df_factors(self.with_df.B_ao(), self._scf.mo_coeff,
                                   self.nocc, self.dtype, device=self.device)

    def run_lowlevel(self, conv_tol=1e-8):
        Loo, Lov, Lvv = self._mo_factors()
        mo = np.asarray(self._scf.mo_coeff)
        fock_mo = mo.T @ self._scf.get_fock(self._scf.make_rdm1()) @ mo
        conv, e, t1, t2 = lowlevel_mod.kernel(Loo, Lov, Lvv, fock_mo,
                                              self.nocc, conv_tol=conv_tol)
        self.e_lowlevel = e
        self.t1_ll, self.t2_ll = t1, t2
        return e

    def kernel(self, act_hole, act_particle, idx_s, idx_d, **kwargs):
        """High-level MP-CC on the given active space (canonical basis)."""
        from pyscf_mpcc_tpu_torch.cc import driver as cc_driver
        cc = cc_driver.RCCSDDriver(self._scf, device=self.device,
                                   dtype=self.dtype)
        eris = cc.ao2mo()
        conv, e, t1, t2 = rmpccsd_mod.kernel(
            eris, act_hole, act_particle, idx_s, idx_d, **kwargs)
        self.converged, self.e_corr, self.t1, self.t2 = conv, e, t1, t2
        return e

    def fragmented(self, fragments, idx_s, idx_d, **kwargs):
        return workflow_mod.fragmented_mpcc(
            self.mol, self._scf, fragments, idx_s, idx_d,
            device=self.device, dtype=self.dtype, **kwargs)
