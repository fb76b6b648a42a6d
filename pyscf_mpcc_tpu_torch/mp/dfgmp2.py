"""DF-GMP2: density-fitted generalized (spin-orbital) MP2.

Port of ``pyscf_mpcc_tpu/mp/dfgmp2.py`` (the role of the reference's
mp/dfgmp2.py): MP2 over antisymmetrized spin-orbital integrals rebuilt
from the DF 3-center factors.  One spin-orbital ``Lov`` tensor (naux,
nocc_so, nvir_so) with the spin delta built in (entries vanish where the
occupied and virtual spins differ) is made on the device by two
contractions per spin channel; <ij||ab> and the canonical t2 follow from
one einsum chain on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.mp import gmp2 as gmp2_mod

einsum = torch.einsum


def _kernel_from_Lov(Lov, eo, ev):
    """(e_corr, t2) from the spin-orbital DF factor.

    <ij||ab> = (ia|jb) - (ib|ja),  (ia|jb) = sum_L Lov[Lia] Lov[Ljb];
    t2 = <ij||ab>/D;  E = 1/4 <ij||ab> t2."""
    ovov = einsum("Lia,Ljb->iajb", Lov, Lov)
    anti = ovov.permute(0, 2, 1, 3) - ovov.permute(0, 2, 3, 1)
    del ovov
    t2 = anti / gmp2_mod._d2(eo, ev)
    return 0.25 * (anti * t2).sum(), t2


def spinorb_Lov(B_ao, mo_a, mo_b, nelec, frozen=0, *, device=None,
                dtype=None):
    """Spin-orbital DF factor Lov (naux, no, nv) with spin deltas.

    The spin-orbital ordering is cc.gccsd_slow.build_eris's
    ([occ_a, occ_b, vir_a, vir_b]); ``frozen`` drops the lowest ``frozen``
    spatial orbitals per spin."""
    device, dtype = _dev.resolve(device, dtype)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)

    na, nb = nelec
    na, nb = na - frozen, nb - frozen
    mo_a = t(mo_a)[:, frozen:]
    mo_b = t(mo_b)[:, frozen:]
    B = t(B_ao)
    nmo = mo_a.shape[1]
    naux = B.shape[0]
    no, nv = na + nb, 2 * nmo - na - nb

    def half(c_o, c_v):
        x = einsum("Lpq,pi->Liq", B, c_o)
        return einsum("Liq,qa->Lia", x, c_v)

    Lov = B.new_zeros((naux, no, nv))
    Lov[:, :na, :nmo - na] = half(mo_a[:, :na], mo_a[:, na:])
    Lov[:, na:, nmo - na:] = half(mo_b[:, :nb], mo_b[:, nb:])
    return Lov


class DFGMP2:
    """Driver: ``DFGMP2(mf).run()``; the device defaults to the card
    (lib/device.resolve).

    It takes RHF/UHF/ROHF mean fields and density-fits one that is not.
    The RDMs are the spin-orbital gmp2 builders'."""

    def __init__(self, mf, frozen=0, auxbasis=None, *, device=None,
                 dtype=None):
        if getattr(mf, "with_df", None) is None:
            mf = mf.density_fit(auxbasis)
        self._scf = mf
        self.frozen = int(frozen or 0)
        self.device, self.dtype = _dev.resolve(device, dtype)
        self.e_corr = None
        self.t2 = None
        mo = np.asarray(mf.mo_coeff)
        if mo.ndim == 2:                      # RHF / ROHF spatial orbitals
            self._mo_ab = (mo, mo)
        else:                                 # UHF
            self._mo_ab = (mo[0], mo[1])
        self._nelec = mf.mol.nelec
        self.nocc = sum(self._nelec) - 2 * self.frozen

    def _energies_so(self):
        """Spin-orbital orbital energies in [occ_a, occ_b, vir_a, vir_b]
        order, from the SCF's own mo_energy (not a rebuilt Fock, which
        would differ once the J/K builder is density fitted)."""
        me = np.asarray(self._scf.mo_energy)
        if me.ndim == 1:
            ea = eb = me[self.frozen:]
        else:
            ea, eb = me[0][self.frozen:], me[1][self.frozen:]
        na, nb = (n - self.frozen for n in self._nelec)
        return np.concatenate([ea[:na], eb[:nb], ea[na:], eb[nb:]])

    def kernel(self):
        B = self._scf.with_df.B_ao()
        Lov = spinorb_Lov(B, *self._mo_ab, self._nelec, frozen=self.frozen,
                          device=self.device, dtype=self.dtype)
        e_so = torch.tensor(self._energies_so(), device=self.device,
                            dtype=self.dtype)
        no = self.nocc
        e, t2 = _kernel_from_Lov(Lov, e_so[:no], e_so[no:])
        self.e_corr = float(e)
        self.t2 = t2
        return self.e_corr, self.t2

    def run(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        self.kernel()
        return self

    @property
    def e_tot(self):
        return self._scf.e_tot + self.e_corr

    def make_rdm1(self):
        nso = self.nocc + self.t2.shape[2]
        return gmp2_mod.make_rdm1(self.t2, self.nocc, nso).cpu().numpy()

    def make_rdm2(self):
        nso = self.nocc + self.t2.shape[2]
        return gmp2_mod.make_rdm2(self.t2, self.nocc, nso).cpu().numpy()
