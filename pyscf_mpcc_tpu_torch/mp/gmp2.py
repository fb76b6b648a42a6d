"""Generalized (spin-orbital) MP2.

Port of ``pyscf_mpcc_tpu/mp/gmp2.py`` (the role of the reference's
mp/gmp2.py: kernel, energy, the non-canonical update_amps, make_rdm1,
make_rdm2 and the GMP2 class): MP2 over antisymmetrized spin-orbital
integrals, the same for RHF/UHF/ROHF references.  The contractions run on
the device; the spin-orbital integrals come from the host oracle
cc.gccsd_slow.eris_from_scf (the RHF/UHF/ROHF -> spin-orbital map and the
frozen orbitals), so the module serves the small molecules that oracle
holds in memory.
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.lib import device as _dev

einsum = torch.einsum


def _d2(eo, ev):
    return (eo[:, None, None, None] + eo[None, :, None, None]
            - ev[None, None, :, None] - ev[None, None, None, :])


def _oovv(eris, device, dtype):
    no = eris.nocc
    return torch.tensor(np.ascontiguousarray(eris.ints[:no, :no, no:, no:]),
                        device=device, dtype=dtype)


def kernel(eris, with_t2=True, *, device=None, dtype=None):
    """(e_mp2, t2) from a cc.gccsd_slow.SpinOrbERIs container.

    t2[i,j,a,b] = <ij||ab> / (e_i + e_j - e_a - e_b);
    E = 1/4 sum <ij||ab> t2[ijab]."""
    device, dtype = _dev.resolve(device, dtype)
    no = eris.nocc
    oovv = _oovv(eris, device, dtype)
    me = torch.tensor(eris.mo_energy, device=device, dtype=dtype)
    t2 = oovv / _d2(me[:no], me[no:])
    e = 0.25 * (oovv * t2).sum()
    return float(e), (t2 if with_t2 else None)


def energy(t2, eris):
    oovv = _oovv(eris, t2.device, t2.dtype)
    return float(0.25 * (oovv * t2).sum())


def update_amps(t2, eris):
    """One non-canonical iteration: the residual with the off-diagonal
    Fock blocks folded in, divided by the diagonal denominator."""
    no = eris.nocc
    fock = torch.tensor(eris.fock, device=t2.device, dtype=t2.dtype)
    foo = fock[:no, :no]
    fvv = fock[no:, no:]
    eo = torch.diagonal(foo)
    ev = torch.diagonal(fvv)
    fvv_nd = fvv - torch.diag(ev)
    foo_nd = foo - torch.diag(eo)
    r = _oovv(eris, t2.device, t2.dtype)
    r = r + einsum("ac,ijcb->ijab", fvv_nd, t2)
    r = r + einsum("bc,ijac->ijab", fvv_nd, t2)
    r = r - einsum("ki,kjab->ijab", foo_nd, t2)
    r = r - einsum("kj,ikab->ijab", foo_nd, t2)
    return r / _d2(eo, ev)


def kernel_iterative(eris, max_cycle=50, tol=1e-10, *, device=None,
                     dtype=None):
    """Iterate the non-canonical update to self-consistency."""
    e, t2 = kernel(eris, device=device, dtype=dtype)
    for _ in range(max_cycle):
        t2new = update_amps(t2, eris)
        if float((t2new - t2).abs().max()) < tol:
            t2 = t2new
            break
        t2 = t2new
    return energy(t2, eris), t2


def make_rdm1(t2, nocc, nso):
    """Spin-orbital MP2 1-RDM in the MO basis, the HF part included."""
    doo = -0.5 * einsum("ikab,jkab->ij", t2, t2)
    dvv = 0.5 * einsum("ijac,ijbc->ab", t2, t2)
    dm = t2.new_zeros((nso, nso))
    dm[:nocc, :nocc] = doo + torch.eye(nocc, dtype=t2.dtype,
                                       device=t2.device)
    dm[nocc:, nocc:] = dvv
    return dm


def make_rdm2(t2, nocc, nso):
    """Spin-orbital MP2 2-RDM in the physicists' convention
    Gamma[p,q,r,s] = <p^+ q^+ s r>, normalized so that

        E_elec = sum_pq h[p,q] gamma[p,q]
                 + 1/4 sum_pqrs <pq||rs> Gamma[p,q,r,s]

    gives E_HF + E_MP2 exactly (the unrelaxed response density; the
    O(t^4) corr x corr separable term is dropped, as at second order)."""
    dm1 = make_rdm1(t2, nocc, nso)
    dm2 = t2.new_zeros((nso,) * 4)
    dm2[:nocc, :nocc, nocc:, nocc:] = t2
    dm2[nocc:, nocc:, :nocc, :nocc] = t2.permute(2, 3, 0, 1).conj()
    hf1 = t2.new_zeros((nso, nso))
    hf1[:nocc, :nocc] = torch.eye(nocc, dtype=t2.dtype, device=t2.device)
    corr1 = dm1 - hf1
    for d1, d2 in ((hf1, hf1), (corr1, hf1), (hf1, corr1)):
        dm2 += einsum("pr,qs->pqrs", d1, d2)
        dm2 -= einsum("ps,qr->pqrs", d1, d2)
    return dm2


class GMP2:
    """Driver object: ``GMP2(mf).run()``; the device defaults to the card
    (lib/device.resolve)."""

    def __init__(self, mf, frozen=0, *, device=None, dtype=None):
        from pyscf_mpcc_tpu_torch.cc import gccsd_slow
        self._scf = mf
        self.frozen = int(frozen or 0)
        self.device, self.dtype = _dev.resolve(device, dtype)
        self.eris = gccsd_slow.eris_from_scf(mf, frozen=self.frozen)
        self.e_corr = None
        self.t2 = None

    def kernel(self):
        self.e_corr, self.t2 = kernel(self.eris, device=self.device,
                                      dtype=self.dtype)
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
        return make_rdm1(self.t2, self.eris.nocc, self.eris.nso).cpu().numpy()

    def make_rdm2(self):
        return make_rdm2(self.t2, self.eris.nocc, self.eris.nso).cpu().numpy()


def kernel_from_scf(mf, *, device=None, dtype=None):
    from pyscf_mpcc_tpu_torch.cc import gccsd_slow
    return kernel(gccsd_slow.eris_from_scf(mf), device=device, dtype=dtype)
