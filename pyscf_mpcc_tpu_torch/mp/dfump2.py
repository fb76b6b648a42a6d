"""DF-UMP2 with unrelaxed and orbital-relaxed densities.

Port of ``pyscf_mpcc_tpu/mp/dfump2.py``: the construction of mp/dfmp2.py
generalized to per-spin orbital rotations,

  * the UMP2 Hylleraas functional over the (aa, ab, bb) channels,
    stationary in t,
  * its orbital gradient by ``torch.func.grad`` under per-spin Cayley
    rotations,
  * CPHF with the exact UHF-energy Hessian-vector product (``jvp`` of
    ``grad``), solved by conjugate gradients over the stacked (za, zb)
    vector (mp/dfmp2._cg, JAX's stopping rule),
  * the relaxed density as d/dh of the stationary Lagrangian.

Every three-operand contraction is written as explicit pairs: without
opt_einsum torch contracts left to right, and the JAX code's
``Lpr,Lqs,rs->pq`` would then build an nao^4 intermediate.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jvp

from pyscf_mpcc_tpu_torch.cc.eris import _pair
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.mp.dfmp2 import _cayley, _cg, _jk, _mo_factor

einsum = torch.einsum


def _orbs(kaps, C0s, noccs):
    return tuple(C0 @ _cayley(k, no, C0.shape[1])
                 for k, C0, no in zip(kaps, C0s, noccs))


def _spin_jk(B_ao, Pa, Pb):
    """(J[Pa + Pb], K[Pa], K[Pb])."""
    J, _ = _jk(B_ao, Pa + Pb)
    return J, _jk(B_ao, Pa)[1], _jk(B_ao, Pb)[1]


def _e_hf(kaps, h, B_ao, C0s, noccs):
    Ca, Cb = _orbs(kaps, C0s, noccs)
    Pa = Ca[:, :noccs[0]] @ Ca[:, :noccs[0]].T
    Pb = Cb[:, :noccs[1]] @ Cb[:, :noccs[1]].T
    J, Ka, Kb = _spin_jk(B_ao, Pa, Pb)
    return (torch.sum((Pa + Pb) * h)
            + 0.5 * (torch.sum((Pa + Pb) * J)
                     - torch.sum(Pa * Ka) - torch.sum(Pb * Kb)))


def _ft(t, foo1, foo2, fvv1, fvv2):
    return (einsum("ac,ijcb->ijab", fvv1, t)
            + einsum("bc,ijac->ijab", fvv2, t)
            - einsum("ik,kjab->ijab", foo1, t)
            - einsum("jk,ikab->ijab", foo2, t))


def _ijab(L1, L2):
    """g[i,j,a,b] = (ia|jb) from L[L,i,a] factors, one GEMM."""
    return _pair(L1, L2).permute(0, 2, 1, 3)


def _e_hyl(kaps, h, B_ao, C0s, noccs, t2s):
    """UMP2 Hylleraas functional at fixed (t2aa, t2ab, t2bb)."""
    taa, tab, tbb = t2s
    Ca, Cb = _orbs(kaps, C0s, noccs)
    na, nb = noccs
    Pa = Ca[:, :na] @ Ca[:, :na].T
    Pb = Cb[:, :nb] @ Cb[:, :nb].T
    J, Ka, Kb = _spin_jk(B_ao, Pa, Pb)
    fa_ao = h + J - Ka
    fb_ao = h + J - Kb
    Lov_a = _mo_factor(B_ao, Ca[:, :na], Ca[:, na:])
    Lov_b = _mo_factor(B_ao, Cb[:, :nb], Cb[:, nb:])
    gaa = _ijab(Lov_a, Lov_a)
    gbb = _ijab(Lov_b, Lov_b)
    gab = _ijab(Lov_a, Lov_b)
    gaa = gaa - gaa.permute(0, 1, 3, 2)
    gbb = gbb - gbb.permute(0, 1, 3, 2)
    fooa = Ca[:, :na].T @ fa_ao @ Ca[:, :na]
    fvva = Ca[:, na:].T @ fa_ao @ Ca[:, na:]
    foob = Cb[:, :nb].T @ fb_ao @ Cb[:, :nb]
    fvvb = Cb[:, nb:].T @ fb_ao @ Cb[:, nb:]
    e = 0.25 * einsum("ijab,ijab->", taa,
                      2 * gaa + _ft(taa, fooa, fooa, fvva, fvva))
    e = e + 0.25 * einsum("ijab,ijab->", tbb,
                          2 * gbb + _ft(tbb, foob, foob, fvvb, fvvb))
    return e + einsum("ijab,ijab->", tab,
                      2 * gab + _ft(tab, fooa, foob, fvva, fvvb))


def _relaxed_rdm1_ao(B_ao, Ca0, Cb0, h_ao, t2s, na, nb):
    C0s = (Ca0, Cb0)
    noccs = (na, nb)
    k0 = (torch.zeros((Ca0.shape[1] - na, na), dtype=h_ao.dtype,
                      device=h_ao.device),
          torch.zeros((Cb0.shape[1] - nb, nb), dtype=h_ao.dtype,
                      device=h_ao.device))
    n_a = k0[0].numel()

    def e_hf(k, h):
        return _e_hf(k, h, B_ao, C0s, noccs)

    def e_hyl(k, h):
        return _e_hyl(k, h, B_ao, C0s, noccs, t2s)

    def split(v):
        return (v[:n_a].view(k0[0].shape), v[n_a:].view(k0[1].shape))

    def flat(ks):
        return torch.cat([x.reshape(-1) for x in ks])

    g_hyl = grad(e_hyl, argnums=0)(k0, h_ao)
    g_hf_fn = grad(e_hf, argnums=0)

    def hvp(z):
        return flat(jvp(lambda k: g_hf_fn(k, h_ao), (k0,), (split(z),))[1])

    z = split(_cg(hvp, -flat(g_hyl), tol=1e-10, maxiter=200))

    def lagrangian(h):
        gk = g_hf_fn(k0, h)
        return (e_hf(k0, h) + e_hyl(k0, h)
                + sum(torch.sum(a * b) for a, b in zip(z, gk)))

    return grad(lagrangian)(h_ao)


class DFUMP2:
    """DF-UMP2 with unrelaxed and relaxed densities and natural orbitals
    (frozen=0).  Runs on the CUDA device unless a CPU device is passed;
    the dtype follows lib/device unless given.  Densities and natural
    orbitals are tensors on that device; the relaxed density's CG stops
    at 1e-10 of its right-hand side, which needs fp64."""

    def __init__(self, mf, auxbasis=None, *, device=None, dtype=None):
        self.device, self.dtype = _dev.resolve(device, dtype)
        if getattr(mf, "with_df", None) is None:
            mf = mf.density_fit(auxbasis)
        self._scf = mf
        self.mol = mf.mol
        mo = np.asarray(mf.mo_coeff)
        moe = np.asarray(mf.mo_energy)
        if mo.ndim == 2:
            mo = np.array([mo, mo])
            moe = np.array([moe, moe])
        self.mo_coeff = mo
        self.mo_energy = moe
        self.nocc = self.mol.nelec
        self.e_corr = None
        self.t2 = None
        self._B_ao = None

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    @property
    def B_ao(self):
        if self._B_ao is None:
            self._B_ao = self._tensor(self._scf.with_df.B_ao())
        return self._B_ao

    def kernel(self):
        Ls, ens = [], []
        for s, no in enumerate(self.nocc):
            C = self._tensor(self.mo_coeff[s])
            Ls.append(_mo_factor(self.B_ao, C[:, :no], C[:, no:]))
            e = self._tensor(self.mo_energy[s])
            ens.append((e[:no], e[no:]))

        def d(e1, e2):
            return (e1[0][:, None, None, None] + e2[0][None, :, None, None]
                    - e1[1][None, None, :, None]
                    - e2[1][None, None, None, :])

        gaa = _ijab(Ls[0], Ls[0])
        gbb = _ijab(Ls[1], Ls[1])
        gab = _ijab(Ls[0], Ls[1])
        gaa = gaa - gaa.permute(0, 1, 3, 2)
        gbb = gbb - gbb.permute(0, 1, 3, 2)
        taa = gaa / d(ens[0], ens[0])
        tbb = gbb / d(ens[1], ens[1])
        tab = gab / d(ens[0], ens[1])
        self.t2 = (taa, tab, tbb)
        self.e_corr = float(0.25 * einsum("ijab,ijab->", taa, gaa)
                            + 0.25 * einsum("ijab,ijab->", tbb, gbb)
                            + einsum("ijab,ijab->", tab, gab))
        return self.e_corr

    def run(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        self.kernel()
        return self

    @property
    def e_tot(self):
        return self._scf.e_tot + self.e_corr

    def make_rdm1(self, relaxed=False, ao_repr=True):
        """Total (alpha + beta) AO density; relaxed includes the Z-vector
        orbital response."""
        if self.t2 is None:
            self.kernel()
        if relaxed:
            return _relaxed_rdm1_ao(
                self.B_ao, self._tensor(self.mo_coeff[0]),
                self._tensor(self.mo_coeff[1]),
                self._tensor(self._scf.get_hcore()), self.t2, *self.nocc)
        taa, tab, tbb = self.t2
        dooa = -0.5 * einsum("ikab,jkab->ij", taa, taa) \
            - einsum("ikab,jkab->ij", tab, tab)
        doob = -0.5 * einsum("ikab,jkab->ij", tbb, tbb) \
            - einsum("kiab,kjab->ij", tab, tab)
        dvva = 0.5 * einsum("ijac,ijbc->ab", taa, taa) \
            + einsum("ijac,ijbc->ab", tab, tab)
        dvvb = 0.5 * einsum("ijac,ijbc->ab", tbb, tbb) \
            + einsum("ijca,ijcb->ab", tab, tab)
        out = 0.0
        for s, (doo, dvv, no) in enumerate((
                (dooa, dvva, self.nocc[0]), (doob, dvvb, self.nocc[1]))):
            C = self._tensor(self.mo_coeff[s])
            co, cv = C[:, :no], C[:, no:]
            eye = torch.eye(no, dtype=self.dtype, device=self.device)
            out = out + co @ (eye + doo) @ co.T + cv @ dvv @ cv.T
        return out

    def make_natorbs(self, relaxed=False):
        """(natural occupations, natural orbitals) of the spin-summed
        density: eigenvectors of S^1/2 D S^1/2, most occupied first."""
        D = self.make_rdm1(relaxed=relaxed)
        S = self._tensor(self._scf.get_ovlp())
        w, v = torch.linalg.eigh(S)
        s_half = (v * torch.sqrt(w)) @ v.T
        s_mhalf = (v / torch.sqrt(w)) @ v.T
        occ, u = torch.linalg.eigh(s_half @ D @ s_half)
        return occ.flip(0), s_mhalf @ u.flip(1)
