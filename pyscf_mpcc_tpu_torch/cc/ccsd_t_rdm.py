"""Lambda-CCSD(T) and CCSD(T) response density matrices by autograd.

Port of ``pyscf_mpcc_tpu/cc/ccsd_t_rdm.py``.  The triples correction
enters the Lambda equations through dE(T)/dt and the density matrices
through the integral dependence of E(T); both come from
``torch.autograd.grad`` of one differentiable (T) energy functional:

    Lambda:   0 = d/dt [ E_CCSD(t) + E_(T)(t) + <lambda, R(t)> ]
    RDMs:     gamma = d/d(integrals) of the stationary Lagrangian

The functional (``e_t_dense``) is the dense statement of the tile math of
cc/ccsd_t.py with one tile over the whole virtual cube, in plain torch:
the CUDA (T) kernels have no backward, and the JAX package differentiates
this functional, not its tile engine.  Autograd keeps W, Z, the
denominator and Z/D, four tensors of nvir^3 nocc^3 elements; so the module
serves small and medium molecules.  The Lambda step is lambda_ad's
(segmented vjp of the residual, host or device DIIS) with E(T) added to
the energy, and the densities are lambda_ad.make_rdm12's with E(T) rebuilt
from the same integrals.
"""

from __future__ import annotations

import torch

from pyscf_mpcc_tpu_torch.cc import lambda_ad

PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def e_t_dense(t1, t2, eris, v_fac=1.0):
    """Differentiable closed-shell (T) energy (a 0-d tensor), dense over
    the virtual cube.  The P-symmetrized integrand is symmetric in
    (a, b, c), so the all-cube sum equals the weighted a>=b>=c triangle of
    the tile engine (weights 1, 1/2, 1/6) times 6.

    v_fac scales the disconnected singles part of V: 1 gives CCSD(T), 2
    QCISD(T)."""
    nocc, nvir = t1.shape
    eo = eris.mo_energy[:nocc]
    ev = eris.mo_energy[nocc:]
    fvo = eris.fock[nocc:, :nocc]
    if eris.ovvv is not None:
        ov = eris.ovvv.permute(1, 3, 0, 2)        # ov[x,y,i,f] = (ix|fy)
    else:
        ov = torch.einsum("Lix,Lfy->xyif", eris.Lov, eris.Lvv)
    # t2T[c,f,j,k] = t2[k,j,c,f]; vooo[a,i,j,m] = (ia|jm)
    t2T = t2.permute(2, 3, 1, 0)
    vooo = eris.ovoo.permute(1, 0, 2, 3)
    oovv = eris.ovov.permute(0, 2, 1, 3)          # oovv[i,j,x,y] = (ix|jy)

    # one dense tile: w and v are the same for every p, only the joint
    # inverse permutation back to the (a,b,c)/(i,j,k) roles changes
    w = torch.einsum("xyif,zfjk->xyzijk", ov, t2T)
    w = w - torch.einsum("xijm,zymk->xyzijk", vooo, t2T)
    v = (0.5 * v_fac) * (torch.einsum("ijxy,kz->xyzijk", oovv, t1)
                         + torch.einsum("yxij,zk->xyzijk", t2T, fvo))
    W = torch.zeros_like(w)
    V = torch.zeros_like(w)
    for p in PERMS:
        inv = (p.index(0), p.index(1), p.index(2))
        axes = inv + tuple(3 + q for q in inv)
        W += w.permute(axes)
        V += v.permute(axes)
    del w, v

    V += W
    Z = (4.0 * V
         + V.permute(0, 1, 2, 4, 5, 3)
         + V.permute(0, 1, 2, 5, 3, 4)
         - 2.0 * V.permute(0, 1, 2, 5, 4, 3)
         - 2.0 * V.permute(0, 1, 2, 3, 5, 4)
         - 2.0 * V.permute(0, 1, 2, 4, 3, 5))
    del V
    eijk = eo[:, None, None] + eo[None, :, None] + eo[None, None, :]
    eabc = ev[:, None, None] + ev[None, :, None] + ev[None, None, :]
    denom = eijk[None, None, None] - eabc[:, :, :, None, None, None]
    return (2.0 / 6.0) * (W * (Z / denom)).sum()


def lambda_kernel(t1, t2, eris, max_cycle=50, conv_tol=1e-7,
                  diis_space=6, verbose=0):
    """Lambda-CCSD(T): solve lambda^T dR/dt = -d(E_CCSD + E_(T))/dt with
    the host DIIS.  Returns (conv, l1, l2); l1/l2 start at t1/t2."""
    return lambda_ad.kernel(t1, t2, eris, max_cycle=max_cycle,
                            conv_tol=conv_tol, diis_space=diis_space,
                            verbose=verbose, e_extra=e_t_dense)


def make_rdm12(h_mo, eri_mo, t1, t2, l1, l2, nocc):
    """CCSD(T) response (rdm1, rdm2) in the MO basis, chemists'
    convention, satisfying E_elec = h.rdm1 + 1/2 eri.rdm2 exactly (the
    stationary E_HF + E_CCSD + E_(T) + <lambda, R>).  l1/l2 from
    :func:`lambda_kernel`."""
    return lambda_ad.make_rdm12(h_mo, eri_mo, t1, t2, l1, l2, nocc,
                                e_extra=e_t_dense)
