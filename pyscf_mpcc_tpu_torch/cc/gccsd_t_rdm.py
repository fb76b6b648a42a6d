"""Lambda-GCCSD(T) and GCCSD(T) response densities by autograd.

Port of ``pyscf_mpcc_tpu/cc/gccsd_t_rdm.py``, the g-spin member of the
(T)-response family: the spin-orbital (T) functional of cc/uccsd_t_rdm.py
is the g-spin algebra, so this module feeds the GCCSD engine's
antisymmetrized GERIs blocks (cc/gccsd.py) into e_t_so and takes
``torch.autograd.grad`` of the same Lagrangian:

    Lambda:   0 = d/dt [ E_GCCSD(t) + E_(T)(t) + <lambda, R(t)> ]
    RDMs:     gamma = d/d(integrals) of the stationary Lagrangian

It works for any spinor reference the GCCSD engine accepts (GHF, or
convert_to_ghf embeddings of R/U references).
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.cc import gccsd
from pyscf_mpcc_tpu_torch.cc.uccsd_t_rdm import e_t_so


def e_t_g(t1, t2, eris_g, v_fac=1.0):
    """Dense differentiable GCCSD(T) energy from a GERIs container."""
    return e_t_so(t1, t2, eris_g.fock, eris_g.b["oovv"],
                  eris_g.b["ooov"], eris_g.b["ovvv"], eris_g.nocc,
                  v_fac=v_fac)


def residual_g(t1, t2, eris_g, variant="ccsd"):
    """GCCSD residual R = (update(t) - t) * D."""
    d1, d2 = gccsd._denoms(eris_g.fock, eris_g.nocc)
    t1n, t2n = gccsd._update(t1, t2, eris_g.b, eris_g.fock,
                             eris_g.nocc, variant=variant)
    return (t1n - t1) * d1, (t2n - t2) * d2


def _leaves(*xs):
    return [x.detach().requires_grad_() for x in xs]


def _step(l1, l2, t1, t2, eris_g, v_fac, with_t):
    """One Jacobi sweep: the energy gradient plus one vjp of the residual.
    Returns (l1new, l2new, res1, res2)."""
    nocc = eris_g.nocc
    d1, d2 = gccsd._denoms(eris_g.fock, nocc)
    with torch.enable_grad():
        a1, a2 = _leaves(t1, t2)
        e = gccsd._energy(a1, a2, eris_g.b["oovv"], eris_g.fock, nocc)
        if with_t:
            e = e + e_t_g(a1, a2, eris_g, v_fac=v_fac)
        de1, de2 = torch.autograd.grad(e, (a1, a2))
        del e
    with torch.enable_grad():
        a1, a2 = _leaves(t1, t2)
        r1, r2 = residual_g(a1, a2, eris_g)
        j1, j2 = torch.autograd.grad((r1, r2), (a1, a2), (l1, l2))
        del r1, r2
    r1 = de1 + j1
    r2 = de2 + j2
    # project onto the antisymmetric doubles manifold
    r2 = 0.25 * (r2 - r2.permute(1, 0, 2, 3) - r2.permute(0, 1, 3, 2)
                 + r2.permute(1, 0, 3, 2))
    return l1 + r1 / d1, l2 + r2 / d2, r1, r2


def lambda_kernel_g(t1, t2, eris_g, max_cycle=60, conv_tol=1e-6,
                    diis_space=6, verbose=0, v_fac=1.0, with_t=True):
    """Lambda-GCCSD(T) (with_t=False: plain Lambda-GCCSD) with the host
    DIIS.  Returns (conv, l1, l2)."""
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    log = lg.Logger(verbose=verbose)
    l1, l2 = t1, t2
    dev, dt = t2.device, t2.dtype
    diis = DIIS(space=diis_space)
    converged = False
    nov = l1.numel()
    for it in range(max_cycle):
        l1n, l2n, r1, r2 = _step(l1, l2, t1, t2, eris_g, v_fac, with_t)
        resn = float(torch.linalg.norm(r1)) + float(torch.linalg.norm(r2))
        vec = np.concatenate([l1n.cpu().numpy().ravel(),
                              l2n.cpu().numpy().ravel()])
        err = np.concatenate([r1.cpu().numpy().ravel(),
                              r2.cpu().numpy().ravel()])
        del l1n, l2n, r1, r2
        vec = torch.from_numpy(diis.update(vec, xerr=err)).to(dev, dt)
        l1 = vec[:nov].reshape(t1.shape)
        l2 = vec[nov:].reshape(t2.shape)
        log.info("glambda(T) cycle %2d  |res| = %9.3e", it, resn)
        if resn < conv_tol:
            converged = True
            break
    return converged, l1, l2


def _g_lagrangian_t(h_so, g_chem, t1, t2, l1, l2, nocc, v_fac=1.0,
                    with_t=True):
    """GHF-CCSD(T) total-energy Lagrangian as a functional of the
    spinor-MO integrals: h_so (nso, nso), g_chem (pq|rs) chemists'."""
    nso = h_so.shape[0]
    occ = torch.zeros(nso, dtype=h_so.dtype, device=h_so.device)
    occ[:nocc] = 1.0
    dm = torch.diag(occ)
    j = torch.einsum("pqrs,rs->pq", g_chem, dm)
    k = torch.einsum("prqs,rs->pq", g_chem, dm)
    fock = h_so + j - k
    e_hf = (dm * h_so).sum() + 0.5 * (dm * (j - k)).sum()
    phys = g_chem.permute(0, 2, 1, 3)
    anti = phys - phys.permute(0, 1, 3, 2)
    sl = {"o": slice(0, nocc), "v": slice(nocc, nso)}
    eris = gccsd.GERIs.__new__(gccsd.GERIs)
    eris.b = {key: anti[tuple(sl[c] for c in key)]
              for key in gccsd.GERIs.BLOCKS}
    eris.fock = fock
    eris.nocc = nocc
    eris.nso = nso
    e = gccsd._energy(t1, t2, eris.b["oovv"], fock, nocc)
    if with_t:
        e = e + e_t_g(t1, t2, eris, v_fac=v_fac)
    r1, r2 = residual_g(t1, t2, eris)
    return e_hf + e + (l1 * r1).sum() + (l2 * r2).sum()


def make_rdm12(h_so, g_chem, t1, t2, l1, l2, nocc, with_t=True):
    """GCCSD(T) response (rdm1, rdm2) in the spinor-MO basis, chemists'
    convention, satisfying E_tot = h.rdm1 + 1/2 g.rdm2 with E_tot the
    stationary CCSD(T) Lagrangian (with_t=False gives the plain GCCSD
    response)."""
    with torch.enable_grad():
        h, g = _leaves(h_so, g_chem)
        lag = _g_lagrangian_t(h, g, t1, t2, l1, l2, nocc, with_t=with_t)
        dh, dg = torch.autograd.grad(lag, (h, g))
    rdm1 = 0.5 * (dh + dh.T)
    rdm2 = 2.0 * dg
    rdm2 = 0.25 * (rdm2 + rdm2.permute(1, 0, 3, 2)
                   + rdm2.permute(2, 3, 0, 1) + rdm2.permute(3, 2, 1, 0))
    return rdm1, rdm2
