"""Restricted MP2: canonical, SCS split, density-fitted, and the
non-canonical iterative solver the MP-CC workflow needs.

Port of ``pyscf_mpcc_tpu/mp/mp2.py`` (the reference's mp/mp2.py kernel
:34, _iterative_kernel :99, update_amps :150): plain functions on tensors,
run on the device the tensors live on.  ``iterative_kernel`` extrapolates
with the host DIIS (``lib.diis``) or the device ring
(``lib.device_diis``), the residual as the error vector in both.
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.convert import to_numpy

einsum = torch.einsum


def energy_from_t2(t2, ovov):
    """E_corr from spatial t2[ijab] and chemists (ia|jb)."""
    ed = 2.0 * einsum("ijab,iajb->", t2, ovov)
    ex = -einsum("ijab,ibja->", t2, ovov)
    return ed + ex


def _denom(eo_i, eo_j, ev_a, ev_b):
    """D[i,j,a,b] = e_i + e_j - e_a - e_b."""
    return (eo_i[:, None, None, None] + eo_j[None, :, None, None]
            - ev_a[None, None, :, None] - ev_b[None, None, None, :])


def kernel(mo_energy_occ, mo_energy_vir, ovov):
    """Canonical RMP2.  ovov: (ia|jb) chemists MO integrals
    (nocc, nvir, nocc, nvir).

    Returns (e_mp2, t2) with t2[i,j,a,b] = (ia|jb)/D_ijab.
    """
    eo, ev = mo_energy_occ, mo_energy_vir
    t2 = ovov.permute(0, 2, 1, 3) / _denom(eo, eo, ev, ev)
    return energy_from_t2(t2, ovov), t2


def kernel_ss_os(mo_energy_occ, mo_energy_vir, ovov):
    """MP2 with same-spin / opposite-spin decomposition (for SCS-MP2).

    e_os is the direct term and e_ss = e_os - exchange, the JAX package's
    definitions (mp/mp2.py:45-46): e_ss + e_os is E_MP2."""
    eo, ev = mo_energy_occ, mo_energy_vir
    t2 = ovov.permute(0, 2, 1, 3) / _denom(eo, eo, ev, ev)
    e_os = einsum("ijab,iajb->", t2, ovov)
    e_ss = e_os - einsum("ijab,ibja->", t2, ovov)
    return e_ss, e_os


def df_kernel(mo_energy_occ, mo_energy_vir, Lov):
    """DF-MP2 from 3-center factors Lov[P, i, a] (B tensor in MO basis):
    (ia|jb) as one GEMM over the aux axis."""
    eo, ev = mo_energy_occ, mo_energy_vir
    naux, nocc, nvir = Lov.shape
    L2 = Lov.reshape(naux, nocc * nvir)
    ovov = (L2.T @ L2).view(nocc, nvir, nocc, nvir)
    t2 = ovov.permute(0, 2, 1, 3) / _denom(eo, eo, ev, ev)
    return energy_from_t2(t2, ovov), t2


def update_amps(t2, ovov, foo, fvv):
    """One Jacobi sweep of the non-canonical MP2 residual.

    R_ijab = (ia|jb) + sum_c fvv[a,c] t2_ijcb + sum_c t2_ijac fvv[b,c]
                     - sum_k foo[i,k] t2_kjab - sum_k t2_ikab foo[j,k]
    solved as t2 <- t2 + R / D with D from the Fock diagonals (the off-
    diagonal Fock pieces stay in R).  Returns (t2_new, R).  R accumulates
    in place, in the JAX package's order of terms, so at most two
    t2-sized temporaries are live."""
    eo = torch.diagonal(foo)
    ev = torch.diagonal(fvv)
    r = ovov.permute(0, 2, 1, 3) + einsum("ac,ijcb->ijab", fvv, t2)
    r += einsum("bc,ijac->ijab", fvv, t2)
    r -= einsum("ik,kjab->ijab", foo, t2)
    r -= einsum("jk,ikab->ijab", foo, t2)
    t2new = r / _denom(eo, eo, ev, ev)
    t2new += t2
    return t2new, r


def iterative_kernel(ovov, foo, fvv, max_cycle=100, conv_tol=1e-9,
                     diis_space=6, verbose=0, diis_backend="host"):
    """Non-canonical iterative MP2 (DIIS on t2), for localized-orbital Fock.

    Role of reference mp/mp2.py:99 (_iterative_kernel).  Jacobi sweeps on
    the tensors' device; diis_backend='host' extrapolates with the host
    ``lib.diis.DIIS`` (t2 and R copied to the host each cycle),
    'device' with the ring on the device (``device_diis.update_hostsolve``,
    only the Gram matrix crosses).  Returns (e, t2, converged)."""
    from pyscf_mpcc_tpu_torch.lib import device_diis
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    if diis_backend not in ("host", "device"):
        raise ValueError(f"unknown diis_backend {diis_backend!r}")
    log = lg.Logger(verbose=verbose)
    nocc, nvir = ovov.shape[0], ovov.shape[1]
    shape = (nocc, nocc, nvir, nvir)
    dev, dt = ovov.device, ovov.dtype
    t2 = torch.zeros(shape, dtype=dt, device=dev)
    if diis_backend == "device":
        dstate = device_diis.init(t2.numel(), diis_space, dt, device=dev)
    else:
        diis = DIIS(space=diis_space)
    e_last = 0.0
    converged = False
    for it in range(max_cycle):
        t2, r = update_amps(t2, ovov, foo, fvv)
        if diis_backend == "device":
            dstate, vec = device_diis.update_hostsolve(
                dstate, t2.reshape(-1), r.reshape(-1))
            del t2, r
            t2 = vec.view(shape)
        else:
            vec = diis.update(to_numpy(t2), xerr=to_numpy(r))
            del t2, r
            t2 = torch.from_numpy(vec.reshape(shape)).to(dev, dt)
        e = float(energy_from_t2(t2, ovov))
        log.info("MP2 cycle %d  E = %.12f  dE = %.3e", it, e, e - e_last)
        if abs(e - e_last) < conv_tol:
            converged = True
            break
        e_last = e
    return e, t2, converged


def make_rdm1_vv(t2):
    """Virtual-virtual block of the unrelaxed MP2 density (FNO metric).

    P_ab = 2 sum_ijc t2[ijac] (2 t2[ijbc] - t2[ijcb])."""
    theta = 2.0 * t2 - t2.permute(0, 1, 3, 2)
    return 2.0 * einsum("ijac,ijbc->ab", t2, theta)


def make_rdm1(t2, nocc):
    """Unrelaxed MP2 one-particle density (MO basis), HF part included."""
    nvir = t2.shape[2]
    theta = 2.0 * t2 - t2.permute(0, 1, 3, 2)
    doo = -2.0 * einsum("ikab,jkab->ij", t2, theta)
    dvv = 2.0 * einsum("ijac,ijbc->ab", t2, theta)
    dm = torch.zeros((nocc + nvir, nocc + nvir), dtype=t2.dtype,
                     device=t2.device)
    dm[:nocc, :nocc] = 2.0 * torch.eye(nocc, dtype=t2.dtype,
                                       device=t2.device) + doo
    dm[nocc:, nocc:] = dvv
    return dm


def make_fno(t2, mo_energy, mo_coeff, nocc, thresh=1e-6, nvir_act=None):
    """Frozen-natural-orbital builder (reference mp/mp2.py:239).

    Diagonalizes the MP2 vv-density (on the host, as the JAX package
    does); returns (no_coeff, n_keep, occupations) where no_coeff has
    virtuals rotated to natural orbitals ordered by occupation (kept block
    first)."""
    dvv = to_numpy(make_rdm1_vv(t2))
    w, v = np.linalg.eigh(dvv)
    order = np.argsort(w)[::-1]
    w, v = w[order], v[:, order]
    if nvir_act is None:
        n_keep = int((w > thresh).sum())
    else:
        n_keep = int(nvir_act)
    mo = np.array(to_numpy(mo_coeff) if torch.is_tensor(mo_coeff)
                  else mo_coeff)
    mo[:, nocc:] = mo[:, nocc:] @ v
    return mo, n_keep, w
