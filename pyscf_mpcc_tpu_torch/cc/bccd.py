"""Brueckner coupled cluster doubles (BCCD) and BCCD(T).

Port of ``pyscf_mpcc_tpu/cc/bccd.py`` (the role of the reference's
cc/bccd.py): iterate CCSD (the port's rccsd.kernel on the device) and
absorb the converged singles into an orbital rotation until t1 vanishes,
the Brueckner condition.  The rotations, their DIIS and the polar
restoration of unitarity are host NumPy, as in the JAX package.  BCCD(T)
runs the restricted tile engine (ccsd_t.kernel) with t1 = 0, so on the
card it goes through the CUDA combine or resident kernel.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from pyscf_mpcc_tpu_torch.cc import eris as eris_mod, rccsd
from pyscf_mpcc_tpu_torch.lib import device as _dev

# the (T) tile edge of kernel_t, as in the JAX package
TILE_T = 8


def _kappa(t1):
    """The antisymmetric generator with kappa_ov = -t1."""
    nocc, nvir = t1.shape
    kappa = np.zeros((nocc + nvir,) * 2)
    kappa[:nocc, nocc:] = -t1
    kappa[nocc:, :nocc] = t1.T
    return kappa


def kernel(mf, eri_ao, max_macro=30, t1_tol=1e-5, cc_conv=1e-9,
           verbose=0, diis=True, *, cc_conv_normt=1e-7, device=None,
           dtype=None):
    """BCCD macro-iteration.  Returns (e_corr, mo_brueckner, t2, n_macro),
    t2 a tensor on the device.  cc_conv/cc_conv_normt: the inner CCSD's
    tolerances (the JAX package fixes the second at 1e-7, below what an
    fp32 solve reaches).

    The correlation energy is measured against the original HF
    determinant's energy (e_tot stays comparable)."""
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    device, dtype = _dev.resolve(device, dtype)
    log = lg.Logger(verbose=verbose)
    nocc = mf.mol.nelectron // 2
    mo0 = np.asarray(mf.mo_coeff).copy()
    mo = mo0.copy()
    nmo = mo.shape[1]
    u_tot = np.eye(nmo)
    adiis = DIIS(space=6) if diis else None
    dm_hf = mf.make_rdm1()
    e_hf = mf.e_tot
    eri_t = torch.tensor(np.asarray(eri_ao), device=device,
                         dtype=torch.float64)
    for it in range(max_macro):
        # Fock of the original HF density, in the current orbital basis
        fock_ao = mf.get_fock(dm_hf)
        er = eris_mod.make_eris_incore(eri_t, mo, fock_ao, nocc, dtype,
                                       device=device)
        conv, e_corr, t1, t2 = rccsd.kernel(er, conv_tol=cc_conv,
                                            conv_tol_normt=cc_conv_normt,
                                            max_cycle=100)
        del er
        if not conv:
            raise RuntimeError("CCSD inner loop did not converge")
        t1 = t1.cpu().numpy().astype(np.float64)
        t1max = float(np.abs(t1).max())
        # reference energy of the rotated determinant
        dm_cur = 2.0 * mo[:, :nocc] @ mo[:, :nocc].T
        e_ref = float(0.5 * np.einsum(
            "pq,pq->", dm_cur, mf.get_hcore() + mf.get_fock(dm_cur))
            + mf.e_nuc)
        e_tot = e_ref + float(e_corr)
        log.info("BCCD macro %2d  E_tot = %.12f  max|t1| = %.3e",
                 it, e_tot, t1max)
        if t1max < t1_tol:
            return float(e_tot - e_hf), mo, t2, it + 1
        # accumulate the rotation; DIIS over u with the t1 residual as the
        # Pulay error, then restore unitarity by polar decomposition
        u_tot = u_tot @ scipy.linalg.expm(_kappa(t1))
        if adiis is not None:
            u_tot = adiis.update(u_tot.ravel(),
                                 xerr=t1.ravel()).reshape(nmo, nmo)
            uu, _, vv = np.linalg.svd(u_tot)
            u_tot = uu @ vv
        mo = mo0 @ u_tot
    raise RuntimeError("BCCD did not converge")


def triples_inputs(mf, eri_ao, mo, t2):
    """The (t1, t2, eris) that :func:`kernel_t` hands ccsd_t.kernel: t1 = 0
    and the integrals on the Brueckner orbitals mo, in t2's dtype and on
    its device."""
    nocc = mf.mol.nelectron // 2
    fock_ao = mf.get_fock(mf.make_rdm1())
    er = eris_mod.make_eris_incore(eri_ao, mo, fock_ao, nocc, t2.dtype,
                                   device=t2.device)
    return t2.new_zeros((t2.shape[0], t2.shape[2])), t2, er


def kernel_t(mf, eri_ao, **kw):
    """BCCD(T): the perturbative triples on the converged Brueckner
    orbitals and amplitudes (t1 = 0 by construction, so only the connected
    W survives), at tile edge TILE_T.  kw go to :func:`kernel`.  Returns
    (e_bccd, e_t, mo_brueckner)."""
    from pyscf_mpcc_tpu_torch.cc import ccsd_t
    e_corr, mo, t2, _ = kernel(mf, eri_ao, **kw)
    e_t = ccsd_t.kernel(*triples_inputs(mf, eri_ao, mo, t2), tile=TILE_T)
    return float(e_corr), float(e_t), mo
