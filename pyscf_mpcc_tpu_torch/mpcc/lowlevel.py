"""DF low-level solver for MP-CC: t1-dressed screened-CC2.

Port of ``pyscf_mpcc_tpu/mpcc/lowlevel.py`` (reference:
pyscf/mpcc/dfrmpcc_lowlevel.py:103-152 and cc/umpcc_lowlevel.py, after
Mester, Nagy, Kallay, J. Chem. Phys. 146, 194102 (2017), Table I): all
two-electron quantities flow through t1-dressed 3-center factors

    Xoo[L,i,j] = sum_a Lov[L,i,a] t1[j,a]
    Xvo[L,a,i] = sum_b Lvv[L,a,b] t1[i,b]
    X[L]       = sum_ia Lov[L,i,a] t1[i,a]
    Joo = Loo + Xoo          Jvo = Xvo + Lov^T - Joo . t1
    Jvv[L,b,a] = Lvv[L,b,a] + sum_j Lov[L,j,b] t1[j,a]

with the doubles amplitudes built on the fly (MP2-like from dressed
factors, [a,i,b,j] layout with exchange the (i<->j) transpose) and only
the t1 residual iterated, with the host DIIS (t1 has nocc*nvir elements).
The JAX package's definitions are kept as they are, the energy ``de`` and
the step ``-omega.T / eia`` included.
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.convert import to_numpy

einsum = torch.einsum


def update_amps(t1, Loo, Lov, Lvv, foo_nd, fvv_nd, eia):
    """One sweep.  t1: (nocc, nvir); eia[i,a] = e_a - e_i (positive gaps).

    Returns (t1_new, t2, de, res) with t2 in [a,i,b,j] layout.
    """
    eiaT = eia.T
    Xvo = einsum("Lab,ib->Lai", Lvv, t1)
    Xoo = einsum("Lia,ja->Lij", Lov, t1)
    X = einsum("Lia,ia->L", Lov, t1)

    Joo = Loo + Xoo
    Jvo = Xvo + Lov.permute(0, 2, 1) - einsum("Lij,ja->Lai", Joo, t1)

    omega = -einsum("Laj,Lji->ai", Xvo, Joo)
    omega += einsum("Lja,Lji->ai", einsum("Ljk,ka->Lja", Xoo, t1), Joo)
    omega += einsum("Lai,L->ai", Jvo, X)
    omega += einsum("ib,ba->ai", t1, fvv_nd)
    omega -= einsum("ka,ik->ai", t1, foo_nd)

    Fov = einsum("Lbj,L->jb", Jvo, X) - einsum("Lij,Lib->jb", Xoo, Lov)

    # t2 = (2 g - g^(i<->j)) / D, built in place: a few nvir^2 nocc^2
    # temporaries at most
    g = einsum("Lai,Lbj->aibj", Jvo, Jvo)
    t2 = 2.0 * g
    t2 -= g.permute(0, 3, 2, 1)
    del g
    t2 /= -(eiaT[:, :, None, None] + eiaT[None, None, :, :])

    Yvo = einsum("aibj,jb->ai", t2, Fov)
    omega += Yvo
    Yl = einsum("aibj,Ljb->Lai", t2, Lov)
    Jvv = Lvv + einsum("Ljb,ja->Lba", Lov, t1)
    omega += einsum("Lba,Lbi->ai", Jvv, Yl)
    omega -= einsum("Lji,Laj->ai", Joo, Yl)

    e1 = einsum("Lij,ja->Lai", Xoo, t1) \
        + einsum("L,ia->Lai", X, t1) + Jvo
    de = einsum("Lai,Lai->", e1, Yl)

    t1_new = -omega.T / eia
    res = torch.linalg.norm(t1_new - t1)
    return t1_new, t2, de, res


def kernel(Loo, Lov, Lvv, fock_mo, nocc, max_cycle=100, conv_tol=1e-8,
           diis_space=6, verbose=0):
    """Iterate the low-level t1 with DIIS.  Returns (conv, energy, t1, t2).

    The factors are tensors on one device; fock_mo (array or tensor) is
    read on the host and its blocks go to the factors' device and dtype."""
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    log = lg.Logger(verbose=verbose)
    dev, dt = Lov.device, Lov.dtype

    def tensor(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    fock_mo = (to_numpy(fock_mo) if torch.is_tensor(fock_mo)
               else np.asarray(fock_mo))
    nmo = fock_mo.shape[0]
    eo = np.diag(fock_mo)[:nocc]
    ev = np.diag(fock_mo)[nocc:]
    eia = tensor(ev[None, :] - eo[:, None])  # [i,a], positive gaps
    foo_nd = tensor(fock_mo[:nocc, :nocc] - np.diag(eo))
    fvv_nd = tensor(fock_mo[nocc:, nocc:] - np.diag(ev))
    t1 = torch.zeros((nocc, nmo - nocc), dtype=dt, device=dev)
    diis = DIIS(space=diis_space)
    e_last = 0.0
    converged = False
    de = 0.0
    t2 = None
    for it in range(max_cycle):
        del t2
        t1_new, t2, de, res = update_amps(t1, Loo, Lov, Lvv,
                                          foo_nd, fvv_nd, eia)
        t1 = tensor(diis.update(to_numpy(t1_new), xerr=to_numpy(t1_new - t1))
                    .reshape(t1.shape))
        de_f, res_f = float(de), float(res)
        log.info("LL cycle %2d  E = %.12f  dE = %.3e  |dt1| = %.3e",
                 it, de_f, de_f - e_last, res_f)
        if res_f < conv_tol:
            converged = True
            break
        e_last = de_f
    return converged, float(de), t1, t2
