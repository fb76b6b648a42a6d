"""Active-space iterative triples (spin-orbital, CCSDT-1 level).

Capability match for the fork's coupled active-space T3
(pyscf/cc/umpcc_t_slow.py:1831 iterative_update_amps_t3, consumed through
the pert_triples path of umpccsd.py:2183): T3 amplitudes restricted to an
active block are solved iteratively alongside t1/t2 and fed back into the
t1/t2 residuals.

Equations (spin-orbital, CCSDT-1):
    D3 t3 = P(i/jk) P(a/bc) [ sum_e t2_jkae <ei||bc> - sum_m t2_imbc <ma||jk> ]
    R1   += 1/4 sum_mnef <mn||ef> t3_imnaef
    R2   += sum_me f_me t3_ijmabe
            - 1/2 P(ab) sum_mef <mb||ef> t3_ijmaef
            - 1/2 P(ij) sum_mne <mn||je> t3_imnabe
The T3->T1/T2 feedback contractions are locked against first principles:
tests fit them to exact <mu| H T3 |0> determinant-space matrix elements
from ci.fci_slow (coefficients reproduce 1, -1/2, -1/2 to 1e-16).

Active-space restriction: a boolean mask over (ijk, abc) zeroes the
inactive t3 blocks each sweep — the fork's freeze semantics applied to the
triples sector.

A host copy of the JAX package's cc/gccsdt1_slow.py (NumPy, its imports pointed at
the port).
"""

from __future__ import annotations

import numpy as np

from pyscf_mpcc_tpu_torch.lib.diis import DIIS
from pyscf_mpcc_tpu_torch.lib import logger as lg
from pyscf_mpcc_tpu_torch.cc import gccsd_slow


def t3_mask(act_hole, act_particle, nocc, nvir):
    """t3 active-block mask: all six indices active."""
    oh = np.zeros(nocc, dtype=bool)
    oh[np.asarray(act_hole, dtype=int)] = True
    pv = np.zeros(nvir, dtype=bool)
    pv[np.asarray(act_particle, dtype=int)] = True
    m = (oh[:, None, None, None, None, None]
         & oh[None, :, None, None, None, None]
         & oh[None, None, :, None, None, None]
         & pv[None, None, None, :, None, None]
         & pv[None, None, None, None, :, None]
         & pv[None, None, None, None, None, :])
    return m


def t3_w(t2, eris):
    """The jointly-symmetrized triples generator W (same contraction set as
    the validated (T) kernel, kept as a full tensor)."""
    ovvv = eris.block("ovvv")
    ooov = eris.block("ooov")

    # g[ijkabc] = sum_e t2_jkae <ei||bc> - sum_m t2_imbc <ma||jk>
    g = np.einsum("jkae,iecb->ijkabc", t2, ovvv)
    g -= np.einsum("imbc,jkma->ijkabc", t2, ooov)
    # P(i/jk) P(a/bc)
    w = g - g.transpose(1, 0, 2, 3, 4, 5) - g.transpose(2, 1, 0, 3, 4, 5)
    w = w - w.transpose(0, 1, 2, 4, 3, 5) - w.transpose(0, 1, 2, 5, 4, 3)
    return w


def t3_update(t2, eris, mask=None):
    """Jacobi solution of the CCSDT-1 triples equation: t3 = W / D3."""
    nocc = eris.nocc
    eo = np.diag(eris.fock)[:nocc]
    ev = np.diag(eris.fock)[nocc:]
    d3 = (eo[:, None, None, None, None, None]
          + eo[None, :, None, None, None, None]
          + eo[None, None, :, None, None, None]
          - ev[None, None, None, :, None, None]
          - ev[None, None, None, None, :, None]
          - ev[None, None, None, None, None, :])
    t3 = t3_w(t2, eris) / d3
    if mask is not None:
        t3 = np.where(mask, t3, 0.0)
    return t3


def feedback(t3, eris):
    """T3 -> (R1, R2) additions (coefficients validated vs ci.fci_slow)."""
    nocc = eris.nocc
    fov = eris.fock[:nocc, nocc:]
    oovv = eris.block("oovv")
    ovvv = eris.block("ovvv")
    ooov = eris.block("ooov")
    r1 = 0.25 * np.einsum("mnef,imnaef->ia", oovv, t3)
    r2 = np.einsum("me,ijmabe->ijab", fov, t3)
    x = np.einsum("mbef,ijmaef->ijab", ovvv, t3)
    r2 -= 0.5 * (x - x.transpose(0, 1, 3, 2))
    y = np.einsum("mnje,imnabe->ijab", ooov, t3)
    r2 -= 0.5 * (y - y.transpose(1, 0, 2, 3))
    return r1, r2


def kernel(eris, act_hole=None, act_particle=None, max_cycle=100,
           conv_tol=1e-9, conv_tol_normt=1e-7, diis_space=6, verbose=0,
           t1=None, t2=None):
    """CCSD + iterative active-space T3 (CCSDT-1 coupling).

    act_hole/act_particle = None solves the full T3 space; index arrays
    restrict the triples to the active block (the fork's pert_triples).
    Returns (e_corr, t1, t2, t3, converged)."""
    log = lg.Logger(verbose=verbose)
    nocc = eris.nocc
    eo = np.diag(eris.fock)[:nocc]
    ev = np.diag(eris.fock)[nocc:]
    d1 = eo[:, None] - ev[None, :]
    d2 = (eo[:, None, None, None] + eo[None, :, None, None]
          - ev[None, None, :, None] - ev[None, None, None, :])

    emp2, t1_0, t2_0 = gccsd_slow.init_amps(eris)
    if t1 is None:
        t1 = t1_0
    if t2 is None:
        t2 = t2_0
    nvir = t1.shape[1]
    mask = None
    if act_hole is not None:
        mask = t3_mask(act_hole, act_particle, nocc, nvir)
    t3 = np.zeros((nocc,) * 3 + (nvir,) * 3)
    diis = DIIS(space=diis_space)
    e_last = gccsd_slow.energy(t1, t2, eris)
    converged = False
    e = e_last
    for it in range(max_cycle):
        t3 = t3_update(t2, eris, mask)
        r1_add, r2_add = feedback(t3, eris)
        t1n, t2n = gccsd_slow.update_amps(t1, t2, eris)
        t1n = t1n + r1_add / d1
        t2n = t2n + r2_add / d2
        normt = np.linalg.norm(t1n - t1) + np.linalg.norm(t2n - t2)
        vec = np.concatenate([t1n.ravel(), t2n.ravel()])
        vec = diis.update(vec)
        t1 = vec[: t1.size].reshape(t1.shape)
        t2 = vec[t1.size:].reshape(t2.shape)
        e = gccsd_slow.energy(t1, t2, eris)
        log.info("cycle %2d  E(CCSDT-1%s) = %.12f  dE = %9.3e  |dt| = %9.3e",
                 it, "-act" if mask is not None else "", e, e - e_last, normt)
        if abs(e - e_last) < conv_tol and normt < conv_tol_normt:
            converged = True
            break
        e_last = e
    return float(e), t1, t2, t3, converged
