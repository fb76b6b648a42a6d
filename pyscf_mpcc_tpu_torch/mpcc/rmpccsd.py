"""Restricted MP-CC hybrid (RMPCCSD): CCSD relaxation on selected
active-space blocks embedded in a frozen MP2 bath.

Port of ``pyscf_mpcc_tpu/mpcc/rmpccsd.py`` (the reference's
cc/rmpccsd_slow.py, kernel :219, update freeze :172-178): the full RCCSD
residual is evaluated by ``cc.rccsd.update_amps``, then the blocks selected
by idx_s/idx_d are reset through boolean masks (``torch.where``; the masks
are built once a call, on the amplitudes' device).

Semantics: frozen blocks hold the values passed in as the initial t1/t2
(typically non-canonical iterative MP2 amplitudes in a localized basis);
only unfrozen blocks are CC-relaxed.  The JAX package keeps them only
because DIIS coefficients sum to one; in fp32 sum_i c_i x is not x, so
here the frozen blocks are written back from the bath after each
extrapolation (the same function in exact arithmetic).
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.cc import rccsd
from pyscf_mpcc_tpu_torch.cc.eris import RERIs
from pyscf_mpcc_tpu_torch.mp import mp2 as mp2_mod
from pyscf_mpcc_tpu_torch.mpcc.masks import frozen_masks


def update_amps_masked(t1, t2, eris, m1, m2, level_shift=0.0, ntile=1,
                       bath_update="freeze"):
    """CC update with the frozen blocks either held at their incoming
    values ('freeze', the reference's default overwrite semantics) or
    relaxed at MP2 level ('mp2': non-canonical Jacobi MP2 sweep on the
    bath blocks, with the frozen t1 blocks set to zero, as the JAX
    package does — the oo_mp2 update family of umpccsd.py:76-92)."""
    if bath_update not in ("freeze", "mp2"):
        raise ValueError(f"unknown bath_update {bath_update!r}")
    t1new, t2new = rccsd.update_amps(t1, t2, eris, level_shift, ntile=ntile)
    if bath_update == "mp2":
        nocc = eris.nocc
        foo = eris.fock[:nocc, :nocc]
        fvv = eris.fock[nocc:, nocc:]
        t2_mp2, _ = mp2_mod.update_amps(t2, eris.ovov, foo, fvv)
        t1new = torch.where(m1, torch.zeros_like(t1), t1new)
        t2new = torch.where(m2, t2_mp2, t2new)
    else:
        t1new = torch.where(m1, t1, t1new)
        t2new = torch.where(m2, t2, t2new)
    return t1new, t2new


def kernel(eris: RERIs, act_hole, act_particle, idx_s, idx_d,
           t1=None, t2=None, max_cycle=50, conv_tol=1e-8,
           conv_tol_normt=1e-6, diis_space=6, verbose=0, ntile=1,
           bath_update="freeze", diis_backend="host", level_shift=0.0):
    """MP-CC iteration.  Returns (converged, e_corr, t1, t2).

    t1/t2 defaults to the MP2 guess (making the frozen bath = canonical
    MP2); for the fragmented workflow pass localized-basis iterative-MP2
    amplitudes.  diis_backend as in ``rccsd.kernel``: 'host' (the host
    ``lib.diis.DIIS``) or 'device' (the ring on the device, the error the
    step vec_new - vec_old).  level_shift damps the step (the sweep's
    denominators grow by it), as in ``rccsd.kernel``.
    """
    from pyscf_mpcc_tpu_torch.lib import device_diis
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    if diis_backend not in ("host", "device"):
        raise ValueError(f"unknown diis_backend {diis_backend!r}")
    log = lg.Logger(verbose=verbose)
    nocc, nvir = eris.nocc, eris.nvir
    _, t1_0, t2_0 = rccsd.init_amps(eris)
    if t1 is None:
        t1 = t1_0
    if t2 is None:
        t2 = t2_0
    del t1_0, t2_0
    dev, dt = t2.device, t2.dtype
    m1, m2 = (torch.as_tensor(m, device=dev) for m in frozen_masks(
        act_hole, act_particle, nocc, nvir, idx_s, idx_d))
    # the frozen blocks' values, written back after each extrapolation
    bath = (t1, t2) if bath_update == "freeze" else None
    shapes = (t1.shape, t2.shape)
    e_last = float(rccsd.energy(t1, t2, eris))
    log.info("RMPCCSD init E_corr = %.14f", e_last)
    if diis_backend == "device":
        dstate = device_diis.init(t1.numel() + t2.numel(), diis_space, dt,
                                  device=dev)
        vec_old = rccsd._pack(t1, t2)
        t1, t2 = rccsd._unpack(vec_old, *shapes)
    else:
        diis = DIIS(space=diis_space)
    converged = False
    for it in range(max_cycle):
        t1new, t2new = update_amps_masked(t1, t2, eris, m1, m2, level_shift,
                                          ntile=ntile,
                                          bath_update=bath_update)
        normt = float(torch.linalg.norm(t1new - t1)
                      + torch.linalg.norm(t2new - t2))
        del t1, t2
        if diis_backend == "device":
            vec_new = rccsd._pack(t1new, t2new)
            del t1new, t2new
            dstate, vec = device_diis.update_hostsolve(dstate, vec_new,
                                                       vec_new - vec_old)
            del vec_new
        else:
            vec = np.concatenate([t1new.cpu().numpy().ravel(),
                                  t2new.cpu().numpy().ravel()])
            del t1new, t2new
            vec = torch.from_numpy(diis.update(vec)).to(dev, dt)
        t1, t2 = rccsd._unpack(vec, *shapes)
        if bath is not None:
            t1.copy_(torch.where(m1, bath[0], t1))
            t2.copy_(torch.where(m2, bath[1], t2))
        vec_old = vec
        del vec
        e = float(rccsd.energy(t1, t2, eris))
        log.info("cycle %2d  E_corr(MPCC) = %.14f  dE = %10.3e  |dt| = %9.3e",
                 it, e, e - e_last, normt)
        if abs(e - e_last) < conv_tol and normt < conv_tol_normt:
            converged = True
            break
        e_last = e
    return converged, e, t1, t2
