"""Unrestricted MP-CC hybrid (UMPCCSD).

Port of ``pyscf_mpcc_tpu/mpcc/umpccsd.py`` (reference:
pyscf/cc/umpccsd.py:1820 update_amps, :2219-2235 block freeze, :2550
kernel API).  The full UCCSD residual comes from ``cc.uccsd``, then the
blocks selected by idx_s/idx_d (per spin channel) are reset to their
incoming bath values through boolean masks (``torch.where``; the masks
are built once a call from mpcc/masks.py and moved to the amplitudes'
device).  act_hole/act_particle are (alpha, beta) index-array pairs;
idx_s = (idx_s_alpha, idx_s_beta); idx_d = (idx_d_aa, idx_d_ab,
idx_d_bb), the alpha-beta doubles blocks built from the mixed tuples as
the reference's idx_d_ab (umpccsd.py:2222).

The JAX package keeps the frozen blocks through DIIS only because the
DIIS coefficients sum to one, exact in fp64 but not in fp32.  Here the
frozen blocks are written back from the bath after each extrapolation,
as mpcc/rmpccsd does (the same function in exact arithmetic), in
``kernel``, its OO-MP2 relaxation and ``kernel_pert_df``.
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.cc import uccsd
from pyscf_mpcc_tpu_torch.mpcc.masks import doubles_blocks, singles_blocks


def frozen_masks_u(act_hole, act_particle, nocc, nvir, idx_s, idx_d, *,
                   device):
    """Masks (m1a, m1b, m2aa, m2ab, m2bb) for the unrestricted freeze, as
    bool tensors on ``device``.

    nocc/nvir: (nocca, noccb)/(nvira, nvirb); act_* are (alpha, beta).
    """
    (aha, ahb), (apa, apb) = act_hole, act_particle
    (na, nb), (va, vb) = nocc, nvir
    sa = singles_blocks(aha, apa, na, va)
    sb = singles_blocks(ahb, apb, nb, vb)
    daa = doubles_blocks(aha, apa, na, va)
    dbb = doubles_blocks(ahb, apb, nb, vb)
    dab = doubles_blocks(aha, apa, na, va, ahb, apb, nb, vb)

    def combine(blocks, idx, shape):
        m = np.zeros(shape, dtype=bool)
        for i in idx:
            m |= blocks[i]
        return torch.as_tensor(m, device=device)

    return (combine(sa, idx_s[0], (na, va)),
            combine(sb, idx_s[1], (nb, vb)),
            combine(daa, idx_d[0], (na, na, va, va)),
            combine(dab, idx_d[1], (na, nb, va, vb)),
            combine(dbb, idx_d[2], (nb, nb, vb, vb)))


def _freeze(masks, t1, t2, u1, u2):
    """The update (u1, u2) with the masked blocks taken from (t1, t2)."""
    m1a, m1b, m2aa, m2ab, m2bb = masks
    return ((torch.where(m1a, t1[0], u1[0]),
             torch.where(m1b, t1[1], u1[1])),
            (torch.where(m2aa, t2[0], u2[0]),
             torch.where(m2ab, t2[1], u2[1]),
             torch.where(m2bb, t2[2], u2[2])))


def update_amps_masked(t1, t2, eris, masks, level_shift=0.0):
    """One UCCSD sweep with the masked blocks held at their incoming
    values."""
    u1, u2 = uccsd.update_amps(t1, t2, eris, level_shift)
    return _freeze(masks, t1, t2, u1, u2)


def _index_lists(idx_s, idx_d):
    """The reference API's idx_s/idx_d: plain lists apply to every spin
    channel; empty means nothing frozen."""
    if idx_s and not isinstance(idx_s[0], (list, tuple, np.ndarray)):
        idx_s = (idx_s, idx_s)
    if idx_d and not isinstance(idx_d[0], (list, tuple, np.ndarray)):
        idx_d = (idx_d, idx_d, idx_d)
    if not idx_s:
        idx_s = ([], [])
    if not idx_d:
        idx_d = ([], [], [])
    return idx_s, idx_d


def _dims(eris):
    na, nb = uccsd._nocc(eris)
    return (na, nb), (eris.ovov.shape[1], eris.OVOV.shape[1])


class _Ring:
    """DIIS over the five amplitude blocks, on the host (``lib.diis``) or
    on the device (``lib.device_diis``, the error the step), with the
    frozen blocks written back from the bath after each extrapolation."""

    def __init__(self, t1, t2, diis_space, backend, masks, bath):
        from pyscf_mpcc_tpu_torch.lib.diis import DIIS
        if backend not in ("host", "device"):
            raise ValueError(f"unknown diis_backend {backend!r}")
        self.shapes = [x.shape for x in (*t1, *t2)]
        self.dev, self.dt = t2[1].device, t2[1].dtype
        self.masks, self.bath = masks, bath
        self.backend = backend
        if backend == "device":
            from pyscf_mpcc_tpu_torch.lib import device_diis
            self.state = device_diis.init(
                sum(int(np.prod(s)) for s in self.shapes), diis_space,
                self.dt, device=self.dev)
            self.vec_old = uccsd.amplitudes_to_vector(t1, t2)
        else:
            self.diis = DIIS(space=diis_space)

    def __call__(self, t1new, t2new):
        vec_new = uccsd.amplitudes_to_vector(t1new, t2new)
        if self.backend == "device":
            from pyscf_mpcc_tpu_torch.lib import device_diis
            self.state, vec = device_diis.update_hostsolve(
                self.state, vec_new, vec_new - self.vec_old)
        else:
            vec = torch.from_numpy(self.diis.update(
                vec_new.cpu().numpy())).to(self.dev, self.dt)
        del vec_new
        t1, t2 = uccsd.vector_to_amplitudes(vec, self.shapes)
        for m, x, b in zip(self.masks, (*t1, *t2), (*self.bath[0],
                                                     *self.bath[1])):
            x.copy_(torch.where(m, b, x))
        self.vec_old = vec
        return t1, t2


def _normt(new, old):
    return sum(float(torch.linalg.norm(a - b)) for a, b in zip(new, old))


def kernel(eris, act_hole, act_particle, idx_s, idx_d, t1=None, t2=None,
           max_cycle=50, conv_tol=1e-8, conv_tol_normt=1e-6, diis_space=6,
           verbose=0, level_shift=0.0, oo_mp2=False,
           oomp2_variant="standard", diis_backend="host"):
    """UMPCCSD iteration.  Returns (converged, e_corr, t1, t2).

    idx_s/idx_d may be given per the reference API: idx_s=(list_a, list_b),
    idx_d=(list_aa, list_ab, list_bb); passing plain lists applies them to
    every spin channel.

    oo_mp2=True replaces the CCSD update with the selected OO-MP2
    low-level operator (mpcc/oomp2.py; reference umpccsd.py:76-92), the
    bath-relaxation step of the fragmented workflow, where the listed
    blocks are frozen at their incoming (fragment-CC) values and the rest
    relaxes at MP2-like cost.  diis_backend as in ``uccsd.kernel``: 'host'
    (the host ``lib.diis.DIIS``, the JAX package's) or 'device'.
    """
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    log = lg.Logger(verbose=verbose)
    nocc, nvir = _dims(eris)
    idx_s, idx_d = _index_lists(idx_s, idx_d)
    dev = eris.ovOV.device
    masks = frozen_masks_u(act_hole, act_particle, nocc, nvir, idx_s, idx_d,
                           device=dev)
    if oo_mp2:
        from pyscf_mpcc_tpu_torch.mpcc.oomp2 import update_amps_oomp2
        (aha, ahb), (apa, apb) = act_hole, act_particle
        (na, nb), (va, vb) = nocc, nvir
        act_m = tuple(torch.as_tensor(m[15], device=dev) for m in (
            doubles_blocks(aha, apa, na, va),
            doubles_blocks(aha, apa, na, va, ahb, apb, nb, vb),
            doubles_blocks(ahb, apb, nb, vb)))

        def base_update(t1_, t2_, ls):
            return update_amps_oomp2(t1_, t2_, eris, variant=oomp2_variant,
                                     act_masks=act_m, level_shift=ls)
    else:
        def base_update(t1_, t2_, ls):
            return uccsd.update_amps(t1_, t2_, eris, ls)

    _, t1_0, t2_0 = uccsd.init_amps(eris)
    t1 = t1_0 if t1 is None else tuple(t1)
    t2 = t2_0 if t2 is None else tuple(t2)
    del t1_0, t2_0
    ring = _Ring(t1, t2, diis_space, diis_backend, masks, (t1, t2))
    e_last = float(uccsd.energy(t1, t2, eris))
    log.info("UMPCCSD init E_corr = %.14f", e_last)
    converged = False
    e = e_last
    for it in range(max_cycle):
        t1new, t2new = _freeze(masks, t1, t2, *base_update(t1, t2,
                                                           level_shift))
        normt = _normt((*t1new, *t2new), (*t1, *t2))
        t1, t2 = ring(t1new, t2new)
        del t1new, t2new
        e = float(uccsd.energy(t1, t2, eris))
        log.info("cycle %2d  E_corr(UMPCC) = %.14f  dE = %10.3e  |dt| = %9.3e",
                 it, e, e - e_last, normt)
        if abs(e - e_last) < conv_tol and normt < conv_tol_normt:
            converged = True
            break
        e_last = e
    return converged, e, t1, t2


def lambda_kernel(eris, t1, t2, act_hole, act_particle, idx_s, idx_d,
                  max_cycle=50, conv_tol=1e-7, verbose=0):
    """Fragment/environment-split unrestricted Lambda (the fork's
    umpccsd_lambda capability): the frozen-block masks remove the bath
    equations from the autograd Lambda system (lambda_ad.kernel_u).
    Returns (converged, l1, l2)."""
    from pyscf_mpcc_tpu_torch.cc import lambda_ad
    nocc, nvir = _dims(eris)
    idx_s, idx_d = _index_lists(idx_s, idx_d)
    masks = frozen_masks_u(act_hole, act_particle, nocc, nvir, idx_s, idx_d,
                           device=t2[1].device)
    return lambda_ad.kernel_u(t1, t2, eris, max_cycle=max_cycle,
                              conv_tol=conv_tol, verbose=verbose,
                              masks=masks)


def _masks_to_spin_orbital(masks, nocc, nvir):
    """Map blocked freeze masks (m1a, m1b, m2aa, m2ab, m2bb) to boolean
    spin-orbital masks over [occ_a, occ_b | vir_a, vir_b] ordering, on
    the masks' device."""
    m1a, m1b, m2aa, m2ab, m2bb = masks
    na, nb = nocc
    va, vb = nvir
    no, nv = na + nb, va + vb
    dev = m1a.device
    M1 = torch.zeros((no, nv), dtype=torch.bool, device=dev)
    M1[:na, :va] = m1a
    M1[na:, va:] = m1b
    M2 = torch.zeros((no, no, nv, nv), dtype=torch.bool, device=dev)
    M2[:na, :na, :va, :va] = m2aa
    M2[na:, na:, va:, va:] = m2bb
    M2[:na, na:, :va, va:] = m2ab
    M2[na:, :na, va:, :va] = m2ab.permute(1, 0, 3, 2)
    M2[:na, na:, va:, :va] = m2ab.permute(0, 1, 3, 2)
    M2[na:, :na, :va, va:] = m2ab.permute(1, 0, 2, 3)
    return M1, M2


def kernel_pert_df(eris, B, h, act_hole, act_particle, idx_s, idx_d,
                   model="ccsdt-3", max_cycle=100, conv_tol=1e-9,
                   conv_tol_normt=1e-7, diis_space=6, verbose=0,
                   t1=None, t2=None, level_shift=0.0):
    """UMPCC with coupled active-space T3 from DF factors.

    The spin-traced UCCSD engine (cc/uccsd.update_amps) supplies R1/R2;
    the DF T3 engine (cc/ccsdt_act) supplies the active-block T3 sweep and
    its (R1, R2) feedback: t3 lives on the active block only and the
    integrals enter as dressed 3-center factors.  Fork counterpart:
    umpccsd.py:2183-2197 pert_triples + umpcc_t_slow.iterative_update_amps_t3.

    eris: uccsd.UERIs at the same orbitals as B/h; B: per-spin full-MO
    3-center factors (naux, nmo, nmo); h: per-spin one-electron MO
    integrals (arrays or tensors; taken to the eris' device and dtype).
    act_hole/act_particle: per-spin active lists; idx_s/idx_d frozen-block
    lists as in kernel().  t3 carries its own host DIIS history (reference
    cc/ccsd.py:79-87,1278 run_diis_t3).
    Returns (converged, e_corr, t1, t2, t3_canonical)."""
    from pyscf_mpcc_tpu_torch.cc import ccsdt_act
    from pyscf_mpcc_tpu_torch.cc.spinsum import t2_st
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    log = lg.Logger(verbose=verbose)
    nocc, nvir = _dims(eris)
    (na, nb), (va, vb) = nocc, nvir
    idx_s, idx_d = _index_lists(idx_s, idx_d)
    dev, dt = eris.ovOV.device, eris.ovOV.dtype
    B = tuple(torch.as_tensor(x, dtype=dt, device=dev) for x in B)
    h = tuple(torch.as_tensor(x, dtype=dt, device=dev) for x in h)
    masks = frozen_masks_u(act_hole, act_particle, nocc, nvir, idx_s, idx_d,
                           device=dev)
    dd = ccsdt_act.DressedDF(nocc, (na + va, nb + vb), act_hole,
                             act_particle, device=dev)
    d1a, d1b = uccsd._eia(eris, level_shift)
    d2aa, d2ab, d2bb = uccsd._d2(d1a, d1b)
    d3 = ccsdt_act.d3_blocks(dd, eris.mo_energy)

    _, t1_0, t2_0 = uccsd.init_amps(eris)
    t1 = t1_0 if t1 is None else tuple(t1)
    t2 = t2_0 if t2 is None else tuple(t2)
    del t1_0, t2_0
    ring = _Ring(t1, t2, diis_space, "host", masks, (t1, t2))
    canon = None
    diis3 = DIIS(space=diis_space)
    e_last = float(uccsd.energy(t1, t2, eris))
    converged = False
    e = e_last
    for it in range(max_cycle):
        arrs = ccsdt_act.dress_df(B, h, t1, (na, nb))
        t3 = ccsdt_act.expand_t3(canon) if canon is not None else None
        r3 = ccsdt_act.reduce_t3(ccsdt_act.t3_residual_act(
            t2_st(t2), t3, dd, arrs, model=model))
        canon_new = {k: (canon[k] if canon is not None else 0.0)
                     + r3[k] / d3[k] for k in r3}
        dn3 = (sum(float(torch.linalg.norm(canon_new[k] - canon[k]))
                   for k in canon_new) if canon is not None
               else sum(float(torch.linalg.norm(v))
                        for v in canon_new.values()))
        canon = ccsdt_act.diis_blocks(diis3, canon_new,
                                      sorted(canon_new.keys()))
        del canon_new, t3, r3

        (f1a, f1b), (f2aa, f2ab, f2bb) = ccsdt_act.feedback_act(
            ccsdt_act.expand_t3(canon), dd, arrs)
        del arrs
        (u1a, u1b), (u2aa, u2ab, u2bb) = uccsd.update_amps(
            t1, t2, eris, level_shift)
        t1new, t2new = _freeze(
            masks, t1, t2, (u1a + f1a / d1a, u1b + f1b / d1b),
            (u2aa + f2aa / d2aa, u2ab + f2ab / d2ab, u2bb + f2bb / d2bb))
        del u1a, u1b, u2aa, u2ab, u2bb, f1a, f1b, f2aa, f2ab, f2bb
        normt = _normt((*t1new, *t2new), (*t1, *t2)) + dn3
        t1, t2 = ring(t1new, t2new)
        del t1new, t2new
        e = float(uccsd.energy(t1, t2, eris))
        log.info("cycle %2d  E_corr(UMPCC+T3/df) = %.14f  dE = %10.3e  "
                 "|dt| = %9.3e", it, e, e - e_last, normt)
        if abs(e - e_last) < conv_tol and normt < conv_tol_normt:
            converged = True
            break
        e_last = e
    return converged, e, t1, t2, canon


def kernel_pert_triples(mf, act_hole, act_particle, idx_s, idx_d,
                        model="ccsdt-3", max_cycle=100, conv_tol=1e-9,
                        conv_tol_normt=1e-7, verbose=0, t1=None, t2=None):
    """UMPCC with coupled active-space T3 (the reference's pert_triples
    path): the CCSD equations with the MP-CC block freeze plus a T3
    restricted to the all-active triples block, solved iteratively and fed
    back into the t1/t2 residuals, with its own DIIS history.  It runs on
    the host spin-orbital NumPy engine (cc/gccsdt_slow over
    cc/gccsd_slow.eris_from_scf), as in the JAX package, which fits the
    small active spaces the method targets; :func:`kernel_pert_df` is the
    DF path on the device.

    act_hole/act_particle: (alpha_list, beta_list) spatial indices;
    idx_s/idx_d: the frozen-block lists (the reference's get_index_tuples
    enumeration).  Returns (e_corr, t1_so, t2_so, t3_so, converged), numpy
    arrays."""
    from pyscf_mpcc_tpu_torch.cc import eom_slow, gccsd_slow, gccsdt_slow
    so = gccsd_slow.eris_from_scf(mf)
    h_so = eom_slow.h_so_from_eris(so)
    na, nb = mf.mol.nelec
    nmo = np.asarray(mf.mo_coeff).shape[-1]
    va, vb = nmo - na, nmo - nb
    if idx_s and not isinstance(idx_s[0], (list, tuple, np.ndarray)):
        idx_s = (idx_s, idx_s)
    if idx_d and not isinstance(idx_d[0], (list, tuple, np.ndarray)):
        idx_d = (idx_d, idx_d, idx_d)
    if not idx_s:
        idx_s = ([], [])
    if not idx_d:
        idx_d = ([], [], [])
    masks = frozen_masks_u(act_hole, act_particle, (na, nb), (va, vb),
                           idx_s, idx_d, device=torch.device("cpu"))
    M1, M2 = (m.numpy() for m in
              _masks_to_spin_orbital(masks, (na, nb), (va, vb)))
    (aha, ahb), (apa, apb) = act_hole, act_particle
    act_hole_so = list(aha) + [na + int(i) for i in ahb]
    act_particle_so = list(apa) + [va + int(p) for p in apb]
    return gccsdt_slow.kernel(
        so, h_so, act_hole=act_hole_so, act_particle=act_particle_so,
        model=model, max_cycle=max_cycle, conv_tol=conv_tol,
        conv_tol_normt=conv_tol_normt, verbose=verbose,
        t1=t1, t2=t2, freeze_mask1=M1, freeze_mask2=M2)
