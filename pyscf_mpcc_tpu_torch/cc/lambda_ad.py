"""Lambda-CCSD, the Lagrangian energy and the response density matrices
by automatic differentiation (closed shell).

Port of the restricted part of ``pyscf_mpcc_tpu/cc/lambda_ad.py``:

- The Lambda equations are the stationarity conditions of the CC
  Lagrangian L = E(t) + sum_nu lambda_nu R_nu(t), 0 = dE/dt + lambda^T
  dR/dt.  lambda^T dR/dt is a vjp of the amplitude residual, taken one
  piece of the residual at a time (rccsd.residual_segments) with
  ``torch.autograd.grad``: each piece's graph is freed when its call
  returns, so the backward's peak memory is the largest piece's, and the
  ladder's pair blocks and ring W tensors are recomputed in the backward
  pass rather than saved (rccsd._remat).  The system is solved by Jacobi
  steps with the energy denominators and DIIS (host ring or device ring).
- ``lagrangian_energy``: E_L = E(t) + <l, R(t)>, stationary in (t, l), so
  amplitudes solved in fp32 give an fp64 energy correct to O(dt^2).
- ``make_rdm12``: L is linear in the MO integrals at fixed HF density,
  amplitudes and multipliers, so rdm1 = dL/dh and rdm2 = 2 dL/dg exactly.

The unrestricted part (``residual_u``, ``kernel_u``,
``lagrangian_energy_u``, ``make_rdm12_u``) is the same construction over
the UCCSD residual: one ``torch.autograd.grad`` of the whole spin-traced
residual a step, with the opposite-spin ladder tiles and the same-spin
ladder pairs recomputed in the backward pass (cc/uccsd._ladder_tiled).
The Ozaki ladder of the certification is not ported (ROADMAP rule 3: the
card has native fp64).
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.cc import rccsd
from pyscf_mpcc_tpu_torch.cc.eris import RERIs
from pyscf_mpcc_tpu_torch.utils.profiling import span

einsum = torch.einsum


def _denominators(eris, nocc):
    eo = eris.mo_energy[:nocc]
    ev = eris.mo_energy[nocc:]
    eia = eo[:, None] - ev[None, :]
    d2 = eia[:, None, :, None] + eia[None, :, None, :]
    return eia, d2


def _mask(m, x):
    return x if m is None else torch.where(m, torch.zeros_like(x), x)


def residual(t1, t2, eris: RERIs, ntile=1, m1=None, m2=None):
    """Amplitude residual R(t) = (update(t) - t) * D, zero at the CCSD
    solution.  With masks, frozen blocks have R = 0 identically."""
    nocc = t1.shape[0]
    eia, d2 = _denominators(eris, nocc)
    t1n, t2n = rccsd.update_amps(t1, t2, eris, 0.0, ntile=ntile)
    r1 = (t1n - t1) * eia
    r2 = (t2n - t2) * d2
    return _mask(m1, r1), _mask(m2, r2)


def _leaves(*xs):
    return [x.detach().requires_grad_() for x in xs]


def _lambda_step(l1, l2, t1, t2, eris, ntile=1, m1=None, m2=None,
                 err_dtype=None, e_extra=None):
    """One Jacobi sweep of lambda^T (dR/dt) = -dE/dt.

    Returns (l1new, l2new, res1, res2, dl): the new multipliers, the
    Lambda-equation residuals (cast to err_dtype where given, the device
    ring's error dtype) and the step norm as a device scalar.  e_extra:
    an energy term added to rccsd.energy (see _lagrangian_of_integrals).

    The vjp is taken segment by segment, one torch.autograd.grad call per
    rccsd.residual_segments piece.  The energy gradient seeds the
    accumulators, and the 'k' cotangent l2 + l2^(jiba) is rebuilt per
    segment, so neither stays live beside them through the walk."""
    nocc = t1.shape[0]
    eia, d2 = _denominators(eris, nocc)
    with span("lambda.energy_grad", device=True), torch.enable_grad():
        a1, a2 = _leaves(t1, t2)
        e = rccsd.energy(a1, a2, eris)
        if e_extra is not None:
            e = e + e_extra(a1, a2, eris)
        j1, j2 = torch.autograd.grad(e, (a1, a2))
        del e
    # masks commute with the linear decomposition: masking the residual's
    # rows is masking the cotangent fed to every segment
    lb1 = _mask(m1, l1)
    lb2 = _mask(m2, l2)
    # the analytic diagonal (-t*D) piece
    j1 = j1 - lb1 * eia
    j2 = j2 - lb2 * d2
    for fn, kind in rccsd.residual_segments(eris, ntile=ntile):
        if kind == "r1":
            ct = lb1
        elif kind == "k":
            ct = lb2 + lb2.permute(1, 0, 3, 2)
        else:
            ct = lb2
        # fn is seg_<piece>: the span lambda.seg.<piece>
        with span("lambda." + fn.__name__.replace("_", ".", 1),
                  device=True):
            with torch.enable_grad():
                a1, a2 = _leaves(t1, t2)
                g1, g2 = torch.autograd.grad(fn(a1, a2), (a1, a2), ct,
                                             allow_unused=True)
            del ct
            if g1 is not None:
                j1 += g1
            if g2 is not None:
                j2 += g2
            del g1, g2
    res1 = _mask(m1, j1)
    res2 = _mask(m2, 0.5 * (j2 + j2.permute(1, 0, 3, 2)))
    del j2
    # frozen blocks have res = 0, so they keep their incoming values
    l1new = l1 + res1 / eia
    l2new = l2 + res2 / d2
    l2new = 0.5 * (l2new + l2new.permute(1, 0, 3, 2))
    dl = torch.linalg.norm(l1new - l1) + torch.linalg.norm(l2new - l2)
    if err_dtype is not None:
        res1 = res1.to(err_dtype)
        res2 = res2.to(err_dtype)
    return l1new, l2new, res1, res2, dl


def kernel(t1, t2, eris: RERIs, max_cycle=50, conv_tol=1e-7, diis_space=6,
           verbose=0, ntile=1, m1=None, m2=None, l1=None, l2=None,
           diis_backend="host", adiis=None, diis_file=None,
           diis_err_dtype=None, e_extra=None):
    """Solve the Lambda equations.  Returns (converged, l1, l2).

    l1/l2 default to copies of t1/t2.  m1/m2: frozen-block masks (those
    equations are dropped and their multipliers held at the incoming
    values).  diis_backend='device' keeps the ring on the device
    (lib/device_diis.update_hostsolve); diis_err_dtype=torch.bfloat16
    halves its error ring.  adiis/diis_file (host ring): resume from a
    preloaded DIIS object, spill the ring every cycle.  e_extra: an energy
    term added to the CCSD energy (see _lagrangian_of_integrals)."""
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    if diis_backend not in ("host", "device"):
        raise ValueError(f"unknown diis_backend {diis_backend!r}")
    log = lg.Logger(verbose=verbose)
    l1 = (t1 if l1 is None else l1).clone()
    l2 = (t2 if l2 is None else l2).clone()
    shapes = (l1.shape, l2.shape)
    dev, dt = l2.device, l2.dtype
    edt = None
    if diis_backend == "device":
        from pyscf_mpcc_tpu_torch.lib import device_diis
        dstate = device_diis.init(l1.numel() + l2.numel(), diis_space, dt,
                                  err_dtype=diis_err_dtype, device=dev)
        # the residuals are cast in the step, so their fp32 copies never
        # sit beside the ring
        edt = diis_err_dtype
    else:
        diis = adiis if adiis is not None else DIIS(space=diis_space)
        if adiis is not None and adiis._xs:
            l1, l2 = rccsd._unpack(
                torch.from_numpy(adiis._xs[-1]).to(dev, dt), *shapes)
    converged = False
    with span("lambda.solve"):
        for it in range(max_cycle):
            with span("lambda.cycle", device=True):
                l1new, l2new, res1, res2, dl = _lambda_step(
                    l1, l2, t1, t2, eris, ntile=ntile, m1=m1, m2=m2,
                    err_dtype=edt, e_extra=e_extra)
                del l1, l2
                with span("sync.dl"):
                    normt = float(dl)
                with span("lambda.diis", device=True):
                    if diis_backend == "device":
                        vec_new = rccsd._pack(l1new, l2new)
                        err_new = rccsd._pack(res1, res2)
                        # release before the ring update
                        del l1new, l2new, res1, res2
                        dstate, vec = device_diis.update_hostsolve(
                            dstate, vec_new, err_new)
                        del vec_new, err_new
                        l1, l2 = rccsd._unpack(vec, *shapes)
                        del vec
                    else:
                        with span("sync.ring_to_host"):
                            vec = np.concatenate(
                                [l1new.cpu().numpy().ravel(),
                                 l2new.cpu().numpy().ravel()])
                            err = np.concatenate(
                                [res1.cpu().numpy().ravel(),
                                 res2.cpu().numpy().ravel()])
                        del l1new, l2new, res1, res2
                        vec = diis.update(vec, xerr=err)
                        del err
                        l1, l2 = rccsd._unpack(
                            torch.from_numpy(vec).to(dev, dt), *shapes)
                        del vec
                        if diis_file is not None:
                            diis.dump(diis_file)
                log.info("lambda cycle %2d  |dl| = %9.3e", it, normt)
                if normt < conv_tol:
                    converged = True
                    break
    return converged, l1, l2


def lagrangian_energy(t1, t2, l1, l2, eris: RERIs, ntile=1,
                      ladder_backend=None):
    """Lagrangian estimate E_L = E(t) + <l, R(t)> of the correlation energy
    (a 0-d tensor) at possibly inexact amplitudes.

    At the fixed point R = 0 and E_L = E; for amplitudes with an error dt
    (solved in fp32 on the card), E_L evaluated in fp64 is correct to
    O(dt^2), because (t, l) is a stationary point of the Lagrangian: solve
    cheaply in fp32, certify with one fp64 evaluation (native fp64 on the
    card).  ladder_backend='ozaki' (the JAX package's int8 emulation of
    the fp64 ladder) is not ported."""
    if ladder_backend == "ozaki":
        raise NotImplementedError(
            "ladder_backend='ozaki' is not ported: the card certifies in "
            "native fp64 (ROADMAP rule 3)")
    e = rccsd.energy(t1, t2, eris)
    r1, r2 = residual(t1, t2, eris, ntile=ntile)
    return e + torch.vdot(l1.reshape(-1), r1.reshape(-1)) \
        + torch.vdot(l2.reshape(-1), r2.reshape(-1))


# ---------------------------------------------------------------------------
# response density matrices from the stationary Lagrangian
# ---------------------------------------------------------------------------

def _lagrangian_of_integrals(h_mo, eri_mo, dm_mo, t1, t2, l1, l2, nocc,
                             ntile=1, m1=None, m2=None, e_extra=None):
    """Total electronic energy Lagrangian as a linear functional of the MO
    integrals at fixed HF density, amplitudes and multipliers.
    e_extra(t1, t2, eris): an energy term added to the correlation energy,
    built from the integrals container it is given.  It is the one hook of
    this module for that: the Lambda solvers (kernel, kernel_u) and both
    RDM paths (make_rdm12, make_rdm12_u) take it, cc/ccsd_t_rdm and
    cc/uccsd_t_rdm pass E(T).  Here the container is rebuilt from the
    integrals, so E(T) follows them; it is homogeneous of degree one in
    them, so the RDM energy identity still holds exactly."""
    nmo = h_mo.shape[0]
    j = torch.einsum("pqrs,rs->pq", eri_mo, dm_mo)
    k = torch.einsum("prqs,rs->pq", eri_mo, dm_mo)
    veff = j - 0.5 * k
    e_hf = torch.einsum("pq,pq->", dm_mo, h_mo) \
        + 0.5 * torch.einsum("pq,pq->", dm_mo, veff)
    fock = h_mo + veff
    o = slice(0, nocc)
    v = slice(nocc, nmo)
    eris = RERIs(
        fock=fock,
        # differentiable: R = (update - t) * D rebuilds the true residual
        # with its Fock-diagonal dependence, so dL/df is exact
        mo_energy=torch.diagonal(fock),
        oooo=eri_mo[o, o, o, o], ovoo=eri_mo[o, v, o, o],
        ovov=eri_mo[o, v, o, v], oovv=eri_mo[o, o, v, v],
        ovvo=eri_mo[o, v, v, o], ovvv=eri_mo[o, v, v, v],
        vvvv=eri_mo[v, v, v, v],
    )
    e_corr = rccsd.energy(t1, t2, eris)
    if e_extra is not None:
        e_corr = e_corr + e_extra(t1, t2, eris)
    r1, r2 = residual(t1, t2, eris, ntile=ntile, m1=m1, m2=m2)
    return e_hf + e_corr + (l1 * r1).sum() + (l2 * r2).sum()


def make_rdm12(h_mo, eri_mo, t1, t2, l1, l2, nocc, ntile=1, m1=None,
               m2=None, e_extra=None):
    """(rdm1, rdm2) in the MO basis, chemists' convention:
    E_elec = einsum('pq,pq', h, rdm1) + 1/2 einsum('pqrs,pqrs', eri, rdm2).
    e_extra: see _lagrangian_of_integrals.
    """
    nmo = h_mo.shape[0]
    dm_mo = torch.zeros((nmo, nmo), dtype=h_mo.dtype, device=h_mo.device)
    dm_mo.diagonal()[:nocc] = 2.0
    with torch.enable_grad():
        h, g = _leaves(h_mo, eri_mo)
        lag = _lagrangian_of_integrals(h, g, dm_mo, t1, t2, l1, l2, nocc,
                                       ntile, m1, m2, e_extra)
        dh, dg = torch.autograd.grad(lag, (h, g))
    rdm1 = 0.5 * (dh + dh.T)
    rdm2 = 2.0 * dg
    # impose the chemists' permutational symmetry explicitly
    rdm2 = 0.25 * (rdm2 + rdm2.permute(1, 0, 3, 2)
                   + rdm2.permute(2, 3, 0, 1) + rdm2.permute(3, 2, 1, 0))
    return rdm1, rdm2


# ---------------------------------------------------------------------------
# unrestricted Lambda (the same construction over the UCCSD residual)
# ---------------------------------------------------------------------------

def _u_denoms(eris_u):
    from pyscf_mpcc_tpu_torch.cc import uccsd as umod
    d1 = umod._eia(eris_u)
    return d1, umod._d2(*d1)


def residual_u(t1, t2, eris_u, m=None):
    """UCCSD residual: R = (update(t) - t) * D per channel; with masks
    m = (m1a, m1b, m2aa, m2ab, m2bb), frozen blocks have R = 0."""
    from pyscf_mpcc_tpu_torch.cc import uccsd as umod
    d1, d2 = _u_denoms(eris_u)
    t1n, t2n = umod.update_amps(t1, t2, eris_u)
    r1 = tuple((a - b) * d for a, b, d in zip(t1n, t1, d1))
    r2 = tuple((a - b) * d for a, b, d in zip(t2n, t2, d2))
    if m is not None:
        r1 = tuple(_mask(mm, r) for mm, r in zip(m[:2], r1))
        r2 = tuple(_mask(mm, r) for mm, r in zip(m[2:], r2))
    return r1, r2


def _vdots(xs, ys):
    return sum(torch.vdot(a.reshape(-1), b.reshape(-1))
               for a, b in zip(xs, ys))


def lagrangian_energy_u(t1, t2, l1, l2, eris_u):
    """Unrestricted Lagrangian estimate E_L = E(t) + <l, R(t)> of the
    correlation energy (a 0-d tensor) at possibly inexact amplitudes, the
    open-shell twin of :func:`lagrangian_energy`.  It consumes the UERIs
    directly (DF-factorized on a DF container), so the fp64 certification
    never materializes an nmo^4 tensor."""
    from pyscf_mpcc_tpu_torch.cc import uccsd as umod
    e = umod.energy(t1, t2, eris_u)
    r1, r2 = residual_u(t1, t2, eris_u)
    return e + _vdots((*l1, *l2), (*r1, *r2))


def _lambda_step_u(l1, l2, t1, t2, eris_u, m=None, e_extra=None):
    """One Jacobi sweep of lambda^T (dR/dt) = -dE/dt: the energy gradient
    plus one vjp of the residual (``torch.autograd.grad``).  e_extra: an
    energy term added to uccsd.energy (see _lagrangian_of_integrals).  Returns
    (l1new, l2new, res1, res2)."""
    from pyscf_mpcc_tpu_torch.cc import uccsd as umod
    d1, d2 = _u_denoms(eris_u)
    with torch.enable_grad():
        a = _leaves(*t1, *t2)
        e = umod.energy(a[:2], a[2:], eris_u)
        if e_extra is not None:
            e = e + e_extra(a[:2], a[2:], eris_u)
        de = torch.autograd.grad(e, a)
        del e
    with torch.enable_grad():
        a = _leaves(*t1, *t2)
        r1, r2 = residual_u(a[:2], a[2:], eris_u, m)
        j = torch.autograd.grad((*r1, *r2), a, (*l1, *l2))
        del r1, r2
    res = [x + y for x, y in zip(de, j)]
    del de, j
    # project onto the antisymmetric (aa/bb) manifolds
    for k in (2, 4):
        r = res[k]
        res[k] = 0.25 * (r - r.permute(1, 0, 2, 3) - r.permute(0, 1, 3, 2)
                         + r.permute(1, 0, 3, 2))
    if m is not None:
        res = [_mask(mm, r) for mm, r in zip(m, res)]
    res1, res2 = tuple(res[:2]), tuple(res[2:])
    l1n = tuple(x + r / d for x, r, d in zip(l1, res1, d1))
    l2n = tuple(x + r / d for x, r, d in zip(l2, res2, d2))
    return l1n, l2n, res1, res2


def kernel_u(t1, t2, eris_u, max_cycle=50, conv_tol=1e-7, diis_space=6,
             verbose=0, masks=None, diis_backend="host", e_extra=None):
    """Unrestricted Lambda solver.  Returns (converged, l1, l2).

    l1/l2 start at copies of t1/t2.  masks: (m1a, m1b, m2aa, m2ab, m2bb)
    frozen-block masks (those equations dropped, their multipliers held).
    diis_backend='device' keeps the ring on the device
    (lib/device_diis.update_hostsolve): the five multiplier blocks never
    leave it.  e_extra: an energy term added to the UCCSD energy (see
    _lagrangian_of_integrals)."""
    from pyscf_mpcc_tpu_torch.cc import uccsd as umod
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    if diis_backend not in ("host", "device"):
        raise ValueError(f"unknown diis_backend {diis_backend!r}")
    log = lg.Logger(verbose=verbose)
    l1 = tuple(x.clone() for x in t1)
    l2 = tuple(x.clone() for x in t2)
    shapes = [x.shape for x in (*l1, *l2)]
    dev, dt = l2[1].device, l2[1].dtype
    if diis_backend == "device":
        from pyscf_mpcc_tpu_torch.lib import device_diis
        dstate = device_diis.init(sum(int(np.prod(s)) for s in shapes),
                                  diis_space, dt, device=dev)
    else:
        diis = DIIS(space=diis_space)
    converged = False
    for it in range(max_cycle):
        l1n, l2n, r1, r2 = _lambda_step_u(l1, l2, t1, t2, eris_u, masks,
                                          e_extra)
        del l1, l2
        resn = sum(float(torch.linalg.norm(x)) for x in (*r1, *r2))
        vec_new = umod.amplitudes_to_vector(l1n, l2n)
        err_new = umod.amplitudes_to_vector(r1, r2)
        del l1n, l2n, r1, r2
        if diis_backend == "device":
            dstate, vec = device_diis.update_hostsolve(dstate, vec_new,
                                                       err_new)
        else:
            vec = torch.from_numpy(diis.update(
                vec_new.cpu().numpy(),
                xerr=err_new.cpu().numpy())).to(dev, dt)
        del vec_new, err_new
        l1, l2 = umod.vector_to_amplitudes(vec, shapes)
        del vec
        log.info("ulambda cycle %2d  |res| = %9.3e", it, resn)
        if resn < conv_tol:
            converged = True
            break
    return converged, l1, l2


def _u_fock_of_integrals(h_a, h_b, g_aa, g_ab, g_bb, nocca, noccb):
    """(fa, fb, e_hf) as differentiable functionals of the per-spin MO
    integrals."""
    def occ_dm(n, nocc, like):
        d = torch.zeros(n, dtype=like.dtype, device=like.device)
        d[:nocc] = 1.0
        return torch.diag(d)

    dma = occ_dm(h_a.shape[0], nocca, h_a)
    dmb = occ_dm(h_b.shape[0], noccb, h_b)
    ja = (einsum("pqrs,rs->pq", g_aa, dma)
          + einsum("pqRS,RS->pq", g_ab, dmb))
    jb = (einsum("PQRS,RS->PQ", g_bb, dmb)
          + einsum("pqRS,pq->RS", g_ab, dma))
    ka = einsum("prqs,rs->pq", g_aa, dma)
    kb = einsum("PRQS,RS->PQ", g_bb, dmb)
    fa = h_a + ja - ka
    fb = h_b + jb - kb
    e_hf = (torch.sum(dma * h_a) + torch.sum(dmb * h_b)
            + 0.5 * (torch.sum(dma * (ja - ka)) + torch.sum(dmb * (jb - kb))))
    return fa, fb, e_hf


def _u_lagrangian_of_integrals(h_a, h_b, g_aa, g_ab, g_bb, t1, t2, l1, l2,
                               nocca, noccb, e_extra=None):
    """UHF-CCSD total-energy Lagrangian as a linear functional of the
    per-spin MO integrals (materialized blocks).  e_extra: see
    _lagrangian_of_integrals."""
    from pyscf_mpcc_tpu_torch.cc import uccsd as umod
    nmoa, nmob = h_a.shape[0], h_b.shape[0]
    fa, fb, e_hf = _u_fock_of_integrals(h_a, h_b, g_aa, g_ab, g_bb,
                                        nocca, noccb)
    oa, va = slice(0, nocca), slice(nocca, nmoa)
    ob, vb = slice(0, noccb), slice(noccb, nmob)
    g_ba = g_ab.permute(2, 3, 0, 1)
    eris = umod.UERIs(
        focka=fa, fockb=fb, nocca=nocca, noccb=noccb,
        oooo=g_aa[oa, oa, oa, oa], ovoo=g_aa[oa, va, oa, oa],
        ovov=g_aa[oa, va, oa, va], oovv=g_aa[oa, oa, va, va],
        ovvo=g_aa[oa, va, va, oa],
        OOOO=g_bb[ob, ob, ob, ob], OVOO=g_bb[ob, vb, ob, ob],
        OVOV=g_bb[ob, vb, ob, vb], OOVV=g_bb[ob, ob, vb, vb],
        OVVO=g_bb[ob, vb, vb, ob],
        ooOO=g_ab[oa, oa, ob, ob], ovOO=g_ab[oa, va, ob, ob],
        OVoo=g_ba[ob, vb, oa, oa], ovOV=g_ab[oa, va, ob, vb],
        ooVV=g_ab[oa, oa, vb, vb], OOvv=g_ba[ob, ob, va, va],
        ovVO=g_ab[oa, va, vb, ob], OVvo=g_ba[ob, vb, va, oa],
        ovvv=g_aa[oa, va, va, va], OVVV=g_bb[ob, vb, vb, vb],
        ovVV=g_ab[oa, va, vb, vb], OVvv=g_ba[ob, vb, va, va],
        vvvv=g_aa[va, va, va, va], VVVV=g_bb[vb, vb, vb, vb],
        vvVV=g_ab[va, va, vb, vb],
    )
    e_corr = umod.energy(t1, t2, eris)
    if e_extra is not None:
        e_corr = e_corr + e_extra(t1, t2, eris)
    r1, r2 = residual_u(t1, t2, eris)
    return e_hf + e_corr + _vdots((*l1, *l2), (*r1, *r2))


def make_rdm12_u(h_a, h_b, g_aa, g_ab, g_bb, t1, t2, l1, l2, nocca,
                 noccb, e_extra=None):
    """UCCSD response densities ((dm1a, dm1b), (dm2aa, dm2ab, dm2bb)) in
    the per-spin MO bases, chemists' convention, satisfying

        E_elec = h_a.dm1a + h_b.dm1b + 1/2 g_aa.dm2aa + 1/2 g_bb.dm2bb
                 + g_ab.dm2ab

    exactly (the Lagrangian is linear in every integral tensor).
    e_extra: see _lagrangian_of_integrals."""
    with torch.enable_grad():
        ints = _leaves(h_a, h_b, g_aa, g_ab, g_bb)
        lag = _u_lagrangian_of_integrals(*ints, t1, t2, l1, l2, nocca,
                                         noccb, e_extra)
        dha, dhb, dgaa, dgab, dgbb = torch.autograd.grad(lag, ints)

    def sym4(x):
        return 0.25 * (x + x.permute(1, 0, 3, 2) + x.permute(2, 3, 0, 1)
                       + x.permute(3, 2, 1, 0))

    return ((0.5 * (dha + dha.T), 0.5 * (dhb + dhb.T)),
            (2.0 * sym4(dgaa), 0.5 * (dgab + dgab.permute(1, 0, 3, 2)),
             2.0 * sym4(dgbb)))
