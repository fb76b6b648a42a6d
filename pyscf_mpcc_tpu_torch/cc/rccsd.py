"""Restricted (closed-shell) CCSD.

Port of ``pyscf_mpcc_tpu/cc/rccsd.py``: the spin-adapted CCSD equations of
Hirata et al., J. Chem. Phys. 120, 2581 (2004), Eqs. (35)-(45), as dense
torch contractions (cuBLAS GEMMs on the card).  The O(nocc^2 nvir^4)
particle-particle ladder runs from materialized vvvv (small systems) or
from density-fitted Lvv factors over symmetric virtual tile pairs.

PyTorch runs eagerly, so the JAX package's ``jax.jit``/``jax.checkpoint``
and ``optimization_barrier`` have no counterpart: the P(ij|ab) pieces of
the doubles residual accumulate in place into one buffer instead, which
bounds the number of live t2-sized temporaries the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.cc.eris import RERIs

einsum = torch.einsum


def init_amps(eris: RERIs):
    """MP2 initial guess; returns (emp2, t1, t2)."""
    nocc = eris.nocc
    fov = eris.fock[:nocc, nocc:]
    eo = eris.mo_energy[:nocc]
    ev = eris.mo_energy[nocc:]
    eia = eo[:, None] - ev[None, :]
    d2 = eia[:, None, :, None] + eia[None, :, None, :]
    t1 = fov / eia
    ovov = eris.ovov
    t2 = ovov.permute(0, 2, 1, 3) / d2
    emp2 = 2.0 * einsum("ijab,iajb->", t2, ovov)
    emp2 = emp2 - einsum("ijab,ibja->", t2, ovov)
    return emp2, t1, t2


def energy(t1, t2, eris: RERIs):
    nocc = eris.nocc
    fov = eris.fock[:nocc, nocc:]
    tau = t2 + einsum("ia,jb->ijab", t1, t1)
    e = 2.0 * einsum("ia,ia->", fov, t1)
    e = e + 2.0 * einsum("ijab,iajb->", tau, eris.ovov)
    e = e - einsum("ijab,ibja->", tau, eris.ovov)
    return e


def _ladder_vvvv(tau, t1, eris):
    """tau * Wvvvv from materialized (ab|cd) (Hirata chi_vvvv)."""
    w = eris.vvvv.permute(0, 2, 1, 3)  # (ac|bd) -> W[a,b,c,d]
    w = w - einsum("kdac,kb->abcd", eris.ovvv, t1)
    w = w - einsum("kcbd,ka->abcd", eris.ovvv, t1)
    return einsum("abcd,ijcd->ijab", w, tau)


def _ladder_df(tau, t1, eris, ntile):
    """tau * Wvvvv from DF factors with t1-dressed Lvv, tiled over
    symmetric virtual tile pairs (see pair_ladder_sym).

    Ldressed[L,a,c] = Lvv[L,a,c] - sum_k t1[k,a] Lov[L,k,c]; the spurious
    quadratic term sum_kl t1_ka t1_lb (kc|ld) tau_ijcd is subtracted
    explicitly."""
    if eris.Lvv_stream is not None:
        raise NotImplementedError(
            "streamed Lvv ladder is ROADMAP A16, not ported yet")
    Ld = eris.Lvv - einsum("ka,Lkc->Lac", t1, eris.Lov)
    out = pair_ladder_sym(tau, Ld, ntile)
    del Ld
    # subtract the quadratic dressing artifact
    tmp = einsum("kcld,ijcd->klij", eris.ovov, tau)
    out.sub_(einsum("klij,ka,lb->ijab", tmp, t1, t1))
    return out


def pair_ladder_sym(tau, Ld, ntile):
    """out[ijab] = sum_{L,c,d} Ld[L,a,c] Ld[L,b,d] tau[i,j,c,d], evaluated
    only on virtual tile pairs A >= B; A < B blocks are transposed mirrors.

    W[a,c,b,d] = sum_L Ld[L,ac] Ld[L,bd] swaps its two factor slots
    exactly and tau is (ij)<->(cd) joint-swap symmetric, so
    Ht2[i,j,a,b] = Ht2[j,i,b,a].  tau is symmetrized on entry, which makes
    the mirrored ladder a well-defined function of an arbitrary t2 (an
    exact no-op for the symmetric iterates the solvers produce).  Each
    A >= B block is written once into the output, diagonal blocks halved,
    and the mirrors are applied by ONE S + S.transpose(1,0,3,2) at the
    end.  nvir is zero-padded to a tile multiple; any ntile >= 1 works.
    """
    # exact pass-through for symmetric tau (x+x is exact, 0.5* is exact)
    tau = 0.5 * (tau + tau.permute(1, 0, 3, 2))
    naux, nvir = Ld.shape[0], Ld.shape[1]
    nocc = tau.shape[0]
    ntile = max(1, min(int(ntile), nvir))
    tsz = -(-nvir // ntile)
    nvp = ntile * tsz
    pad = nvp - nvir
    if pad:
        # padded a-rows of Ld are zero -> zero output rows (mirrors stay
        # exact); padded c-columns contract against zero tau columns
        Ld = torch.nn.functional.pad(Ld, (0, pad, 0, pad))
        tau = torch.nn.functional.pad(tau, (0, pad, 0, pad))
    Ld_t = Ld.reshape(naux, ntile, tsz * nvp)
    s = torch.zeros((nocc, nocc, nvp, nvp), dtype=tau.dtype,
                    device=tau.device)
    for a in range(ntile):
        for b in range(a + 1):
            # w[(a,c),(b,d)] = sum_L Ld[L,a,c] Ld[L,b,d]: one GEMM
            w = (Ld_t[:, a].T @ Ld_t[:, b]).view(tsz, nvp, tsz, nvp)
            blk = einsum("acbd,ijcd->ijab", w, tau)
            del w
            if a == b:
                # halve diagonal blocks: the final S + S^T counts them twice
                blk.mul_(0.5)
            s[:, :, a * tsz:(a + 1) * tsz, b * tsz:(b + 1) * tsz] = blk
            del blk
    out = s + s.permute(1, 0, 3, 2)
    del s
    if pad:
        out = out[:, :, :nvir, :nvir].contiguous()
    return out


class _OvvvOps:
    """The ovvv-block contractions, in materialized or DF-factorized form.

    At production scale the (ia|bc) block is O(nocc nvir^3) and is not
    materialized (12 GB for (H2O)8/cc-pVTZ in fp32); every use factorizes
    exactly through the 3-center L tensors."""

    def __init__(self, eris: RERIs, ntile=1):
        if eris.Lvv_stream is not None:
            raise NotImplementedError(
                "streamed Lvv (stream_vv) is ROADMAP A16, not ported yet")
        self.eris = eris
        self.df = eris.ovvv is None

    def t1_t2_terms(self, t2):
        """2*(kd|ac) t2[ikcd] - (kc|ad) t2[ikcd] -> [ia]"""
        e = self.eris
        if not self.df:
            return (2.0 * einsum("kdac,ikcd->ia", e.ovvv, t2)
                    - einsum("kcad,ikcd->ia", e.ovvv, t2))
        x = einsum("Lkd,ikcd->Lic", e.Lov, t2)
        out = 2.0 * einsum("Lic,Lac->ia", x, e.Lvv)
        y = einsum("Lkc,ikcd->Lid", e.Lov, t2)
        out = out - einsum("Lid,Lad->ia", y, e.Lvv)
        return out

    def lvv_t1(self, t1):
        """2*(kd|ac) t1[kd] - (kc|ad) t1[kd] -> [ac]"""
        e = self.eris
        if not self.df:
            return (2.0 * einsum("kdac,kd->ac", e.ovvv, t1)
                    - einsum("kcad,kd->ac", e.ovvv, t1))
        z = einsum("Lkd,kd->L", e.Lov, t1)
        out = 2.0 * einsum("L,Lac->ac", z, e.Lvv)
        x = einsum("Lkc,kd->Lcd", e.Lov, t1)
        out = out - einsum("Lcd,Lad->ac", x, e.Lvv)
        return out

    def wvoov_t1(self, t1):
        """(kc|ad) t1[id] -> [akic]"""
        e = self.eris
        if not self.df:
            return einsum("kcad,id->akic", e.ovvv, t1)
        x = einsum("Lad,id->Lai", e.Lvv, t1)
        return einsum("Lai,Lkc->akic", x, e.Lov)

    def wvovo_t1(self, t1):
        """(kd|ac) t1[id] -> [akci]"""
        e = self.eris
        if not self.df:
            return einsum("kdac,id->akci", e.ovvv, t1)
        x = einsum("Lkd,id->Lki", e.Lov, t1)
        return einsum("Lki,Lac->akci", x, e.Lvv)

    def t2_vvov_t1(self, t1):
        """sum_c (ia|cb) t1[jc] -> [ijab] (the vv-ov piece of chi_vvov)"""
        e = self.eris
        if not self.df:
            tmp2 = e.ovvv.permute(1, 3, 0, 2)
            return einsum("abic,jc->ijab", tmp2, t1)
        x = einsum("Lcb,jc->Ljb", e.Lvv, t1)
        return einsum("Lia,Ljb->ijab", e.Lov, x)


def update_amps(t1, t2, eris: RERIs, level_shift=0.0, ntile=1,
                variant="ccsd"):
    """One Jacobi sweep of the RCCSD / CC2 / CCD equations.

    variant: 'ccsd' (default), 'cc2' (T2 truncated to first order in the
    fluctuation potential with t1-dressing), 'ccd' (t1 pinned at zero)."""
    if variant not in ("ccsd", "cc2", "ccd"):
        raise ValueError(f"unknown variant {variant!r}")
    nocc = eris.nocc
    fock = eris.fock
    fov = fock[:nocc, nocc:]
    foo = fock[:nocc, :nocc]
    fvv = fock[nocc:, nocc:]
    mo_e_o = eris.mo_energy[:nocc]
    mo_e_v = eris.mo_energy[nocc:] + level_shift

    ovov = eris.ovov
    ovoo = eris.ovoo
    ovvo = eris.get_ovvo()
    oovv = eris.oovv
    oooo = eris.oooo
    vops = _OvvvOps(eris, ntile)

    # --- kappa intermediates (Eqs. 37-39), Fock diagonal removed ---------
    Foo = foo + 2.0 * einsum("kcld,ilcd->ki", ovov, t2) \
        - einsum("kdlc,ilcd->ki", ovov, t2) \
        + 2.0 * einsum("kcld,ic,ld->ki", ovov, t1, t1) \
        - einsum("kdlc,ic,ld->ki", ovov, t1, t1)
    Fvv = fvv - 2.0 * einsum("kcld,klad->ac", ovov, t2) \
        + einsum("kdlc,klad->ac", ovov, t2) \
        - 2.0 * einsum("kcld,ka,ld->ac", ovov, t1, t1) \
        + einsum("kdlc,ka,ld->ac", ovov, t1, t1)
    Fov = fov + 2.0 * einsum("kcld,ld->kc", ovov, t1) \
        - einsum("kdlc,ld->kc", ovov, t1)

    Foo_nd = Foo - torch.diag(mo_e_o)
    Fvv_nd = Fvv - torch.diag(mo_e_v)

    # --- T1 (Eq. 35) ------------------------------------------------------
    t1new = fov.clone()
    t1new -= 2.0 * einsum("kc,ka,ic->ia", fov, t1, t1)
    t1new += einsum("ac,ic->ia", Fvv_nd, t1)
    t1new -= einsum("ki,ka->ia", Foo_nd, t1)
    t1new += 2.0 * einsum("kc,kica->ia", Fov, t2)
    t1new -= einsum("kc,ikca->ia", Fov, t2)
    t1new += einsum("kc,ic,ka->ia", Fov, t1, t1)
    t1new += 2.0 * einsum("kcai,kc->ia", ovvo, t1)
    t1new -= einsum("kiac,kc->ia", oovv, t1)
    t1new += vops.t1_t2_terms(t2)
    lvv_t1 = vops.lvv_t1(t1)
    t1new += einsum("ac,ic->ia", lvv_t1, t1)
    t1new -= 2.0 * einsum("lcki,klac->ia", ovoo, t2)
    t1new += einsum("kcli,klac->ia", ovoo, t2)
    t1new -= 2.0 * einsum("lcki,lc,ka->ia", ovoo, t1, t1)
    t1new += einsum("kcli,lc,ka->ia", ovoo, t1, t1)

    # --- lambda intermediates (Eqs. 40-41) --------------------------------
    if variant == "cc2":
        # CC2: doubles see only the Fock operator (t1-dressed)
        Loo = foo - torch.diag(mo_e_o) + einsum("kc,ic->ki", fov, t1)
        Lvv = fvv - torch.diag(mo_e_v) - einsum("kc,ka->ac", fov, t1)
    else:
        Loo = Foo_nd + einsum("kc,ic->ki", fov, t1) \
            + 2.0 * einsum("lcki,lc->ki", ovoo, t1) \
            - einsum("kcli,lc->ki", ovoo, t1)
        Lvv = Fvv_nd - einsum("kc,ka->ac", fov, t1) + lvv_t1

    # --- chi intermediates (Eqs. 42-45) -----------------------------------
    Woooo = oooo.permute(0, 2, 1, 3) \
        + einsum("lcki,jc->klij", ovoo, t1) \
        + einsum("kclj,ic->klij", ovoo, t1) \
        + einsum("kcld,ic,jd->klij", ovov, t1, t1)
    if variant != "cc2":
        Woooo = Woooo + einsum("kcld,ijcd->klij", ovov, t2)

    # --- T2 (Eq. 36) ------------------------------------------------------
    # All P(ij|ab)-symmetrized pieces accumulate in place into ONE
    # asymmetric buffer K, symmetrized once at the end; each ring
    # intermediate is freed as soon as its two uses are done, so only a
    # few t2-sized tensors are live at a time.
    tmp2 = ovoo.permute(1, 3, 0, 2) + einsum("kcai,jc->akij", ovvo, t1)
    K = vops.t2_vvov_t1(t1)
    K.sub_(einsum("kibc,ka,jc->ijab", oovv, t1, t1))
    K.sub_(einsum("akij,kb->ijab", tmp2, t1))
    del tmp2
    K.add_(einsum("ac,ijcb->ijab", Lvv, t2))
    K.sub_(einsum("ki,kjab->ijab", Loo, t2))
    if variant != "cc2":
        Wvoov = ovvo.permute(2, 0, 3, 1) \
            + vops.wvoov_t1(t1) \
            - einsum("kcli,la->akic", ovoo, t1) \
            - 0.5 * einsum("ldkc,ilda->akic", ovov, t2) \
            - 0.5 * einsum("lckd,ilad->akic", ovov, t2) \
            - einsum("ldkc,id,la->akic", ovov, t1, t1) \
            + einsum("ldkc,ilad->akic", ovov, t2)
        K.add_(einsum("akic,kjcb->ijab", Wvoov, t2), alpha=2.0)
        K.sub_(einsum("akic,kjbc->ijab", Wvoov, t2))
        del Wvoov
        Wvovo = oovv.permute(2, 0, 3, 1) \
            + vops.wvovo_t1(t1) \
            - einsum("lcki,la->akci", ovoo, t1) \
            - 0.5 * einsum("lckd,ilda->akci", ovov, t2) \
            - einsum("lckd,id,la->akci", ovov, t1, t1)
        K.sub_(einsum("akci,kjcb->ijab", Wvovo, t2))
        K.sub_(einsum("bkci,kjac->ijab", Wvovo, t2))
        del Wvovo

    if variant == "cc2":
        tau = einsum("ia,jb->ijab", t1, t1)
    else:
        tau = t2 + einsum("ia,jb->ijab", t1, t1)
    t2new = K + K.permute(1, 0, 3, 2)
    del K
    t2new += ovov.permute(0, 2, 1, 3)
    t2new += einsum("klij,klab->ijab", Woooo, tau)
    if eris.vvvv is not None:
        t2new += _ladder_vvvv(tau, t1, eris)
    else:
        t2new += _ladder_df(tau, t1, eris, ntile)
    del tau

    eia = mo_e_o[:, None] - mo_e_v[None, :]
    d2 = eia[:, None, :, None] + eia[None, :, None, :]
    t1new /= eia
    t2new /= d2
    if variant == "ccd":
        t1new = torch.zeros_like(t1new)
    return t1new, t2new


def kernel(eris: RERIs, max_cycle=50, conv_tol=1e-8, conv_tol_normt=1e-6,
           diis_space=6, level_shift=0.0, verbose=0, t1=None, t2=None,
           ntile=1, diis_start_cycle=0, variant="ccsd",
           diis_backend="host", adiis=None, diis_file=None,
           diis_err_dtype=None):
    """Host-driven CCSD iteration with DIIS.

    The DIIS ring is the host ``lib.diis.DIIS``: every cycle
    copies the amplitudes to the host (0.74 GB at the (H2O)8 shape) and
    back.  adiis: a preloaded DIIS object to resume from; diis_file: spill
    the ring there every cycle.  Returns (converged, e_corr, t1, t2)."""
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    if diis_backend != "host":
        raise NotImplementedError(
            "diis_backend='device' (lib/device_diis) is ROADMAP A4, "
            "not ported yet")
    if diis_err_dtype is not None:
        raise NotImplementedError(
            "diis_err_dtype applies to the device DIIS ring (ROADMAP A4)")
    log = lg.Logger(verbose=verbose)
    emp2, t1_0, t2_0 = init_amps(eris)
    if t1 is None:
        t1 = t1_0
    if t2 is None:
        t2 = t2_0
    del t1_0, t2_0
    log.info("RCCSD MP2 init E_corr = %.14f", float(emp2))
    nocc, nvir = t1.shape
    t2shape = t2.shape
    dev, dt = t2.device, t2.dtype

    def from_host(vec):
        return (torch.from_numpy(vec[: nocc * nvir].reshape(nocc, nvir))
                .to(dev, dt),
                torch.from_numpy(vec[nocc * nvir:].reshape(t2shape))
                .to(dev, dt))

    e_last = float(energy(t1, t2, eris))
    converged = False
    diis = adiis if adiis is not None else DIIS(space=diis_space)
    if adiis is not None and adiis._xs:
        # resume from the last extrapolated amplitudes in the ring
        t1, t2 = from_host(adiis._xs[-1])
    for it in range(max_cycle):
        t1new, t2new = update_amps(t1, t2, eris, level_shift, ntile=ntile,
                                   variant=variant)
        normt = float(torch.linalg.norm(t1new - t1)
                      + torch.linalg.norm(t2new - t2))
        if it < diis_start_cycle:
            t1, t2 = t1new, t2new
        else:
            del t1, t2
            vec = np.concatenate([t1new.cpu().numpy().ravel(),
                                  t2new.cpu().numpy().ravel()])
            del t1new, t2new    # 0.74 GB each at production scale
            vec = diis.update(vec)
            t1, t2 = from_host(vec)
            del vec
            if diis_file is not None:
                diis.dump(diis_file)
        e = float(energy(t1, t2, eris))
        log.info("cycle %2d  E_corr(RCCSD) = %.14f  dE = %10.3e  "
                 "|dt| = %9.3e", it, e, e - e_last, normt)
        if abs(e - e_last) < conv_tol and normt < conv_tol_normt:
            converged = True
            break
        e_last = e
    return converged, e, t1, t2


def flops_per_update(nocc, nvir, naux=None, ntile=None):
    """Analytic FLOP count of one update — the denominator for throughput
    reporting (copied from the JAX package unchanged).

    With ntile=None (default) this is the DENSE-EQUIVALENT algorithmic
    count: every contraction of the textbook DF update at full size.
    With an integer ntile, returns the FLOPs the pair-tiled ladder
    actually executes: the two O(nv^4) ladder terms scale by
    npair/ntile^2 = (1 + 1/ntile)/2 at the padded virtual dimension."""
    no, nv = nocc, nvir
    fl = 0.0
    if naux:
        if ntile:
            tsz = -(-nv // ntile)
            nvp = ntile * tsz
            frac = (ntile * (ntile + 1) / 2) / ntile**2
            fl += 2.0 * naux * nvp**4 * frac   # ladder W = Ld^T Ld, pairs
            fl += 2.0 * no**2 * nvp**4 * frac  # tau * Wvvvv, pairs
        else:
            fl += 2.0 * naux * nv**4           # ladder W (dense equivalent)
            fl += 2.0 * no**2 * nv**4          # tau * Wvvvv
        fl += 2.0 * naux * no**2 * nv**2 * 6  # ovvv-free factorized terms
        fl += 2.0 * naux * no * nv**2 * 4     # Ld dressing + small DF dots
    else:
        fl += 2.0 * no * nv**4 * 2          # materialized chi_vvvv dressing
        fl += 2.0 * no**2 * nv**4           # tau * Wvvvv
    fl += 2.0 * no**3 * nv**3 * 8           # rings: 4 Wvoov/Wvovo t2-builds
    #                                         + 4 t2 contractions
    fl += 2.0 * no**4 * nv**2 * 3           # Woooo build/use + quadratic fix
    fl += 2.0 * no**3 * nv**2 * 6 + 2.0 * no**2 * nv**3 * 2  # F/L closures
    return fl
