"""Restricted (closed-shell) CCSD.

Port of ``pyscf_mpcc_tpu/cc/rccsd.py``: the spin-adapted CCSD equations of
Hirata et al., J. Chem. Phys. 120, 2581 (2004), Eqs. (35)-(45), as dense
torch contractions (cuBLAS GEMMs on the card).  The O(nocc^2 nvir^4)
particle-particle ladder runs from materialized vvvv (small systems) or
from density-fitted Lvv factors over symmetric virtual tile pairs, the
factor on the device or streamed from host memory (cc/stream_ladder).

PyTorch runs eagerly, so the JAX package's ``jax.jit`` and
``optimization_barrier`` have no counterpart: the P(ij|ab) pieces of the
doubles residual accumulate in place into one buffer instead, which bounds
the number of live t2-sized temporaries the same way.  ``jax.checkpoint``
becomes ``torch.utils.checkpoint`` around each ladder pair and the ring W
tensors (``_remat``), engaged only when autograd records the call.

``residual_segments`` splits the residual into the pieces the Λ solver
(cc/lambda_ad) differentiates one at a time; ``kernel`` iterates the sweep
with the host DIIS or the device ring (lib/device_diis).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pyscf_mpcc_tpu_torch.cc.eris import RERIs
from pyscf_mpcc_tpu_torch.utils.profiling import count, span

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
    if eris.mesh is not None:
        # ovvv in occupied-row shards over a mesh (parallel/mesh)
        from pyscf_mpcc_tpu_torch.parallel import mesh as pmesh
        return pmesh.ladder_vvvv(tau, t1, eris)
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
        # out-of-core: Lvv stays in host memory and the pair sweep fetches
        # its row tiles (cc/stream_ladder)
        from pyscf_mpcc_tpu_torch.cc import stream_ladder
        out = stream_ladder.pair_ladder_sym(tau, t1, eris.Lov,
                                            eris.Lvv_stream, ntile)
    elif eris.mesh is not None:
        # Lvv and Lov in aux shards over a mesh (parallel/mesh): each rank
        # dresses and sweeps its shard, the partial ladders are summed
        from pyscf_mpcc_tpu_torch.parallel.ladder_shard import ladder_sharded
        Ld = eris.Lvv - einsum("ka,Lkc->Lac", t1, eris.Lov)
        out = ladder_sharded(tau, Ld, eris.mesh, ntile, mirrored=True)
        del Ld
    else:
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
    exact no-op for the symmetric iterates the solvers produce).  nvir is
    zero-padded to a tile multiple; any ntile >= 1 works (see
    mirrored_sweep).
    """
    naux, nvir = Ld.shape[0], Ld.shape[1]
    ntile = max(1, min(int(ntile), nvir))
    tsz = -(-nvir // ntile)
    nvp = ntile * tsz
    pad = nvp - nvir
    if pad:
        # padded a-rows of Ld are zero -> zero output rows (mirrors stay
        # exact); padded c-columns contract against zero tau columns
        Ld = torch.nn.functional.pad(Ld, (0, pad, 0, pad))
    Ld_t = Ld.reshape(naux, ntile, tsz * nvp)
    return mirrored_sweep(
        tau, ntile, tsz,
        lambda tau, a, b, nxt: _remat(_pair_block, Ld_t, tau, a, b))


def mirrored_sweep(tau, ntile, tsz, block):
    """The mirrored pair sweep of pair_ladder_sym and of the streamed
    ladder (cc/stream_ladder): tau symmetrized and zero-padded to
    ntile*tsz virtuals; ``block(tau, a, b, nxt)`` gives the A >= B block
    (nxt: the first tile of the next pair, None after the last).  Each
    block is written once into the output, diagonal blocks halved, and
    the mirrors are applied by ONE S + S.permute(1,0,3,2) at the end.
    The counter ``ladder.w_elems`` (utils/profiling) adds the W elements
    the blocks build, tsz^2 nvp^2 a pair."""
    # exact pass-through for symmetric tau (x+x is exact, 0.5* is exact)
    tau = 0.5 * (tau + tau.permute(1, 0, 3, 2))
    nocc, nvir = tau.shape[0], tau.shape[2]
    nvp = ntile * tsz
    pad = nvp - nvir
    if pad:
        tau = torch.nn.functional.pad(tau, (0, pad, 0, pad))
    s = torch.zeros((nocc, nocc, nvp, nvp), dtype=tau.dtype,
                    device=tau.device)
    pairs = [(a, b) for a in range(ntile) for b in range(a + 1)]
    count("ladder.w_elems", len(pairs) * tsz * tsz * nvp * nvp)
    for k, (a, b) in enumerate(pairs):
        nxt = pairs[k + 1][0] if k + 1 < len(pairs) else None
        blk = block(tau, a, b, nxt)
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


def _pair_block(Ld_t, tau, a, b):
    """One A >= B block of the ladder: w[(a,c),(b,d)] = sum_L Ld[L,a,c]
    Ld[L,b,d] as one GEMM, contracted with tau."""
    nvp = tau.shape[-1]
    tsz = Ld_t.shape[2] // nvp
    w = (Ld_t[:, a].T @ Ld_t[:, b]).view(tsz, nvp, tsz, nvp)
    return einsum("acbd,ijcd->ijab", w, tau)


class _OvvvOps:
    """The ovvv-block contractions, in materialized or DF-factorized form.

    At production scale the (ia|bc) block is O(nocc nvir^3) and is not
    materialized (12 GB for (H2O)8/cc-pVTZ in fp32); every use factorizes
    exactly through the 3-center L tensors."""

    ROUTED = ("t1_t2_terms", "lvv_t1", "wvoov_t1", "wvovo_t1",
              "t2_vvov_t1")

    def __init__(self, eris: RERIs, ntile=1):
        self.eris = eris
        self.df = eris.ovvv is None
        route = None
        if eris.Lvv_stream is not None:
            # out-of-core: every contraction routes to the StreamedOvvv
            # twin (same math, Lvv row tiles fetched from host memory)
            from pyscf_mpcc_tpu_torch.cc import stream_ladder
            route = stream_ladder.StreamedOvvv(
                eris.Lvv_stream, eris.Lov, eris.nvir, ntile)
        elif eris.mesh is not None:
            # sharded over a mesh: each rank contracts its shard and the
            # partials are summed or gathered (parallel/mesh.ShardedOvvv)
            from pyscf_mpcc_tpu_torch.parallel import mesh as pmesh
            route = pmesh.ShardedOvvv(eris, ntile)
        if route is not None:
            # instance attributes shadow the class methods below
            for m in self.ROUTED:
                setattr(self, m, getattr(route, m))

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


def _remat(fn, *args):
    """fn(*args), recomputed in the backward pass instead of having its
    intermediates saved, when autograd records the call (grad mode on and
    an argument requires grad); a plain call otherwise, so the forward-only
    CCSD sweep runs as if the wrapper were not there.

    Under autograd a saved 4-index intermediate is what the Lambda step
    cannot afford: every pair's W block of the ladder (0.82 nvir^4
    elements, 129 GB in fp32 at the (H2O)8 shape) or the ring W tensors.
    Each checkpointed call keeps only its arguments (references, no
    copies) and recomputes its intermediates one at a time in the
    backward pass."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(a) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _tau(t1, t2, variant="ccsd"):
    if variant == "cc2":
        return einsum("ia,jb->ijab", t1, t1)
    return t2 + einsum("ia,jb->ijab", t1, t1)


def _kappa(t1, t2, eris, level_shift=0.0):
    """Foo, Fvv with the Fock diagonal removed, and Fov (Eqs. 37-39)."""
    nocc = eris.nocc
    fock, ovov = eris.fock, eris.ovov
    Foo = fock[:nocc, :nocc] + 2.0 * einsum("kcld,ilcd->ki", ovov, t2) \
        - einsum("kdlc,ilcd->ki", ovov, t2) \
        + 2.0 * einsum("kcld,ic,ld->ki", ovov, t1, t1) \
        - einsum("kdlc,ic,ld->ki", ovov, t1, t1)
    Fvv = fock[nocc:, nocc:] - 2.0 * einsum("kcld,klad->ac", ovov, t2) \
        + einsum("kdlc,klad->ac", ovov, t2) \
        - 2.0 * einsum("kcld,ka,ld->ac", ovov, t1, t1) \
        + einsum("kdlc,ka,ld->ac", ovov, t1, t1)
    Fov = fock[:nocc, nocc:] + 2.0 * einsum("kcld,ld->kc", ovov, t1) \
        - einsum("kdlc,ld->kc", ovov, t1)
    return (Foo - torch.diag(eris.mo_energy[:nocc]),
            Fvv - torch.diag(eris.mo_energy[nocc:] + level_shift), Fov)


def _loo_lvv(t1, eris, Foo_nd, Fvv_nd, lvv_t1, variant="ccsd",
             level_shift=0.0):
    """Loo, Lvv (Eqs. 40-41); CC2's doubles see only the t1-dressed
    Fock operator."""
    nocc = eris.nocc
    fock, ovoo = eris.fock, eris.ovoo
    fov = fock[:nocc, nocc:]
    if variant == "cc2":
        Loo = fock[:nocc, :nocc] - torch.diag(eris.mo_energy[:nocc]) \
            + einsum("kc,ic->ki", fov, t1)
        Lvv = fock[nocc:, nocc:] \
            - torch.diag(eris.mo_energy[nocc:] + level_shift) \
            - einsum("kc,ka->ac", fov, t1)
    else:
        Loo = Foo_nd + einsum("kc,ic->ki", fov, t1) \
            + 2.0 * einsum("lcki,lc->ki", ovoo, t1) \
            - einsum("kcli,lc->ki", ovoo, t1)
        Lvv = Fvv_nd - einsum("kc,ka->ac", fov, t1) + lvv_t1
    return Loo, Lvv


def _woooo(t1, t2, eris, variant="ccsd"):
    ovoo, ovov = eris.ovoo, eris.ovov
    Woooo = eris.oooo.permute(0, 2, 1, 3) \
        + einsum("lcki,jc->klij", ovoo, t1) \
        + einsum("kclj,ic->klij", ovoo, t1) \
        + einsum("kcld,ic,jd->klij", ovov, t1, t1)
    if variant != "cc2":
        Woooo = Woooo + einsum("kcld,ijcd->klij", ovov, t2)
    return Woooo


def _wvoov(t1, t2, eris, vops):
    ovoo, ovov = eris.ovoo, eris.ovov
    return eris.get_ovvo().permute(2, 0, 3, 1) \
        + vops.wvoov_t1(t1) \
        - einsum("kcli,la->akic", ovoo, t1) \
        - 0.5 * einsum("ldkc,ilda->akic", ovov, t2) \
        - 0.5 * einsum("lckd,ilad->akic", ovov, t2) \
        - einsum("ldkc,id,la->akic", ovov, t1, t1) \
        + einsum("ldkc,ilad->akic", ovov, t2)


def _wvovo(t1, t2, eris, vops):
    ovoo, ovov = eris.ovoo, eris.ovov
    return eris.oovv.permute(2, 0, 3, 1) \
        + vops.wvovo_t1(t1) \
        - einsum("lcki,la->akci", ovoo, t1) \
        - 0.5 * einsum("lckd,ilda->akci", ovov, t2) \
        - einsum("lckd,id,la->akci", ovov, t1, t1)


def update_amps(t1, t2, eris: RERIs, level_shift=0.0, ntile=1,
                variant="ccsd"):
    """One Jacobi sweep of the RCCSD / CC2 / CCD equations.

    variant: 'ccsd' (default), 'cc2' (T2 truncated to first order in the
    fluctuation potential with t1-dressing), 'ccd' (t1 pinned at zero)."""
    if variant not in ("ccsd", "cc2", "ccd"):
        raise ValueError(f"unknown variant {variant!r}")
    nocc = eris.nocc
    fov = eris.fock[:nocc, nocc:]
    mo_e_o = eris.mo_energy[:nocc]
    mo_e_v = eris.mo_energy[nocc:] + level_shift

    ovov = eris.ovov
    ovoo = eris.ovoo
    ovvo = eris.get_ovvo()
    oovv = eris.oovv
    vops = _OvvvOps(eris, ntile)

    # --- kappa intermediates (Eqs. 37-39), Fock diagonal removed ---------
    Foo_nd, Fvv_nd, Fov = _kappa(t1, t2, eris, level_shift)

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
    Loo, Lvv = _loo_lvv(t1, eris, Foo_nd, Fvv_nd, lvv_t1, variant,
                        level_shift)

    # --- chi intermediates (Eqs. 42-45) -----------------------------------
    Woooo = _woooo(t1, t2, eris, variant)

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
        Wvoov = _wvoov(t1, t2, eris, vops)
        K.add_(einsum("akic,kjcb->ijab", Wvoov, t2), alpha=2.0)
        K.sub_(einsum("akic,kjbc->ijab", Wvoov, t2))
        del Wvoov
        Wvovo = _wvovo(t1, t2, eris, vops)
        K.sub_(einsum("akci,kjcb->ijab", Wvovo, t2))
        K.sub_(einsum("bkci,kjac->ijab", Wvovo, t2))
        del Wvovo

    tau = _tau(t1, t2, variant)
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


def residual_segments(eris: RERIs, ntile=1, variant="ccsd"):
    """The amplitude residual R(t) = update_raw(t) - t*D as independent
    pieces, for the segmented Lambda vjp (cc/lambda_ad._lambda_step).

    Returns a list of (fn, kind); fn(t1, t2) computes one additive piece
    and kind names the cotangent it takes:
      'r1'  contributes to R1 directly          (cotangent l1)
      'k'   contributes to R2 as  K + K^(jiba)  (cotangent l2 + l2^(jiba))
      'r2'  contributes to R2 directly          (cotangent l2)
    The diagonal -t*D piece is analytic and not included.  The list,
    its order, kinds and names are those of the JAX package's default
    (rings split, ladder included), so each piece can be held to its
    twin.

    Differentiating the whole update at once keeps every ring
    intermediate's cotangent live together; one piece at a time, the
    backward's peak is the largest piece's.  R1 is split along its
    intermediate families so each piece holds at most two t2-sized
    partials."""
    nocc = eris.nocc
    fov = eris.fock[:nocc, nocc:]
    ovov, ovoo, oovv = eris.ovov, eris.ovoo, eris.oovv
    ovvo = eris.get_ovvo()
    vops = _OvvvOps(eris, ntile)

    def seg_t1_fvv(t1, t2):
        _, Fvv_nd, _ = _kappa(t1, t2, eris)
        r = fov.to(t1.dtype) + torch.zeros_like(t1)
        r = r - 2.0 * einsum("kc,ka,ic->ia", fov, t1, t1)
        return r + einsum("ac,ic->ia", Fvv_nd, t1)

    def seg_t1_foo(t1, t2):
        Foo_nd, _, _ = _kappa(t1, t2, eris)
        return -einsum("ki,ka->ia", Foo_nd, t1)

    def seg_t1_fov(t1, t2):
        _, _, Fov = _kappa(t1, t2, eris)
        r = 2.0 * einsum("kc,kica->ia", Fov, t2)
        r = r - einsum("kc,ikca->ia", Fov, t2)
        return r + einsum("kc,ic,ka->ia", Fov, t1, t1)

    def seg_t1_rest(t1, t2):
        r = 2.0 * einsum("kcai,kc->ia", ovvo, t1)
        r = r - einsum("kiac,kc->ia", oovv, t1)
        r = r + vops.t1_t2_terms(t2)
        r = r + einsum("ac,ic->ia", vops.lvv_t1(t1), t1)
        r = r - 2.0 * einsum("lcki,klac->ia", ovoo, t2)
        r = r + einsum("kcli,klac->ia", ovoo, t2)
        r = r - 2.0 * einsum("lcki,lc,ka->ia", ovoo, t1, t1)
        return r + einsum("kcli,lc,ka->ia", ovoo, t1, t1)

    def seg_k_light(t1, t2):
        Foo_nd, Fvv_nd, _ = _kappa(t1, t2, eris)
        Loo, Lvv = _loo_lvv(t1, eris, Foo_nd, Fvv_nd, vops.lvv_t1(t1),
                            variant)
        tmp2 = ovoo.permute(1, 3, 0, 2) + einsum("kcai,jc->akij", ovvo, t1)
        K = vops.t2_vvov_t1(t1)
        K = K - einsum("kibc,ka,jc->ijab", oovv, t1, t1)
        K = K - einsum("akij,kb->ijab", tmp2, t1)
        del tmp2
        K = K + einsum("ac,ijcb->ijab", Lvv, t2)
        return K - einsum("ki,kjab->ijab", Loo, t2)

    def seg_ring_voov(t1, t2):
        W = _remat(lambda a, b: _wvoov(a, b, eris, vops), t1, t2)
        K = 2.0 * einsum("akic,kjcb->ijab", W, t2)
        return K - einsum("akic,kjbc->ijab", W, t2)

    def seg_ring_vovo(t1, t2):
        W = _remat(lambda a, b: _wvovo(a, b, eris, vops), t1, t2)
        K = -einsum("akci,kjcb->ijab", W, t2)
        return K - einsum("bkci,kjac->ijab", W, t2)

    def seg_oooo(t1, t2):
        return einsum("klij,klab->ijab", _woooo(t1, t2, eris, variant),
                      _tau(t1, t2, variant))

    def seg_ladder(t1, t2):
        tau = _tau(t1, t2, variant)
        if eris.vvvv is not None:
            return _ladder_vvvv(tau, t1, eris)
        return _ladder_df(tau, t1, eris, ntile)

    segs = [(seg_t1_fvv, "r1"), (seg_t1_foo, "r1"), (seg_t1_fov, "r1"),
            (seg_t1_rest, "r1"), (seg_k_light, "k")]
    if variant == "ccd":
        segs = [(seg_k_light, "k")]
    if variant != "cc2":
        segs += [(seg_ring_voov, "k"), (seg_ring_vovo, "k")]
    return segs + [(seg_oooo, "r2"), (seg_ladder, "r2")]


def residual_from_segments(t1, t2, eris: RERIs, ntile=1, variant="ccsd"):
    """R(t) assembled from the segments plus the constant and diagonal
    pieces (the validation path; the Lambda solver needs only the vjp)."""
    nocc = eris.nocc
    eia = eris.mo_energy[:nocc, None] - eris.mo_energy[None, nocc:]
    d2 = eia[:, None, :, None] + eia[None, :, None, :]
    r1 = -t1 * eia
    r2 = eris.ovov.permute(0, 2, 1, 3) - t2 * d2
    for fn, kind in residual_segments(eris, ntile, variant):
        c = fn(t1, t2)
        if kind == "r1":
            r1 = r1 + c
        elif kind == "k":
            r2 = r2 + c + c.permute(1, 0, 3, 2)
        else:
            r2 = r2 + c
    if variant == "ccd":
        r1 = torch.zeros_like(r1)
    return r1, r2


def kernel(eris: RERIs, max_cycle=50, conv_tol=1e-8, conv_tol_normt=1e-6,
           diis_space=6, level_shift=0.0, verbose=0, t1=None, t2=None,
           ntile=1, diis_start_cycle=0, variant="ccsd",
           diis_backend="host", adiis=None, diis_file=None,
           diis_err_dtype=None):
    """Host-driven CCSD iteration with DIIS.

    diis_backend='host': the ring is the host ``lib.diis.DIIS``; every
    cycle copies the amplitudes to the host (0.74 GB at the (H2O)8 shape)
    and back.  adiis: a preloaded host DIIS object to resume from;
    diis_file: spill the ring there every cycle.  diis_backend='device':
    the ring stays on the device (lib/device_diis.update_hostsolve; only
    the Gram matrix crosses to the host), the error is the step
    vec_new - vec_old, and diis_err_dtype=torch.bfloat16 halves the error
    ring.  Returns (converged, e_corr, t1, t2)."""
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    if diis_backend not in ("host", "device"):
        raise ValueError(f"unknown diis_backend {diis_backend!r}")
    if diis_err_dtype is not None and diis_backend != "device":
        raise ValueError("diis_err_dtype applies to the device DIIS ring")
    log = lg.Logger(verbose=verbose)
    with span("ccsd.solve"):
        emp2, t1_0, t2_0 = init_amps(eris)
        if t1 is None:
            t1 = t1_0
        if t2 is None:
            t2 = t2_0
        del t1_0, t2_0
        with span("sync.emp2"):
            emp2 = float(emp2)
        log.info("RCCSD MP2 init E_corr = %.14f", emp2)
        shapes = (t1.shape, t2.shape)
        dev, dt = t2.device, t2.dtype
        with span("sync.energy0"):
            e_last = float(energy(t1, t2, eris))
        converged = False
        if diis_backend == "device":
            from pyscf_mpcc_tpu_torch.lib import device_diis
            dstate = device_diis.init(t1.numel() + t2.numel(), diis_space,
                                      dt, err_dtype=diis_err_dtype,
                                      device=dev)
            vec_old = _pack(t1, t2)
        else:
            diis = adiis if adiis is not None else DIIS(space=diis_space)
            if adiis is not None and adiis._xs:
                # resume from the last extrapolated amplitudes in the ring
                t1, t2 = _unpack(torch.from_numpy(adiis._xs[-1]).to(dev, dt),
                                 *shapes)
        for it in range(max_cycle):
            with span("ccsd.cycle", device=True):
                with span("ccsd.update_amps", device=True):
                    t1new, t2new = update_amps(t1, t2, eris, level_shift,
                                               ntile=ntile, variant=variant)
                with span("sync.normt"):
                    normt = float(torch.linalg.norm(t1new - t1)
                                  + torch.linalg.norm(t2new - t2))
                if it < diis_start_cycle:
                    t1, t2 = t1new, t2new
                elif diis_backend == "device":
                    with span("ccsd.diis", device=True):
                        del t1, t2
                        vec_new = _pack(t1new, t2new)
                        del t1new, t2new  # 0.74 GB each at production scale
                        dstate, vec = device_diis.update_hostsolve(
                            dstate, vec_new, vec_new - vec_old)
                        del vec_new
                        vec_old = vec
                        t1, t2 = _unpack(vec, *shapes)
                else:
                    with span("ccsd.diis", device=True):
                        del t1, t2
                        with span("sync.ring_to_host"):
                            vec = np.concatenate([t1new.cpu().numpy().ravel(),
                                                  t2new.cpu().numpy().ravel()])
                        del t1new, t2new  # 0.74 GB each at production scale
                        vec = diis.update(vec)
                        t1, t2 = _unpack(torch.from_numpy(vec).to(dev, dt),
                                         *shapes)
                        del vec
                        if diis_file is not None:
                            diis.dump(diis_file)
                with span("ccsd.energy", device=True):
                    e = energy(t1, t2, eris)
                with span("sync.energy"):
                    e = float(e)
                log.info("cycle %2d  E_corr(RCCSD) = %.14f  dE = %10.3e  "
                         "|dt| = %9.3e", it, e, e - e_last, normt)
                if abs(e - e_last) < conv_tol and normt < conv_tol_normt:
                    converged = True
                    break
                e_last = e
    return converged, e, t1, t2


def _pack(a, b):
    """One flat vector of (a, b), the DIIS vector layout."""
    return torch.cat([a.reshape(-1), b.reshape(-1)])


def _unpack(vec, shape1, shape2):
    """(a, b) views of a flat DIIS vector made by _pack."""
    n1 = int(np.prod(shape1))
    return vec[:n1].view(shape1), vec[n1:].view(shape2)


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
