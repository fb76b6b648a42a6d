"""Plain fp64 closed-shell DF-CCSD: the MO integrals, the amplitude
residual, the energy, a Jacobi/DIIS solve and the Lambda residual.

This is the yardstick the port is judged by.  It imports nothing of the
program, holds every tensor in float64, and is written from the
spin-adapted CCSD equations (Hirata et al., J. Chem. Phys. 120, 2581
(2004), in PySCF's rccsd/rintermediates arrangement) and from the
density-fitting definition (pq|rs) = sum_L L[L,p,q] L[L,r,s]:

- the (ov|vv) block is never stored, each use contracts through L;
- the particle-particle ladder is summed in blocks of virtual rows a, each
  block's (ac|bd) built from the t1-dressed factor and dropped after use.

The residual is R(t) = N(t) - t D, where N is the right-hand side of the
amplitude equations with the Fock diagonal moved to the left and D the
orbital-energy denominators, so R = 0 at the solution and R / D is one
Jacobi step.  It is built as a sum of pieces (``PIECES``) so that the
Lambda residual, the gradient of E(t) + <l, R(t)>, can back-propagate one
piece at a time and never holds every piece's graph at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

einsum = torch.einsum
F64 = torch.float64


class Ints(NamedTuple):
    """fp64 MO quantities of one molecule (o = active occupied, v =
    virtual): Fock blocks, orbital energies and the DF factors with the
    four-index blocks the equations read."""
    foo: torch.Tensor
    fov: torch.Tensor
    fvv: torch.Tensor
    eo: torch.Tensor
    ev: torch.Tensor
    Loo: torch.Tensor   # (L, o, o)
    Lov: torch.Tensor   # (L, o, v)
    Lvv: torch.Tensor   # (L, v, v)
    ovov: torch.Tensor  # (ia|jb)
    oovv: torch.Tensor  # (ij|ab)
    ovoo: torch.Tensor  # (ia|jk)
    oooo: torch.Tensor  # (ij|kl)


def mo_ints(B, mo, fock_ao, nocc):
    """Ints from the AO factors B (naux, nao, nao), the active MO
    coefficients mo (nao, nmo) and the AO Fock matrix, all taken to fp64
    on B's device."""
    dev = B.device
    B = B.to(dev, F64)
    C = torch.as_tensor(mo).to(dev, F64)
    f = C.T @ torch.as_tensor(fock_ao).to(dev, F64) @ C
    co, cv = C[:, :nocc], C[:, nocc:]
    half_o = einsum("Lpq,pi->Liq", B, co)
    Loo = einsum("Liq,qj->Lij", half_o, co)
    Lov = einsum("Liq,qa->Lia", half_o, cv)
    del half_o
    Lvv = einsum("Lpa,pb->Lab", einsum("Lpq,qa->Lpa", B, cv), cv)
    o = slice(0, nocc)
    v = slice(nocc, C.shape[1])
    d = torch.diagonal(f)

    def pair(x, y):
        return einsum("Lpq,Lrs->pqrs", x, y)

    return Ints(foo=f[o, o], fov=f[o, v], fvv=f[v, v], eo=d[o], ev=d[v],
                Loo=Loo, Lov=Lov, Lvv=Lvv, ovov=pair(Lov, Lov),
                oovv=pair(Loo, Lvv), ovoo=pair(Lov, Loo),
                oooo=pair(Loo, Loo))


def denominators(ints):
    eia = ints.eo[:, None] - ints.ev[None, :]
    return eia, eia[:, None, :, None] + eia[None, :, None, :]


def energy(t1, t2, ints):
    tau = t2 + einsum("ia,jb->ijab", t1, t1)
    return (2.0 * einsum("ia,ia->", ints.fov, t1)
            + 2.0 * einsum("ijab,iajb->", tau, ints.ovov)
            - einsum("ijab,ibja->", tau, ints.ovov))


def mp2_guess(ints):
    eia, d2 = denominators(ints)
    return ints.fov / eia, ints.ovov.permute(0, 2, 1, 3) / d2


def _sym(x):
    """x_ijab + x_jiba."""
    return x + x.permute(1, 0, 3, 2)


def _fock_intermediates(t1, t2, ints):
    """Foo, Fvv, Fov of the CCSD equations (Fock diagonal not removed)."""
    g = ints.ovov
    foo = (ints.foo + 2.0 * einsum("kcld,ilcd->ki", g, t2)
           - einsum("kdlc,ilcd->ki", g, t2)
           + 2.0 * einsum("kcld,ic,ld->ki", g, t1, t1)
           - einsum("kdlc,ic,ld->ki", g, t1, t1))
    fvv = (ints.fvv - 2.0 * einsum("kcld,klad->ac", g, t2)
           + einsum("kdlc,klad->ac", g, t2)
           - 2.0 * einsum("kcld,ka,ld->ac", g, t1, t1)
           + einsum("kdlc,ka,ld->ac", g, t1, t1))
    fov = (ints.fov + 2.0 * einsum("kcld,ld->kc", g, t1)
           - einsum("kdlc,ld->kc", g, t1))
    return foo, fvv, fov


def _ovvv_t1(t1, ints):
    """2 (kd|ac) t1_kd - (kc|ad) t1_kd -> [a, c], through L."""
    z = einsum("Lkd,kd->L", ints.Lov, t1)
    x = einsum("Lkc,kd->Lcd", ints.Lov, t1)
    return 2.0 * einsum("L,Lac->ac", z, ints.Lvv) - einsum(
        "Lcd,Lad->ac", x, ints.Lvv)


def piece_t1(t1, t2, ints):
    """Every term of the singles equation except fov and -t1 D."""
    foo, fvv, fov = _fock_intermediates(t1, t2, ints)
    foo = foo - torch.diag(ints.eo)
    fvv = fvv - torch.diag(ints.ev)
    f0 = ints.fov
    g = ints.ovov
    r = -2.0 * einsum("kc,ka,ic->ia", f0, t1, t1)
    r = r + einsum("ac,ic->ia", fvv, t1) - einsum("ki,ka->ia", foo, t1)
    r = r + 2.0 * einsum("kc,kica->ia", fov, t2) - einsum(
        "kc,ikca->ia", fov, t2)
    r = r + einsum("kc,ic,ka->ia", fov, t1, t1)
    # (kc|ai) = (kc|ia)
    r = r + 2.0 * einsum("kcia,kc->ia", g, t1) - einsum(
        "kiac,kc->ia", ints.oovv, t1)
    # 2 (kd|ac) t2_ikcd - (kc|ad) t2_ikcd
    x = einsum("Lkd,ikcd->Lic", ints.Lov, t2)
    y = einsum("Lkc,ikcd->Lid", ints.Lov, t2)
    r = r + 2.0 * einsum("Lic,Lac->ia", x, ints.Lvv) - einsum(
        "Lid,Lad->ia", y, ints.Lvv)
    r = r + einsum("ac,ic->ia", _ovvv_t1(t1, ints), t1)
    w = ints.ovoo
    r = r - 2.0 * einsum("lcki,klac->ia", w, t2) + einsum(
        "kcli,klac->ia", w, t2)
    r = r - 2.0 * einsum("lcki,lc,ka->ia", w, t1, t1) + einsum(
        "kcli,lc,ka->ia", w, t1, t1)
    return r, None


def piece_t2_light(t1, t2, ints):
    """The doubles terms in t1 alone and the Loo / Lvv terms."""
    foo, fvv, _ = _fock_intermediates(t1, t2, ints)
    loo = (foo + einsum("kc,ic->ki", ints.fov, t1)
           + 2.0 * einsum("lcki,lc->ki", ints.ovoo, t1)
           - einsum("kcli,lc->ki", ints.ovoo, t1) - torch.diag(ints.eo))
    lvv = (fvv - einsum("kc,ka->ac", ints.fov, t1) + _ovvv_t1(t1, ints)
           - torch.diag(ints.ev))
    # sum_c [(ia|cb) - (ki|bc) t1_ka] t1_jc
    x = einsum("Lcb,jc->Ljb", ints.Lvv, t1)
    tmp = einsum("Lia,Ljb->ijab", ints.Lov, x) - einsum(
        "kibc,ka,jc->ijab", ints.oovv, t1, t1)
    # sum_k [(kc|ai) t1_jc + (ia|jk)] t1_kb, with (kc|ai) = (kc|ia)
    tmp2 = einsum("kcia,jc->akij", ints.ovov, t1) + ints.ovoo.permute(
        1, 3, 0, 2)
    tmp = tmp - einsum("akij,kb->ijab", tmp2, t1)
    tmp = tmp + einsum("ac,ijcb->ijab", lvv, t2) - einsum(
        "ki,kjab->ijab", loo, t2)
    return None, _sym(tmp)


def _wvoov(t1, t2, ints):
    g = ints.ovov
    x = einsum("Lad,id->Lai", ints.Lvv, t1)
    # (kc|ad) t1_id - (kc|li) t1_la + (kc|ai) - ..., with (kc|ai) = (kc|ia)
    return (einsum("Lkc,Lai->akic", ints.Lov, x)
            - einsum("kcli,la->akic", ints.ovoo, t1)
            + g.permute(3, 0, 2, 1)
            - 0.5 * einsum("ldkc,ilda->akic", g, t2)
            - 0.5 * einsum("lckd,ilad->akic", g, t2)
            - einsum("ldkc,id,la->akic", g, t1, t1)
            + einsum("ldkc,ilad->akic", g, t2))


def _wvovo(t1, t2, ints):
    g = ints.ovov
    x = einsum("Lkd,id->Lki", ints.Lov, t1)
    return (einsum("Lki,Lac->akci", x, ints.Lvv)
            - einsum("lcki,la->akci", ints.ovoo, t1)
            + ints.oovv.permute(2, 0, 3, 1)
            - 0.5 * einsum("lckd,ilda->akci", g, t2)
            - einsum("lckd,id,la->akci", g, t1, t1))


def piece_ring_voov(t1, t2, ints):
    w = _wvoov(t1, t2, ints)
    tmp = 2.0 * einsum("akic,kjcb->ijab", w, t2) - einsum(
        "akic,kjbc->ijab", w, t2)
    return None, _sym(tmp)


def piece_ring_vovo(t1, t2, ints):
    w = _wvovo(t1, t2, ints)
    tmp = -einsum("akci,kjcb->ijab", w, t2) - einsum(
        "bkci,kjac->ijab", w, t2)
    return None, _sym(tmp)


def piece_oooo(t1, t2, ints):
    w = ints.ovoo
    woooo = (ints.oooo.permute(0, 2, 1, 3)
             + einsum("lcki,jc->klij", w, t1)
             + einsum("kclj,ic->klij", w, t1)
             + einsum("kcld,ijcd->klij", ints.ovov, t2)
             + einsum("kcld,ic,jd->klij", ints.ovov, t1, t1))
    tau = t2 + einsum("ia,jb->ijab", t1, t1)
    return None, einsum("klij,klab->ijab", woooo, tau)


def _ladder_rows(ld, tau, a0, a1):
    """sum_cd W[a,b,c,d] tau[i,j,c,d] for rows a0 <= a < a1, with
    W[a,b,c,d] = sum_L ld[L,a,c] ld[L,b,d]."""
    w = einsum("Lac,Lbd->abcd", ld[:, a0:a1], ld)
    return einsum("abcd,ijcd->ijab", w, tau)


def piece_ladder(t1, t2, ints, rows=8):
    """The particle-particle ladder sum_cd W_abcd tau_ijcd with
    W_abcd = (ac|bd) - (kd|ac) t1_kb - (kc|bd) t1_ka.  Through the dressed
    factor ld = Lvv - t1^T Lov, sum_L ld_ac ld_bd is W plus
    sum_kl t1_ka t1_lb (kc|ld), which is subtracted.  Under autograd each
    block is recomputed in the backward pass instead of stored."""
    tau = t2 + einsum("ia,jb->ijab", t1, t1)
    ld = ints.Lvv - einsum("ka,Lkc->Lac", t1, ints.Lov)
    nvir = ld.shape[1]
    grad = torch.is_grad_enabled() and (t1.requires_grad or t2.requires_grad)
    blocks = []
    for a0 in range(0, nvir, rows):
        a1 = min(a0 + rows, nvir)
        if grad:
            blocks.append(checkpoint(_ladder_rows, ld, tau, a0, a1,
                                     use_reentrant=False))
        else:
            blocks.append(_ladder_rows(ld, tau, a0, a1))
    out = torch.cat(blocks, dim=2)
    del blocks
    x = einsum("kcld,ijcd->klij", ints.ovov, tau)
    return None, out - einsum("klij,ka,lb->ijab", x, t1, t1)


PIECES = (piece_t1, piece_t2_light, piece_ring_voov, piece_ring_vovo,
          piece_oooo, piece_ladder)


def residual(t1, t2, ints):
    """(R1, R2) at (t1, t2)."""
    eia, d2 = denominators(ints)
    r1 = ints.fov - t1 * eia
    r2 = ints.ovov.permute(0, 2, 1, 3) - t2 * d2
    for piece in PIECES:
        p1, p2 = piece(t1, t2, ints)
        if p1 is not None:
            r1 = r1 + p1
        if p2 is not None:
            r2 = r2 + p2
        del p1, p2
    return r1, r2


def step_norm(r1, r2, ints):
    """|R1/D1| + |R2/D2|: the length of one Jacobi step, the measure the
    solvers print as |dt| (or |dl| for Lambda)."""
    eia, d2 = denominators(ints)
    return float(torch.linalg.norm(r1 / eia) + torch.linalg.norm(r2 / d2))


def solve(ints, conv_tol=1e-8, max_cycle=80, space=8):
    """CCSD by Jacobi steps with DIIS, from the MP2 guess, to a step
    shorter than conv_tol.  Returns (e_corr, t1, t2, cycles)."""
    eia, d2 = denominators(ints)
    t1, t2 = mp2_guess(ints)
    xs, es = [], []
    for cycle in range(1, max_cycle + 1):
        r1, r2 = residual(t1, t2, ints)
        s1, s2 = r1 / eia, r2 / d2
        del r1, r2
        step = float(torch.linalg.norm(s1) + torch.linalg.norm(s2))
        x = torch.cat([(t1 + s1).reshape(-1), (t2 + s2).reshape(-1)])
        xs.append(x)
        es.append(torch.cat([s1.reshape(-1), s2.reshape(-1)]))
        del s1, s2, xs[:-space], es[:-space]
        n = len(xs)
        b = torch.zeros((n + 1, n + 1), dtype=F64)
        for i in range(n):
            for j in range(i + 1):
                b[i, j] = b[j, i] = float(torch.dot(es[i], es[j]))
        b[n, :n] = b[:n, n] = -1.0
        rhs = torch.zeros(n + 1, dtype=F64)
        rhs[n] = -1.0
        c = torch.linalg.lstsq(b, rhs[:, None]).solution[:n, 0]
        x = sum(float(c[i]) * xs[i] for i in range(n))
        n1 = t1.numel()
        t1 = x[:n1].view(t1.shape)
        t2 = x[n1:].view(t2.shape)
        if step < conv_tol:
            break
    else:
        raise RuntimeError(f"the reference CCSD did not converge in "
                           f"{max_cycle} cycles (last step {step:.3e})")
    return float(energy(t1, t2, ints)), t1, t2, cycle


def lambda_residual(t1, t2, l1, l2, ints):
    """(res1, res2): the gradient of E(t) + <l1, R1(t)> + <l2, R2(t)>
    with respect to (t1, t2), zero at the Lambda solution; res2 is
    symmetrized over (ij)(ab).  One backward pass per piece."""
    eia, d2 = denominators(ints)
    a1 = t1.detach().to(F64).requires_grad_()
    a2 = t2.detach().to(F64).requires_grad_()
    l1 = l1.to(F64)
    l2 = l2.to(F64)
    with torch.enable_grad():
        g1, g2 = torch.autograd.grad(energy(a1, a2, ints), (a1, a2))
    g1 = g1 - l1 * eia
    g2 = g2 - l2 * d2
    for piece in PIECES:
        with torch.enable_grad():
            p1, p2 = piece(a1, a2, ints)
            lag = 0.0
            if p1 is not None:
                lag = lag + torch.sum(l1 * p1)
            if p2 is not None:
                lag = lag + torch.sum(l2 * p2)
            del p1, p2
            d1, dd2 = torch.autograd.grad(lag, (a1, a2), allow_unused=True)
        if d1 is not None:
            g1 = g1 + d1
        if dd2 is not None:
            g2 = g2 + dd2
        del d1, dd2, lag
    return g1, 0.5 * _sym(g2)
