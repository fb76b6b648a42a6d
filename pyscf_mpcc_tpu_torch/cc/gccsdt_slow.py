"""Factorized spin-orbital CCSDT / CCSDT-3 (NumPy, oracle-locked).

Role of the fork's iterative active-space T3 machinery
(pyscf/cc/umpcc_t_slow.py:448 make_intermediates, :699 get_vvvv_to_imds,
:1831 iterative_update_amps_t3, :2696 the CCSDT-3-like variant),
re-designed around two ideas:

*   T1 is eliminated EXACTLY by similarity-transforming the Hamiltonian:
    e^{-T1} a+_i e^{T1} = a+_i - t1_ib a+_b and
    e^{-T1} a_a  e^{T1} = a_a  + t1_ja a_j, so the dressed (h~, <pq||rs>~)
    are two matrix transforms of the bare integrals (``dress``).  Every
    equation below is the t1-free CCSDT equation over dressed integrals —
    no hand-propagated t1 terms anywhere.  The dressed integrals are NOT
    hermitian, so block orientation matters (e.g. <bc||ei> != <ie||cb>).

*   Every term group is locked against the exact determinant-space
    projection <mu| e^{-T} H e^{T} |0> (cc/gccsdt_oracle.py): the
    coefficients below reproduce it to machine precision, and the full
    'ccsdt' model converges to FCI for three-electron systems.

models: 'ccsdt'   — complete T3 equation
        'ccsdt-3' — drops the T2.T3 couplings from the T3 equation (the
                    class of the fork's iterative model: T1/T2-dressed
                    driving and [H,T3] without T2.T3 cross terms)
        'ccsdt-1' — linear driving + Fock closures only

The T3 amplitudes may be restricted to an active block (boolean mask,
the fork's pert_triples freeze applied to the triples sector).

A host copy of the JAX package's cc/gccsdt_slow.py (NumPy, its imports pointed at
the port).
"""

from __future__ import annotations

from itertools import permutations

import numpy as np

from pyscf_mpcc_tpu_torch.lib.diis import DIIS
from pyscf_mpcc_tpu_torch.lib import logger as lg
from pyscf_mpcc_tpu_torch.cc import gccsd_slow
from pyscf_mpcc_tpu_torch.cc.gccsdt1_slow import t3_mask  # noqa: F401 (re-export)

MODELS = ("ccsdt", "ccsdt-3", "ccsdt-1")


def dress(h_so, g_so, t1, nocc):
    """Exact t1 similarity transform of (h, <pq||rs>).  Returns (h~, g~, f~)
    with f~ the dressed Fock; g~ keeps the physicists' antisymmetry but is
    not hermitian."""
    nso = h_so.shape[0]
    Uc = np.eye(nso)
    Uc[nocc:, :nocc] -= t1.T          # creation transform
    Ua = np.eye(nso)
    Ua[:nocc, nocc:] += t1            # annihilation transform
    h = Uc @ h_so @ Ua.T
    g = np.einsum("pqrs,mp->mqrs", g_so, Uc, optimize=True)
    g = np.einsum("mqrs,nq->mnrs", g, Uc, optimize=True)
    g = np.einsum("mnrs,or->mnos", g, Ua, optimize=True)
    g = np.einsum("mnos,ps->mnop", g, Ua, optimize=True)
    f = h + np.einsum("pjqj->pq", g[:, :nocc, :, :nocc], optimize=True)
    return h, g, f


class DressedERIs:
    """gccsd_slow.SpinOrbERIs-compatible view over dressed integrals."""

    def __init__(self, g, f, nocc):
        self.ints = g
        self.fock = f
        self.nocc = nocc
        self.nso = f.shape[0]
        self.mo_energy = np.diag(f).copy()

    block = gccsd_slow.SpinOrbERIs.block


def _parity(perm):
    p = 1
    perm = list(perm)
    for x in range(len(perm)):
        for y in range(x + 1, len(perm)):
            if perm[x] > perm[y]:
                p = -p
    return p


def _a36(x):
    """Full antisymmetrizer over (ijk) x (abc)."""
    out = np.zeros_like(x)
    for ph in permutations(range(3)):
        for pp in permutations(range(3)):
            s = _parity(ph) * _parity(pp)
            out += s * x.transpose(*(list(ph) + [3 + q for q in pp]))
    return out


def t3_residual(t2, t3, er, model="ccsdt", driving="full"):
    """The t1-free T3 residual over (possibly dressed) integrals.

    Every coefficient below is locked to the exact determinant-space
    projection; see tests/test_gccsdt.py.  driving='linear' drops the
    quadratic-t2 driving terms (the bare (T)-generator limit, used by
    the one-shot environment-triples validation)."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; one of {MODELS}")
    o = slice(0, er.nocc)
    v = slice(er.nocc, er.nso)
    f = er.fock
    fov, foo, fvv = f[o, v], f[o, o], f[v, v]
    vvvo = er.block("vvvo")
    ovoo = er.block("ovoo")
    ooov = er.block("ooov")
    ovvv = er.block("ovvv")

    def p_hole(x):
        return (x - x.transpose(1, 0, 2, 3, 4, 5)
                - x.transpose(2, 1, 0, 3, 4, 5))

    def p_part(x):
        return (x - x.transpose(0, 1, 2, 4, 3, 5)
                - x.transpose(0, 1, 2, 5, 4, 3))

    # ---- t2 driving: linear + quadratic (exact for any t2) --------------
    x = np.einsum("jkae,bcei->ijkabc", t2, vvvo, optimize=True)
    x -= np.einsum("imbc,majk->ijkabc", t2, ovoo, optimize=True)
    r3 = p_hole(p_part(x))

    if driving == "full":
        q = -0.125 * np.einsum("mnab,mnie,jkce->ijkabc", t2, ooov, t2,
                               optimize=True)
        q += -0.5 * np.einsum("jmae,mnie,nkbc->ijkabc", t2, ooov, t2,
                              optimize=True)
        q += 0.125 * np.einsum("jkef,maef,mibc->ijkabc", t2, ovvv, t2,
                               optimize=True)
        q += 0.5 * np.einsum("imbe,maef,jkcf->ijkabc", t2, ovvv, t2,
                             optimize=True)
        q += 0.25 * np.einsum("imbc,me,jkae->ijkabc", t2, fov, t2,
                              optimize=True)
        r3 += _a36(q)

    if t3 is None:
        return r3

    # ---- [H, T3] couplings ----------------------------------------------
    y = (1.0 / 12.0) * np.einsum("ijkabe,ce->ijkabc", t3, fvv,
                                 optimize=True)
    y -= (1.0 / 12.0) * np.einsum("mjkabc,mi->ijkabc", t3, foo,
                                  optimize=True)
    if model in ("ccsdt", "ccsdt-3"):
        y += (1.0 / 24.0) * np.einsum("mnkabc,mnij->ijkabc", t3,
                                      er.block("oooo"), optimize=True)
        y += (1.0 / 24.0) * np.einsum("ijkaef,bcef->ijkabc", t3,
                                      er.block("vvvv"), optimize=True)
        y += 0.25 * np.einsum("mjkebc,maei->ijkabc", t3,
                              er.block("ovvo"), optimize=True)
    if model == "ccsdt":
        oovv = er.block("oovv")
        y += (1.0 / 48.0) * np.einsum("mnab,mnef,ijkcef->ijkabc", t2, oovv,
                                      t3, optimize=True)
        y += (1.0 / 48.0) * np.einsum("ijef,mnef,mnkabc->ijkabc", t2, oovv,
                                      t3, optimize=True)
        y += 0.25 * np.einsum("jmae,mnef,nikbcf->ijkabc", t2, oovv, t3,
                              optimize=True)
    r3 += _a36(y)
    return r3


def feedback(t3, er):
    """T3 -> (R1, R2) additions over (possibly dressed) integrals.

    Exact: with the t1-dressed integrals these are the ONLY t3 terms in
    the T1/T2 residuals (no higher commutators survive line counting)."""
    o = slice(0, er.nocc)
    v = slice(er.nocc, er.nso)
    fov = er.fock[o, v]
    r1 = 0.25 * np.einsum("mnef,imnaef->ia", er.block("oovv"), t3,
                          optimize=True)
    y = np.einsum("me,ijmabe->ijab", fov, t3, optimize=True)
    y += np.einsum("bmef,ijmaef->ijab", er.block("vovv"), t3,
                   optimize=True)
    y += np.einsum("mnej,imnabe->ijab", er.block("oovo"), t3,
                   optimize=True)
    y = y - y.transpose(1, 0, 2, 3)
    y = y - y.transpose(0, 1, 3, 2)
    r2 = 0.25 * y
    return r1, r2


def ccsd_residuals_dressed(t2, er):
    """(R1, R2): the t1-free CCSD residuals over (non-hermitian) dressed
    integrals, orientation-locked against the determinant oracle."""
    o = slice(0, er.nocc)
    v = slice(er.nocc, er.nso)
    f = er.fock
    fvo, fov, foo, fvv = f[v, o], f[o, v], f[o, o], f[v, v]
    oovv = er.block("oovv")
    R1 = (fvo.T
          + np.einsum("me,imae->ia", fov, t2, optimize=True)
          + 0.5 * np.einsum("amef,imef->ia", er.block("vovv"), t2,
                            optimize=True)
          + 0.5 * np.einsum("mnei,mnae->ia", er.block("oovo"), t2,
                            optimize=True))
    y = (0.25 * er.block("vvoo").transpose(2, 3, 0, 1)
         + 0.5 * np.einsum("be,ijae->ijab", fvv, t2, optimize=True)
         - 0.5 * np.einsum("mj,imab->ijab", foo, t2, optimize=True)
         + 0.125 * np.einsum("mnij,mnab->ijab", er.block("oooo"), t2,
                             optimize=True)
         + 0.125 * np.einsum("abef,ijef->ijab", er.block("vvvv"), t2,
                             optimize=True)
         + np.einsum("mbej,imae->ijab", er.block("ovvo"), t2,
                     optimize=True)
         + 0.0625 * np.einsum("mnef,ijef,mnab->ijab", oovv, t2, t2,
                              optimize=True)
         + 0.5 * np.einsum("mnef,imae,jnbf->ijab", oovv, t2, t2,
                           optimize=True)
         - 0.25 * np.einsum("mnef,inef,mjab->ijab", oovv, t2, t2,
                            optimize=True)
         - 0.25 * np.einsum("mnef,mnaf,ijeb->ijab", oovv, t2, t2,
                            optimize=True))
    y = y - y.transpose(1, 0, 2, 3)
    R2 = y - y.transpose(0, 1, 3, 2)
    return R1, R2


def residuals(t1, t2, t3, eris, h_so, model="ccsdt"):
    """(R1, R2, R3): full CCSDT residuals in the raw frame.

    eris: bare SpinOrbERIs; h_so: bare one-electron ints.  The t1
    dependence enters only through the dressing."""
    nocc = eris.nocc
    hd, gd, fd = dress(h_so, eris.ints, t1, nocc)
    erd = DressedERIs(gd, fd, nocc)
    R1, R2 = ccsd_residuals_dressed(t2, erd)
    if t3 is not None:
        f1, f2 = feedback(t3, erd)
        R1 = R1 + f1
        R2 = R2 + f2
    R3 = t3_residual(t2, t3, erd, model=model)
    return R1, R2, R3


def kernel(eris, h_so, act_hole=None, act_particle=None, model="ccsdt",
           max_cycle=100, conv_tol=1e-9, conv_tol_normt=1e-7, diis_space=6,
           verbose=0, t1=None, t2=None, t3=None, t3_diis=True,
           freeze_mask1=None, freeze_mask2=None):
    """CCSD(T1,T2) + iterative (active-space) T3.

    act_hole/act_particle = None solves the full triples space (model
    'ccsdt' then converges to FCI for 3-electron systems); index arrays
    restrict t3 to the active block, the fork's pert_triples.  t3 carries
    its own DIIS history (reference cc/ccsd.py:79-87,1278 run_diis_t3)
    unless t3_diis=False.  freeze_mask1/freeze_mask2: boolean masks over
    (t1, t2) held at their INCOMING values every sweep (the MP-CC
    frozen-bath semantics, so pert_triples composes with the fragment
    freeze).  Returns (e_corr, t1, t2, t3, converged)."""
    log = lg.Logger(verbose=verbose)
    nocc = eris.nocc
    nvir = eris.nso - nocc
    eo = np.diag(eris.fock)[:nocc]
    ev = np.diag(eris.fock)[nocc:]
    d1 = eo[:, None] - ev[None, :]
    d2 = (eo[:, None, None, None] + eo[None, :, None, None]
          - ev[None, None, :, None] - ev[None, None, None, :])
    d3 = (d2[:, :, None, :, :, None]
          + (eo[:, None] - ev[None, :])[None, None, :, None, None, :])

    mask = None
    if act_hole is not None:
        mask = t3_mask(act_hole, act_particle, nocc, nvir)

    emp2, t1_0, t2_0 = gccsd_slow.init_amps(eris)
    if t1 is None:
        t1 = t1_0
    if t2 is None:
        t2 = t2_0
    if t3 is None:
        t3 = np.zeros((nocc, nocc, nocc, nvir, nvir, nvir))
    t1_in, t2_in = t1, t2
    diis = DIIS(space=diis_space)
    diis3 = DIIS(space=diis_space) if t3_diis else None
    e_last = gccsd_slow.energy(t1, t2, eris)
    converged = False
    for it in range(max_cycle):
        R1, R2, R3 = residuals(t1, t2, t3, eris, h_so, model=model)
        t1n = t1 + R1 / d1
        t2n = t2 + R2 / d2
        t3n = t3 + R3 / d3
        if freeze_mask1 is not None:
            t1n = np.where(freeze_mask1, t1_in, t1n)
        if freeze_mask2 is not None:
            t2n = np.where(freeze_mask2, t2_in, t2n)
        if mask is not None:
            t3n = np.where(mask, t3n, 0.0)
        normt = (np.linalg.norm(t1n - t1) + np.linalg.norm(t2n - t2)
                 + np.linalg.norm(t3n - t3))
        vec = np.concatenate([t1n.ravel(), t2n.ravel()])
        vec = diis.update(vec)
        t1 = vec[:nocc * nvir].reshape(nocc, nvir)
        t2 = vec[nocc * nvir:].reshape(t2.shape)
        t3 = diis3.update(t3n.ravel()).reshape(t3.shape) if diis3 else t3n
        e = gccsd_slow.energy(t1, t2, eris)
        log.info("cycle %2d  E_corr(CCSDT/%s) = %.14f  dE = %9.3e  "
                 "|dt| = %9.3e", it, model, e, e - e_last, normt)
        if abs(e - e_last) < conv_tol and normt < conv_tol_normt:
            converged = True
            break
        e_last = e
    return e, t1, t2, t3, converged


def env_triples_kernel(eris, h_so, t1, t2, act_hole, act_particle,
                       model="ccsdt-3", dress_t1=True, driving="full",
                       one_shot=False, env_amplitudes=False,
                       max_cycle=60, conv_tol=1e-8, verbose=0):
    """Iterative ENVIRONMENT triples at fixed (t1, t2).

    Role of the fork's uccsd_t_inactive_iterative.py (:634 iterative
    kernel, :733 inactive_energy, :1683-1702 t1-dressed intermediates):
    t3 is solved on the COMPLEMENT of the all-active block — the
    environment correction that the active-space MPCC misses — while the
    converged (t1, t2) stay fixed.  The t1 dressing is exact (``dress``);
    the reference's get_X/get_J/get_F t1-dressed DF intermediates play the
    same role approximately.

    Energy:  E_env = <T1', R1(t3)> + 1/4 <T2', R2(t3)>  — the adjoint
    pairing of the t3 feedback with the amplitudes (the reference's
    lhs_env_triples contraction).  env_amplitudes=True zeroes the active
    blocks of (t1, t2) in the pairing, the reference's inactive_energy
    convention; the default pairs the full amplitudes, which in the
    (one_shot, dress_t1=False, driving='linear') limit is EXACTLY the
    standard (T) energy restricted to environment triples — the
    cross-validation anchor against cc/gccsd_t_slow.

    Returns (e_env, t3, converged)."""
    nocc = eris.nocc
    nvir = eris.nso - nocc
    if dress_t1:
        hd, gd, fd = dress(h_so, eris.ints, t1, nocc)
        er = DressedERIs(gd, fd, nocc)
    else:
        er = eris
    eo = np.diag(eris.fock)[:nocc]
    ev = np.diag(eris.fock)[nocc:]
    d3 = ((eo[:, None, None] + eo[None, :, None]
           + eo[None, None, :])[:, :, :, None, None, None]
          - (ev[:, None, None] + ev[None, :, None]
             + ev[None, None, :])[None, None, None])
    env = ~t3_mask(act_hole, act_particle, nocc, nvir)
    t3 = np.zeros((nocc,) * 3 + (nvir,) * 3)
    converged = one_shot
    for it in range(1 if one_shot else max_cycle):
        R3 = t3_residual(t2, t3, er, model=model, driving=driving)
        t3n = np.where(env, t3 + R3 / d3, 0.0)
        dn = np.linalg.norm(t3n - t3)
        t3 = t3n
        if not one_shot and dn < conv_tol:
            converged = True
            break
    f1, f2 = feedback(t3, er)
    t1p, t2p = t1, t2
    if env_amplitudes:
        m1 = np.zeros((nocc, nvir), dtype=bool)
        m1[np.ix_(np.asarray(act_hole, int),
                  np.asarray(act_particle, int))] = True
        t1p = np.where(m1, 0.0, t1)
        m2 = (m1[:, None, :, None] & m1[None, :, None, :])
        t2p = np.where(m2, 0.0, t2)
    e_env = float(np.vdot(t1p, f1) + 0.25 * np.vdot(t2p, f2))
    return e_env, t3, converged
