"""Moment-conserving GF-CCSD (Backhouse & Booth, arXiv:2206.13198).

Port of ``pyscf_mpcc_tpu/cc/momgfccsd.py``: compress the IP/EA-EOM-CCSD
Green's function into a small set of poles that exactly conserve the
first 2*niter+2 spectral moments

    T_hole[n][q,p] = <Psi| (1+Lambda) e^-T aq+ e^T  (-Hbar)^n  ap |Psi>
    T_part[n][q,p] = <Psi| (1+Lambda) e^-T aq  e^T  ( Hbar)^n  ap+ |Psi>

The moments are assembled as T[n] = K_n E^T with K_{n+1} = -+ A K_n,
where A is the embedded EE-Jacobian sigma of the Davidson IP/EA solvers
(cc/eom.ip_sigma, ea_sigma), batched over the nmo ket vectors with
``torch.func.vmap`` in chunks of ``chunk_size`` kets (each ket carries a
t2-sized tangent through the sigma).  The kets, bras and the pole solve
run on the host (nmo-sized matrices), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.cc import eom as eom_mod
from pyscf_mpcc_tpu_torch.convert import to_numpy

# kets batched through one vmapped sigma
CHUNK_SIZE = 16


def _np(x):
    return to_numpy(x) if torch.is_tensor(x) else np.asarray(x)


# ----------------------------------------- moment-conserving pole solver
#
# The reference (momgfccsd.py:227-447) runs a block-Lanczos recurrence on
# the moments to build a block-tridiagonal effective Hamiltonian.  Here the
# SAME conserved-moment compression is obtained without any recurrence:
# the block Krylov space {q, Aq, ..., A^niter q} has Gram and projected-
# Hamiltonian matrices that are block-HANKEL in the moments,
#
#     S[i, j] = T[i + j],      H[i, j] = T[i + j + 1],
#
# so one global whitening X = S^(-1/2) and one dense eigensolve of
# X H X (dimension (niter+1)*nmo — small, these are host matrices) give
# identical poles: both constructions diagonalize the projection of A onto
# the same subspace, and the first 2*niter+2 moments are conserved because
# q and A^k q for k <= niter live in it exactly.  The physical couplings
# are the first block column of S^(1/2) rotated by the eigenvectors.
# Rank deficiency of S (Hankel matrices are ill-conditioned) is handled by
# eigenvalue truncation in the pseudo-inverse square root — the analog of
# the reference's per-step isqrt tolerance, applied once.


def _hankel(moments, shift):
    """Block Hankel matrix  B[i, j] = moments[i + j + shift]  over all
    (i, j) with i + j + shift < len(moments) and square block count."""
    nblk = (len(moments) + 1 - shift) // 2
    return np.block([[moments[i + j + shift] for j in range(nblk)]
                     for i in range(nblk)])


def solve_moment_poles(moments, hermi=True, rcond=1e-12):
    """Poles and physical couplings of the moment-conserving GF.

    Returns (e, (v0, v1)) with

        moments[n][q, p]  ==  sum_k v0[q, k] * e_k**n * conj(v1[p, k])

    for every supplied n.  Role of the reference's block_lanczos_symm /
    _nosymm + build_block_tridiagonal + eigensolve chain.

    Implementation: the Eigensystem Realization Algorithm on the block
    Hankel pair — the balanced-truncation form of the Krylov projection
    above, numerically robust where the raw Gram matrix is singular:

        S = U sigma V+  (SVD, truncated at rcond)
        A = sigma^-1/2 U+ H V sigma^-1/2     (r x r realization of Hbar)
        couplings:  C = (U sigma^1/2)[:nmo],  B = (sigma^1/2 V+)[:, :nmo]
        moments[n] == C A^n B  ==>  eig(A) gives poles, C/B the residues.

    The moments are pre-scaled by s^-n (s = spectral-radius estimate from
    the highest even moment) so the Hankel blocks stay O(T[0]) — without
    this the SVD of S is dominated by the largest Hbar eigenvalue to the
    2*niter'th power.  hermi symmetrizes the realization where exact
    Hermiticity is assumed."""
    moments = np.asarray(moments)
    nmo = moments.shape[-1]
    # spectral-radius scaling: ||T[2k]|| ~ s^(2k) ||T[0]||
    k = (len(moments) - 1) // 2 * 2
    n0 = np.linalg.norm(moments[0])
    s = (np.linalg.norm(moments[k]) / max(n0, 1e-300)) ** (1.0 / max(k, 1))
    s = max(s, 1e-3)
    scaled = np.stack([m / s ** n for n, m in enumerate(moments)])
    S = _hankel(scaled, 0)
    H = _hankel(scaled, 1)
    if hermi:
        S = 0.5 * (S + S.T.conj())
        H = 0.5 * (H + H.T.conj())
    U, sig, Vh = np.linalg.svd(S)
    keep = sig > rcond * max(sig[0], 1e-300)
    U, sig, Vh = U[:, keep], sig[keep], Vh[keep]
    isq = sig ** -0.5
    A = (isq[:, None] * (U.T.conj() @ H @ Vh.T.conj())) * isq[None, :]
    C = (U * np.sqrt(sig)[None])[:nmo]
    B = (np.sqrt(sig)[:, None] * Vh)[:, :nmo]
    if hermi:
        A = 0.5 * (A + A.T.conj())
        e, u = np.linalg.eigh(A)
        uinv = u.T.conj()
    else:
        e, u = np.linalg.eig(A)
        uinv = np.linalg.inv(u)
        C = C.astype(complex)
        B = B.astype(complex)
    e = e * s
    v0 = C @ u
    v1 = (uinv @ B).T.conj()
    order = np.argsort(e.real)
    return e[order], (v0[:, order], v1[:, order])


def _lambda_to_standard(l1, l2):
    """Convert lambda_ad multipliers to the standard (pyscf) Lambda
    normalization used by the bra formulas.

    The Lagrangian multipliers contract the *spin-adapted* residual, so
    they absorb the closed-shell metric: lam1 = 2 l1_std and
    lam2 = 2 l2_std - l2_std^T(ab).  Inverting:
    l1_std = lam1 / 2, l2_std = (2 lam2 + lam2^T(ab)) / 3."""
    l1 = _np(l1)
    l2 = _np(l2)
    return 0.5 * l1, (2.0 * l2 + l2.transpose(0, 1, 3, 2)) / 3.0


# ------------------------------------------------ bra/ket state vectors
def _hole_kets(t1, t2):
    """Rows q: coefficients of aq|Psi> in the (1h, 2h1p) basis
    (reference build_ket_hole :470)."""
    t1 = _np(t1); t2 = _np(t2)
    nocc, nvir = t1.shape
    nmo = nocc + nvir
    n2 = nocc * nocc * nvir
    K = np.zeros((nmo, nocc + n2))
    K[:nocc, :nocc] = np.eye(nocc)
    K[nocc:, :nocc] = t1.T
    K[nocc:, nocc:] = t2.transpose(2, 0, 1, 3).reshape(nvir, n2)
    return K


def _hole_bras(t1, t2, l1, l2):
    """Rows p: left-hand vectors <Psi|(1+Lambda) e^-T aq+ e^T
    (reference build_bra_hole :486)."""
    t1 = _np(t1); t2 = _np(t2)
    l1 = _np(l1); l2 = _np(l2)
    nocc, nvir = t1.shape
    nmo = nocc + nvir
    E = np.zeros((nmo, nocc + nocc * nocc * nvir))
    for p in range(nocc):
        e1 = np.zeros(nocc)
        e1[p] = 1.0
        e1 -= l1 @ t1[p]
        tmp = 2.0 * t2[p] - t2[p].swapaxes(1, 2)
        e1 -= np.einsum("imef,mef->i", l2, tmp)
        tmp = -np.einsum("ijea,e->ija", l2, t1[p])
        e2 = 2.0 * tmp - tmp.swapaxes(0, 1)
        tmp = np.einsum("ja,i->ija", l1, np.eye(nocc)[p])
        e2 += 2.0 * tmp - tmp.swapaxes(0, 1)
        E[p] = np.concatenate([e1, e2.ravel()])
    for a in range(nvir):
        e1 = l1[:, a].copy()
        e2 = 2.0 * l2[:, :, a] - l2[:, :, :, a]
        E[nocc + a] = np.concatenate([e1, e2.ravel()])
    return E


def _part_kets(t1, t2):
    """Rows q: coefficients of aq+|Psi> in the (1p, 2p1h) basis
    (reference build_ket_part :531)."""
    t1 = _np(t1); t2 = _np(t2)
    nocc, nvir = t1.shape
    nmo = nocc + nvir
    n2 = nocc * nvir * nvir
    K = np.zeros((nmo, nvir + n2))
    K[:nocc, :nvir] = t1
    # ket for occupied p carries t2[p] = (j, a, b) as its 2p1h block
    K[:nocc, nvir:] = t2.reshape(nocc, -1)
    K[nocc:, :nvir] = -np.eye(nvir)
    return K


def _part_bras(t1, t2, l1, l2):
    """Rows p (reference build_bra_part :547)."""
    t1 = _np(t1); t2 = _np(t2)
    l1 = _np(l1); l2 = _np(l2)
    nocc, nvir = t1.shape
    nmo = nocc + nvir
    E = np.zeros((nmo, nvir + nocc * nvir * nvir))
    for p in range(nocc):
        e1 = -l1[p]
        e2 = -2.0 * l2[p] + l2[:, p]
        E[p] = np.concatenate([e1, e2.ravel()])
    for a in range(nvir):
        e1 = np.zeros(nvir)
        e1[a] = 1.0
        e1 -= t1[:, a] @ l1
        tmp = 2.0 * t2[:, :, :, a] - t2[:, :, a]
        e1 -= np.einsum("kmeb,kme->b", l2, tmp)
        tmp = -np.einsum("ikba,k->iab", l2, t1[:, a])
        e2 = 2.0 * tmp - tmp.swapaxes(1, 2)
        tmp = np.einsum("ib,a->iab", l1, np.eye(nvir)[a])
        e2 += 2.0 * tmp - tmp.swapaxes(1, 2)
        E[nocc + a] = np.concatenate([e1, e2.ravel()])
    return E


# --------------------------------------------------- batched EOM matvecs
def _matvec_batch(sigma, t1p, t2p, erp, ntile, chunk_size):
    """K (nket, n) -> the sigma of each row, vmapped in chunks."""
    def one(x):
        return sigma(t1p, t2p, erp, x, ntile)

    return torch.func.vmap(one, chunk_size=chunk_size)


def _ip_matvec_batch(t1, t2, eris, ntile=None, chunk_size=CHUNK_SIZE):
    t1p, t2p, erp = eom_mod._augment_virtual(t1, t2, eris)
    return _matvec_batch(eom_mod.ip_sigma, t1p, t2p, erp,
                         eom_mod.plan_ntile(eris, ntile, 1), chunk_size)


def _ea_matvec_batch(t1, t2, eris, ntile=None, chunk_size=CHUNK_SIZE):
    t1p, t2p, erp = eom_mod._augment_occupied(t1, t2, eris)
    return _matvec_batch(eom_mod.ea_sigma, t1p, t2p, erp,
                         eom_mod.plan_ntile(eris, ntile), chunk_size)


def _moments(kets, bras, mv, nmom, sign):
    """[sign * K_n E^T for n < nmom], K_{n+1} = -sign * mv(K_n), on the
    device of the integrals; numpy on return."""
    out = []
    K, E = kets, bras
    for n in range(nmom):
        out.append(sign * to_numpy(K @ E.T))
        if n + 1 != nmom:
            K = -sign * mv(K)
    return np.stack(out)


def build_hole_moments(t1, t2, l1, l2, eris, niter, chunk_size=CHUNK_SIZE):
    """T_hole[n] = K_n E^T with K_{n+1} = -A K_n (A the IP sigma); the
    reference's per-orbital left-matvec Krylov loop (momgfccsd.py:687)
    batched over all nmo kets."""
    l1, l2 = _lambda_to_standard(l1, l2)
    like = t2
    K = torch.as_tensor(_hole_kets(t1, t2), dtype=like.dtype,
                        device=like.device)
    E = torch.as_tensor(_hole_bras(t1, t2, l1, l2), dtype=like.dtype,
                        device=like.device)
    mv = _ip_matvec_batch(t1, t2, eris, chunk_size=chunk_size)
    return _moments(K, E, mv, 2 * niter + 2, 1.0)


def build_part_moments(t1, t2, l1, l2, eris, niter, chunk_size=CHUNK_SIZE):
    """T_part[n] = -K_n E^T with K_{n+1} = A K_n (A the EA sigma)."""
    l1, l2 = _lambda_to_standard(l1, l2)
    like = t2
    K = torch.as_tensor(_part_kets(t1, t2), dtype=like.dtype,
                        device=like.device)
    E = torch.as_tensor(_part_bras(t1, t2, l1, l2), dtype=like.dtype,
                        device=like.device)
    mv = _ea_matvec_batch(t1, t2, eris, chunk_size=chunk_size)
    return _moments(K, E, mv, 2 * niter + 2, -1.0)


# ----------------------------------------------------------------- driver
class MomGFCCSD:
    """GF-CCSD via moment constraints (reference MomGFCCSD :577).

    niter: (hole, particle) iteration counts; 2n+2 moments of each GF
    sector are conserved.  hermi_moments symmetrizes the moments;
    hermi_solver selects the Hermitian realization."""

    hermi_moments = False
    hermi_solver = False

    def __init__(self, mycc, niter=(2, 2)):
        self._cc = mycc
        self.niter = niter if np.ndim(niter) else (niter, niter)
        self.eh = self.vh = self.ep = self.vp = None

    @property
    def nmo(self):
        return self._cc.t1.shape[0] + self._cc.t1.shape[1]

    def kernel(self, hole_moments=None, part_moments=None, eris=None):
        cc = self._cc
        if cc.l1 is None:
            cc.solve_lambda()
        eris = eris or cc.eris
        if hole_moments is None:
            hole_moments = build_hole_moments(cc.t1, cc.t2, cc.l1, cc.l2,
                                              eris, self.niter[0])
        if part_moments is None:
            part_moments = build_part_moments(cc.t1, cc.t2, cc.l1, cc.l2,
                                              eris, self.niter[1])
        if self.hermi_moments:
            hole_moments = 0.5 * (hole_moments
                                  + hole_moments.swapaxes(1, 2).conj())
            part_moments = 0.5 * (part_moments
                                  + part_moments.swapaxes(1, 2).conj())
        hermi = self.hermi_solver
        self.eh, self.vh = solve_moment_poles(hole_moments, hermi=hermi)
        self.ep, self.vp = solve_moment_poles(part_moments, hermi=hermi)
        return self.eh, self.vh, self.ep, self.vp

    def moment_errors(self, moments, e, v):
        """Max relative deviation of pole-reconstructed moments."""
        errs = []
        for n in range(len(moments)):
            a = np.einsum("xk,yk,k->xy", v[0], v[1].conj(), e ** n)
            a = a / np.max(np.abs(a))
            b = moments[n] / np.max(np.abs(moments[n]))
            errs.append(np.max(np.abs(a - b)))
        return errs

    def make_rdm1(self, ao_repr=False, eris=None):
        """CCSD 1-RDM from the zeroth hole moment
        (reference make_rdm1 :767)."""
        cc = self._cc
        if cc.l1 is None:
            cc.solve_lambda()
        l1, l2 = _lambda_to_standard(cc.l1, cc.l2)
        m0 = (_hole_kets(cc.t1, cc.t2)
              @ _hole_bras(cc.t1, cc.t2, l1, l2).T)
        dm1 = m0 + m0.T.conj()
        if ao_repr:
            mo = np.asarray(cc.mo_coeff)[:, cc.frozen:]
            dm1 = mo @ dm1 @ mo.T.conj()
        return dm1

    def ipgfccsd(self, nroots=5, weight_tol=1e-3):
        """Lowest ionization poles (positive) + quasiparticle weights."""
        if self.eh is None:
            self.kernel()
        w = np.einsum("xk,xk->k", self.vh[0], self.vh[1].conj()).real
        mask = w > weight_tol
        e = -self.eh[mask].real
        w = w[mask]
        order = np.argsort(e)
        return e[order][:nroots], w[order][:nroots]

    def eagfccsd(self, nroots=5, weight_tol=1e-3):
        if self.ep is None:
            self.kernel()
        w = np.einsum("xk,xk->k", self.vp[0], self.vp[1].conj()).real
        mask = w > weight_tol
        return np.sort(self.ep[mask].real)[:nroots], w[mask]

    def dump_chk(self, path, key="gfccsd"):
        """Persist poles/weights (reference momgfccsd.dump_chk :797)."""
        from pyscf_mpcc_tpu_torch.lib import chkfile
        chkfile.save(path, key, {
            "eh": np.asarray(self.eh), "ep": np.asarray(self.ep),
            "vh0": np.asarray(self.vh[0]), "vh1": np.asarray(self.vh[1]),
            "vp0": np.asarray(self.vp[0]), "vp1": np.asarray(self.vp[1]),
            "niter": np.asarray(self.niter)})

    def update_from_chk_(self, path, key="gfccsd"):
        """Reload a previously computed pole set
        (reference momgfccsd.update_from_chk_ :811)."""
        from pyscf_mpcc_tpu_torch.lib import chkfile
        d = chkfile.load(path, key)
        self.eh, self.ep = d["eh"], d["ep"]
        self.vh = (d["vh0"], d["vh1"])
        self.vp = (d["vp0"], d["vp1"])
        return self
