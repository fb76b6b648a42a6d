"""Iterative linear algebra: Davidson diagonalization.

Role of the reference's lib/linalg_helper.py (davidson1 :291 /
davidson_nosym1 :742) for the EOM solvers: block Davidson for the lowest
eigenvalues of a (possibly non-symmetric) operator given as a matvec
closure, with diagonal preconditioning and optional root following.
Host-orchestrated; each matvec is a jitted device call.

A host copy of the JAX package's lib/linalg.py (NumPy, its imports pointed at
the port).
"""

from __future__ import annotations

import numpy as np


def davidson(matvec, x0, diag, nroots=1, max_cycle=80, max_space=None,
             tol=1e-8, hermitian=False, verbose=0, pick="lowest"):
    """Lowest-``nroots`` eigenpairs of the operator defined by ``matvec``.

    matvec: callable taking / returning 1-D numpy arrays.
    x0: list of starting vectors.  diag: operator diagonal (preconditioner).
    pick: 'lowest' selects the nroots lowest Ritz values each cycle;
    'follow' selects by maximum overlap with the previous cycle's Ritz
    vectors (the reference's _sort_by_similarity root tracking,
    lib/linalg_helper.py:1447 — prevents root flipping on near-degenerate
    EOM states).
    Returns (converged list, eigenvalues, eigenvectors).
    """
    n = diag.size
    if max_space is None:
        max_space = min(max(2 * nroots + 6, 12) * 4, n)
    V = []           # orthonormal subspace
    AV = []
    xs = [np.asarray(x, dtype=float).ravel() for x in x0]
    prev_vecs = None

    def orthonormalize(v, basis):
        for b in basis:
            v = v - b * np.dot(b, v)
        for b in basis:
            v = v - b * np.dot(b, v)
        nrm = np.linalg.norm(v)
        return (v / nrm, nrm)

    for v in xs:
        v, nrm = orthonormalize(v, V)
        if nrm > 1e-7:
            V.append(v)
            AV.append(np.asarray(matvec(v)).ravel())

    conv = [False] * nroots
    e = np.zeros(nroots)
    vecs = [None] * nroots
    for it in range(max_cycle):
        m = len(V)
        H = np.empty((m, m))
        for i in range(m):
            for j in range(m):
                H[i, j] = np.dot(V[i], AV[j])
        if hermitian:
            w, s = np.linalg.eigh(H)
        else:
            w, s = np.linalg.eig(H)
            order = np.argsort(w.real)
            w = w[order].real
            s = s[:, order].real
        nr = min(nroots, m)
        if pick == "follow" and prev_vecs is not None:
            # overlap of every Ritz vector with the tracked roots; greedily
            # assign each tracked root its best-matching new Ritz pair
            ritz = np.stack([sum(s[i, k] * V[i] for i in range(m))
                             for k in range(m)])
            ovlp = np.abs(ritz @ np.stack(prev_vecs).T)   # (m, nr_prev)
            chosen = []
            for r in range(min(nr, ovlp.shape[1])):
                cand = np.argsort(-ovlp[:, r])
                k = next(k for k in cand if k not in chosen)
                chosen.append(int(k))
            chosen += [k for k in range(m) if k not in chosen]
            idx = np.asarray(chosen[:m])
            w = w[idx]
            s = s[:, idx]
        all_conv = True
        new_dirs = []
        for r in range(nr):
            e[r] = w[r]
            x = sum(s[i, r] * V[i] for i in range(m))
            ax = sum(s[i, r] * AV[i] for i in range(m))
            resid = ax - w[r] * x
            rn = np.linalg.norm(resid)
            vecs[r] = x
            conv[r] = rn < tol
            if not conv[r]:
                all_conv = False
                denom = diag - w[r]
                denom = np.where(np.abs(denom) < 1e-8,
                                 np.sign(denom + 1e-30) * 1e-8, denom)
                new_dirs.append(-resid / denom)
        if verbose:
            print(f"davidson cycle {it}: space {m}  "
                  f"e = {e[:nr]}  conv = {conv[:nr]}")
        prev_vecs = [vecs[r] / np.linalg.norm(vecs[r]) for r in range(nr)
                     if vecs[r] is not None]
        if all_conv and m >= nroots:
            break
        if m + len(new_dirs) > max_space:
            # restart with current Ritz vectors
            basis = []
            for r in range(nr):
                v, nrm = orthonormalize(vecs[r].copy(), basis)
                if nrm > 1e-7:
                    basis.append(v)
            V = basis
            AV = [np.asarray(matvec(v)).ravel() for v in V]
        added = 0
        for d in new_dirs:
            dn = np.linalg.norm(d)
            if dn == 0.0:
                continue
            v, nrm = orthonormalize(d / dn, V)
            # accept any direction with a numerically meaningful new
            # component (1e-4 stalled near convergence: the preconditioned
            # residual shrinks with the residual itself)
            if nrm > 1e-11:
                V.append(v)
                AV.append(np.asarray(matvec(v)).ravel())
                added += 1
        if added == 0:
            # stagnation: no enrichment possible at working precision
            break
    return conv, e[:nroots], vecs[:nroots]
