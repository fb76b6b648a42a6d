"""Block Davidson with its subspace on the device.

The algorithm of ``lib/linalg.davidson`` (the host copy of the JAX
package's, which stays the reference), with the subspace V and its images
AV held as two (rows, n) tensors where the matvec's vectors live.  Per
cycle the host copy rebuilds the whole m x m subspace matrix (m^2 dots)
and every Ritz vector (m^2 axpys) over host vectors; here the subspace
matrix grows by the new rows and columns only (two GEMMs), the overlaps
that root following needs are one GEMM against the tracked vectors, and
each Ritz vector is one GEMV.  Only the m x m matrix and the m x nroots
overlaps go to the host, for the eigensolve and the root assignment.
Vectors are orthonormalized by classical Gram-Schmidt applied twice.
"""

from __future__ import annotations

import numpy as np
import torch


class _Space:
    """V and AV as the first m rows of two growable (rows, n) tensors."""

    def __init__(self, n, rows, dtype, device):
        self.V = torch.empty((rows, n), dtype=dtype, device=device)
        self.AV = torch.empty_like(self.V)
        self.m = 0

    def push(self, v, av):
        if self.m == self.V.shape[0]:
            grow = max(self.m, 1)
            self.V = torch.cat([self.V, torch.empty_like(self.V[:grow])])
            self.AV = torch.cat([self.AV, torch.empty_like(self.AV[:grow])])
        self.V[self.m] = v
        self.AV[self.m] = av
        self.m += 1


def _orthonormalize(v, basis):
    """v less its projection on the orthonormal rows of ``basis``, twice,
    normalized; and the norm before normalization (a float)."""
    if basis.shape[0]:
        for _ in range(2):
            v = v - basis.T @ (basis @ v)
    nrm = torch.linalg.norm(v)
    return v / nrm, float(nrm)


def davidson(matvec, x0, diag, nroots=1, max_cycle=80, max_space=None,
             tol=1e-8, hermitian=False, verbose=0, pick="lowest"):
    """Lowest-``nroots`` eigenpairs of the operator defined by ``matvec``,
    as lib/linalg.davidson.

    matvec: callable taking and returning 1-D tensors of diag's dtype on
    diag's device.  x0: list of starting vectors (arrays or tensors).
    diag: the operator diagonal (preconditioner), a 1-D tensor; the
    subspace lives on its device in its dtype.  pick: 'lowest' or
    'follow' (root tracking by overlap with the previous cycle's Ritz
    vectors).  Returns (converged list, eigenvalues, eigenvectors as 1-D
    tensors)."""
    dev, dt = diag.device, diag.dtype
    n = diag.numel()
    if max_space is None:
        max_space = min(max(2 * nroots + 6, 12) * 4, n)
    sp = _Space(n, max(max_space, len(x0)) + nroots, dt, dev)
    H = np.empty((0, 0))
    prev = None            # (nr, n) tracked Ritz vectors, normalized

    def add(v):
        sp.push(v, matvec(v).reshape(-1).to(dt))

    for x in x0:
        v, nrm = _orthonormalize(
            torch.as_tensor(x, dtype=dt, device=dev).reshape(-1),
            sp.V[:sp.m])
        if nrm > 1e-7:
            add(v)

    conv = [False] * nroots
    e = np.zeros(nroots)
    vecs = [None] * nroots
    for it in range(max_cycle):
        m, k = sp.m, H.shape[0]
        V, AV = sp.V[:m], sp.AV[:m]
        if k < m:
            # the new columns H[:, k:] and rows H[k:, :k]
            Hn = np.empty((m, m))
            Hn[:k, :k] = H
            Hn[:, k:] = (V @ AV[k:].T).cpu().numpy()
            Hn[k:, :k] = (V[k:] @ AV[:k].T).cpu().numpy()
            H = Hn
        if hermitian:
            w, s = np.linalg.eigh(H)
        else:
            w, s = np.linalg.eig(H)
            order = np.argsort(w.real)
            w = w[order].real
            s = s[:, order].real
        nr = min(nroots, m)
        if pick == "follow" and prev is not None:
            # overlap of every Ritz vector with the tracked roots; greedily
            # assign each tracked root its best-matching new Ritz pair
            ovlp = np.abs(s.T @ (V @ prev.T).cpu().numpy())  # (m, nr_prev)
            chosen = []
            for r in range(min(nr, ovlp.shape[1])):
                cand = np.argsort(-ovlp[:, r])
                c = next(c for c in cand if c not in chosen)
                chosen.append(int(c))
            chosen += [c for c in range(m) if c not in chosen]
            idx = np.asarray(chosen[:m])
            w = w[idx]
            s = s[:, idx]
        all_conv = True
        new_dirs = []
        for r in range(nr):
            e[r] = w[r]
            sr = torch.as_tensor(s[:, r], dtype=dt, device=dev)
            x = sr @ V
            resid = sr @ AV - w[r] * x
            rn = float(torch.linalg.norm(resid))
            vecs[r] = x
            conv[r] = rn < tol
            if not conv[r]:
                all_conv = False
                denom = diag - w[r]
                denom = torch.where(denom.abs() < 1e-8,
                                    torch.sign(denom + 1e-30) * 1e-8, denom)
                new_dirs.append(-resid / denom)
        if verbose:
            print(f"davidson cycle {it}: space {m}  "
                  f"e = {e[:nr]}  conv = {conv[:nr]}")
        prev = torch.stack([vecs[r] / torch.linalg.norm(vecs[r])
                            for r in range(nr)])
        if all_conv and m >= nroots:
            break
        if m + len(new_dirs) > max_space:
            # restart with the current Ritz vectors
            basis = torch.empty((0, n), dtype=dt, device=dev)
            for r in range(nr):
                v, nrm = _orthonormalize(vecs[r].clone(), basis)
                if nrm > 1e-7:
                    basis = torch.cat([basis, v[None]])
            sp.m, H = 0, np.empty((0, 0))
            for v in basis:
                add(v)
            del basis
        added = 0
        for d in new_dirs:
            dn = float(torch.linalg.norm(d))
            if dn == 0.0:
                continue
            v, nrm = _orthonormalize(d / dn, sp.V[:sp.m])
            # accept any direction with a numerically meaningful new
            # component (1e-4 stalled near convergence: the preconditioned
            # residual shrinks with the residual itself)
            if nrm > 1e-11:
                add(v)
                added += 1
        if added == 0:
            # stagnation: no enrichment possible at working precision
            break
    return conv, e[:nroots], vecs[:nroots]
