"""SCF-DIIS variants: CDIIS (commutator, via lib.diis), EDIIS, ADIIS.

A host copy of ``pyscf_mpcc_tpu/scf/diis.py`` (the JAX package's ``scf``
package cannot be imported without jax); NumPy/SciPy, no framework.

Role of the reference scf/diis.py (CDIIS :40, EDIIS :125, ADIIS :185):
energy-based extrapolation for the early SCF region where commutator
DIIS can stagnate, switched to CDIIS near convergence.

EDIIS (Kudin, Scuseria, Cances, JCP 116, 8255 (2002)):
    minimize  E(c) = sum_i c_i E_i - 1/2 sum_ij c_i c_j B_ij,
    B_ij = Tr[(D_i - D_j)(F_i - F_j)],   c on the simplex.

ADIIS (Hu, Yang, JCP 132, 054109 (2010)):
    minimize  f(c) = 2 sum_i c_i Tr[(D_i - D_n)F_n]
                     + sum_ij c_i c_j Tr[(D_i - D_n)(F_j - F_n)].

Both solve the small simplex-constrained quadratic with SLSQP from a few
feasible starts (the problem is nonconvex only through the simplex
boundary; dims <= space).  Densities/Focks may be spin-stacked
((2, nao, nao)) — traces sum over the leading axes."""

import numpy as np
import scipy.optimize


def _tr(a, b):
    """Tr[a b] summed over any leading stack axes."""
    return float(np.einsum("...pq,...qp->...", a, b).sum())


class _EnergyDIISBase:
    def __init__(self, space=8):
        self.space = int(space)
        self.es = []
        self.dms = []
        self.focks = []

    def push(self, e, dm, fock):
        self.es.append(float(e))
        self.dms.append(np.array(dm, copy=True))
        self.focks.append(np.array(fock, copy=True))
        if len(self.es) > self.space:
            self.es.pop(0)
            self.dms.pop(0)
            self.focks.pop(0)

    def _minimize(self, fun, jac, n):
        cons = ({"type": "eq", "fun": lambda c: c.sum() - 1.0},)
        bounds = [(0.0, 1.0)] * n
        best = None
        starts = [np.ones(n) / n]
        e0 = np.zeros(n)
        e0[-1] = 1.0
        starts.append(e0)
        for x0 in starts:
            r = scipy.optimize.minimize(fun, x0, jac=jac, bounds=bounds,
                                        constraints=cons, method="SLSQP",
                                        options={"maxiter": 200,
                                                 "ftol": 1e-12})
            if best is None or r.fun < best.fun:
                best = r
        c = np.clip(best.x, 0.0, None)
        return c / c.sum()

    def extrapolate(self):
        n = len(self.es)
        if n == 1:
            return self.focks[0]
        c = self._coeffs(n)
        out = np.zeros_like(self.focks[0])
        for ci, f in zip(c, self.focks):
            out += ci * f
        return out


class EDIIS(_EnergyDIISBase):
    def _coeffs(self, n):
        es = np.asarray(self.es)
        B = np.zeros((n, n))
        for i in range(n):
            for j in range(i):
                B[i, j] = B[j, i] = _tr(self.dms[i] - self.dms[j],
                                        self.focks[i] - self.focks[j])

        def fun(c):
            return float(es @ c - 0.5 * c @ B @ c)

        def jac(c):
            return es - B @ c

        return self._minimize(fun, jac, n)


class ADIIS(_EnergyDIISBase):
    def _coeffs(self, n):
        Dn, Fn = self.dms[-1], self.focks[-1]
        g = np.array([2.0 * _tr(d - Dn, Fn) for d in self.dms])
        H = np.zeros((n, n))
        for i in range(n):
            for j in range(n):
                H[i, j] = _tr(self.dms[i] - Dn, self.focks[j] - Fn)
        Hs = H + H.T

        def fun(c):
            return float(g @ c + c @ H @ c)

        def jac(c):
            return g + Hs @ c

        return self._minimize(fun, jac, n)


def make_scheme(name, space=8):
    """'ediis' / 'adiis' (pure) or 'ediis+cdiis' / 'adiis+cdiis'
    (energy-DIIS while |FDS-SDF| > 1e-2, CDIIS after — the reference's
    production hybrid).  Returns (energy_diis_or_None, hybrid)."""
    name = (name or "cdiis").lower()
    if name == "cdiis":
        return None, False
    kind, _, rest = name.partition("+")
    obj = {"ediis": EDIIS, "adiis": ADIIS}[kind](space)
    return obj, rest == "cdiis"
