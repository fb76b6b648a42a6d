"""Determinant-space full CI for tiny systems (Slater-Condon rules).

In-repo oracle (no counterpart needed in production): exact ground and
excited states, and exact matrix elements <mu| H |nu> between arbitrary
excitation classes.  Used to validate the CC stack (CCSD == FCI for two
electrons, CCSDT == FCI for three) and the triples-feedback contractions
of the MP-CC iterative-T3 module against first principles.

Spin orbitals are ordered [occ_a, occ_b, vir_a, vir_b] to match
cc.gccsd_slow; determinants are frozen-ordered index tuples.

A host copy of the JAX package's ci/fci_slow.py (NumPy, its imports pointed at
the port).
"""

from __future__ import annotations

from itertools import combinations

import numpy as np


class FCI:
    def __init__(self, h_so, anti_so, nelec, nso):
        """h_so: (nso,nso) one-electron ints; anti_so: <pq||rs>."""
        self.h = h_so
        self.g = anti_so
        self.nelec = nelec
        self.nso = nso
        self.dets = [tuple(c) for c in combinations(range(nso), nelec)]
        self.index = {d: i for i, d in enumerate(self.dets)}

    # -- Slater-Condon ----------------------------------------------------
    def _sign_and_diff(self, d1, d2):
        s1, s2 = set(d1), set(d2)
        diff1 = sorted(s1 - s2)
        diff2 = sorted(s2 - s1)
        if len(diff1) > 2:
            return None
        # permutation sign: line up common orbitals
        perm = 0
        for p in diff1:
            perm += d1.index(p)
        for p in diff2:
            perm += d2.index(p)
        # adjust for position shifts among removed orbitals
        sign = (-1) ** perm
        return sign, diff1, diff2

    def hmat_element(self, d1, d2):
        res = self._sign_and_diff(d1, d2)
        if res is None:
            return 0.0
        sign, diff1, diff2 = res
        h, g = self.h, self.g
        if len(diff1) == 0:
            e = sum(h[p, p] for p in d1)
            e += 0.5 * sum(g[p, q, p, q] for p in d1 for q in d1)
            return e
        if len(diff1) == 1:
            p, q = diff1[0], diff2[0]
            e = h[p, q] + sum(g[p, r, q, r] for r in d1 if r != p)
            return sign * e
        p1, p2 = diff1
        q1, q2 = diff2
        return sign * g[p1, p2, q1, q2]

    def hamiltonian(self, hermitian=True):
        """Determinant-space H.  hermitian=False evaluates both triangles
        independently — required for similarity-transformed (t1-dressed)
        integrals, which are not hermitian."""
        n = len(self.dets)
        H = np.zeros((n, n))
        if hermitian:
            for i, d1 in enumerate(self.dets):
                for j in range(i + 1):
                    v = self.hmat_element(d1, self.dets[j])
                    H[i, j] = H[j, i] = v
        else:
            for i, d1 in enumerate(self.dets):
                for j, d2 in enumerate(self.dets):
                    H[i, j] = self.hmat_element(d1, d2)
        return H

    def kernel(self, nroots=1):
        H = self.hamiltonian()
        w, v = np.linalg.eigh(H)
        return w[:nroots], v[:, :nroots]

    # -- excitation-operator application ----------------------------------
    def apply_t3(self, t3, nocc):
        """Coefficient vector of (1/36) sum t3_{ijkabc} a+a a+b a+c a_k a_j a_i |HF>.

        t3 is fully antisymmetric in (ijk) and (abc); occupied spin
        orbitals are 0..nocc-1, virtuals nocc..nso-1."""
        hf = tuple(range(nocc))
        vec = np.zeros(len(self.dets))
        nvir = self.nso - nocc
        for i in range(nocc):
            for j in range(i + 1, nocc):
                for k in range(j + 1, nocc):
                    for a in range(nvir):
                        for b in range(a + 1, nvir):
                            for c in range(b + 1, nvir):
                                amp = t3[i, j, k, a, b, c]
                                if abs(amp) < 1e-300:
                                    continue
                                det, sgn = _excite(hf, (i, j, k),
                                                   (nocc + a, nocc + b,
                                                    nocc + c))
                                vec[self.index[det]] += sgn * amp
        return vec

    def project_singles_doubles(self, vec, nocc):
        """<ia| and <ijab| components of a CI vector (same phase
        convention as _excite)."""
        hf = tuple(range(nocc))
        nvir = self.nso - nocc
        r1 = np.zeros((nocc, nvir))
        r2 = np.zeros((nocc, nocc, nvir, nvir))
        for i in range(nocc):
            for a in range(nvir):
                det, sgn = _excite(hf, (i,), (nocc + a,))
                r1[i, a] = sgn * vec[self.index[det]]
        for i in range(nocc):
            for j in range(i + 1, nocc):
                for a in range(nvir):
                    for b in range(a + 1, nvir):
                        det, sgn = _excite(hf, (i, j), (nocc + a, nocc + b))
                        v = sgn * vec[self.index[det]]
                        r2[i, j, a, b] = v
                        r2[j, i, a, b] = -v
                        r2[i, j, b, a] = -v
                        r2[j, i, b, a] = v
        return r1, r2


def _excite(hf, holes, parts):
    """Apply a+_{p1} ... a_{h1} ... to the HF determinant.

    Returns (sorted determinant tuple, fermionic sign) for the operator
    ordering a+_{p1} a+_{p2} ... a_{hn} ... a_{h2} a_{h1} (i.e., holes
    annihilated innermost-first)."""
    occ = list(hf)
    sign = 1
    # annihilate h1 first, then h2, ... (operator string ... a_{h2} a_{h1})
    for h in holes:
        pos = occ.index(h)
        sign *= (-1) ** pos
        occ.pop(pos)
    # create in reverse order so that a+_{p1} is applied last
    for p in reversed(parts):
        pos = 0
        while pos < len(occ) and occ[pos] < p:
            pos += 1
        sign *= (-1) ** pos
        occ.insert(pos, p)
    return tuple(sorted(occ)), sign
