"""IP/EA-EOM-CCSD by explicit similarity transform (determinant space).

Role of the reference's ipccsd/eaccsd (pyscf/cc/eom_rccsd.py:291,606) as a
textbook-slow implementation: instead of hand-derived sigma intermediates,
build Hbar = e^{-T} H e^{T} exactly in the (N -/+ 1)-electron determinant
space (T is nilpotent there, so the exponentials are finite series), then
diagonalize its projection onto the {1h, 2h1p} / {1p, 2p1h} subspace.
Small systems only (determinant-space dimensions), but exact EOM-CCSD:
for a two-electron reference the IP roots are rigorously exact ionization
energies, which the tests exploit.

The spin-orbital amplitudes come from cc.gccsd_slow (order
[occ_a, occ_b, vir_a, vir_b]).

A host copy of the JAX package's cc/eom_slow.py (NumPy, its imports pointed at
the port).
"""

from __future__ import annotations

import numpy as np

from pyscf_mpcc_tpu_torch.ci.fci_slow import FCI, _excite


def _t_matrix(dets, index, t1, t2, nocc):
    """Matrix of T = sum t1 a+_a a_i + 1/4 sum t2 a+_a a+_b a_j a_i on the
    given determinant list (spin-orbital amplitudes)."""
    nvir = t1.shape[1]
    n = len(dets)
    T = np.zeros((n, n))
    for col, det in enumerate(dets):
        occ_in = [p for p in det if p < nocc]
        vir_free = [a for a in range(nocc, nocc + nvir) if a not in det]
        for i in occ_in:
            for a in vir_free:
                amp = t1[i, a - nocc]
                if amp != 0.0:
                    nd, sgn = _excite(det, (i,), (a,))
                    T[index[nd], col] += sgn * amp
        for ii, i in enumerate(occ_in):
            for j in occ_in[ii + 1:]:
                for ai, a in enumerate(vir_free):
                    for b in vir_free[ai + 1:]:
                        amp = t2[i, j, a - nocc, b - nocc]
                        if amp != 0.0:
                            nd, sgn = _excite(det, (i, j), (a, b))
                            T[index[nd], col] += sgn * amp
    return T


def _expm_nilpotent(T):
    n = T.shape[0]
    acc = np.eye(n)
    x = np.eye(n)
    for k in range(1, 60):
        x = (x @ T) / k
        acc += x
        if np.abs(x).max() < 1e-16:
            break
    return acc


def _hbar(h_so, g_so, nelec, nso, t1, t2, nocc):
    f = FCI(h_so, g_so, nelec, nso)
    H = f.hamiltonian()
    T = _t_matrix(f.dets, f.index, t1, t2, nocc)
    eT = _expm_nilpotent(T)
    emT = _expm_nilpotent(-T)
    return f, emT @ H @ eT


def ipccsd(h_so, g_so, t1, t2, nocc, nso, nroots=3, e_ccsd_tot=0.0,
           nalpha=None, spins=None):
    """Lowest IP-EOM-CCSD roots (energies relative to the CC ground state).

    h_so/g_so: one-electron / antisymmetrized two-electron spin-orbital
    integrals; t1/t2: converged spin-orbital amplitudes; nocc: N electrons.

    nalpha + spins: optionally restrict the {1h, 2h1p} basis to
    determinants with that many alpha electrons (one Sz sector; Hbar is
    Sz-block-diagonal).  spins: 0/1 per spin orbital, e.g.
    gccsd_slow eris_from_scf(...).spins."""
    f, Hb = _hbar(h_so, g_so, nocc - 1, nso, t1, t2, nocc)
    hf = tuple(range(nocc))
    # basis: 1h and 2h1p determinants
    basis = []
    for d in f.dets:
        nh = len([p for p in hf if p not in d])
        npart = len([p for p in d if p >= nocc])
        if (nh, npart) in ((1, 0), (2, 1)):
            if nalpha is not None and _nalpha(d, spins) != nalpha:
                continue
            basis.append(f.index[d])
    basis = np.asarray(basis)
    sub = Hb[np.ix_(basis, basis)]
    w = np.linalg.eigvals(sub)
    w = np.sort(w.real)
    return w[:nroots] - e_ccsd_tot


def eaccsd(h_so, g_so, t1, t2, nocc, nso, nroots=3, e_ccsd_tot=0.0,
           nalpha=None, spins=None):
    """Lowest EA-EOM-CCSD roots (attached-state energies minus E_CC)."""
    f, Hb = _hbar(h_so, g_so, nocc + 1, nso, t1, t2, nocc)
    hf = tuple(range(nocc))
    basis = []
    for d in f.dets:
        nh = len([p for p in hf if p not in d])
        npart = len([p for p in d if p >= nocc])
        if (nh, npart) in ((0, 1), (1, 2)):
            if nalpha is not None and _nalpha(d, spins) != nalpha:
                continue
            basis.append(f.index[d])
    basis = np.asarray(basis)
    sub = Hb[np.ix_(basis, basis)]
    w = np.linalg.eigvals(sub)
    w = np.sort(w.real)
    return w[:nroots] - e_ccsd_tot


def _nalpha(det, spins):
    return sum(1 for p in det if spins[p] == 0)


def h_so_from_eris(eris):
    """Recover the one-electron spin-orbital matrix from fock and <pq||rs>."""
    nso, nocc = eris.nso, eris.nocc
    h = eris.fock.copy()
    for p in range(nso):
        for q in range(nso):
            h[p, q] -= sum(eris.ints[p, j, q, j] for j in range(nocc))
    return h
