"""The benchmark's inputs: a seeded geometry, its AO density-fitting
factors, and a plain DF-RHF converged in fp64.

The port and the plain reference both start from what ``make_inputs``
returns (B, the MO coefficients and the AO Fock matrix), so neither side
derives its inputs from the other.  The integrals come from the frozen
copy of the port's McMurchie-Davidson engine beside this file; the metric
factorisation, the fitting and the SCF run in fp64 on ``device``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ccbench.inputmaker import native
from ccbench.inputmaker.mole import M, Mole

def _rotation(rng):
    """A rotation matrix drawn uniformly (QR of a Gaussian matrix)."""
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def geometry(atoms, seed, translation):
    """The published geometry moved rigidly by an amount drawn from
    ``seed``: a uniformly drawn rotation about the centroid, then a
    translation by a uniform amount in [-translation, translation] Angstrom
    along each axis.  Every number of the inputs changes and none of the
    physics, so every seed asks for the same work (a displacement of each
    atom, a thermal snapshot, changed the cycles a solve takes)."""
    rng = np.random.default_rng(int(seed))
    xyz = np.array([a[1] for a in atoms], dtype=np.float64)
    c = xyz.mean(axis=0)
    xyz = (xyz - c) @ _rotation(rng).T + c + rng.uniform(
        -translation, translation, size=3)
    return [[a[0], tuple(float(c) for c in r)] for a, r in zip(atoms, xyz)]


def df_factors(mol, auxbasis, device):
    """B[P, mu, nu] = L^-1 (P|mu nu) with (P|Q) = L L^T, fp64 on device."""
    aux = Mole(atom=[[s, c] for s, c in zip(mol.symbols, mol.coords)],
               basis=auxbasis, unit="bohr", spin=mol.spin).build()
    j3c = torch.from_numpy(native.eri3c(mol, aux)).to(device)
    j2c = torch.from_numpy(native.eri2c(aux)).to(device)
    nao, naux = mol.nao, aux.nao
    L = torch.linalg.cholesky(j2c)
    b = torch.linalg.solve_triangular(L, j3c.reshape(nao * nao, naux).T,
                                      upper=False)
    del j3c
    return b.reshape(naux, nao, nao)


def _jk(B, dm, c_occ):
    """J and K of the closed-shell density dm = 2 C_occ C_occ^T."""
    j = torch.einsum("Lpq,L->pq", B, torch.einsum("Lrs,rs->L", B, dm))
    x = torch.einsum("Lpq,qi->Lpi", B, c_occ)
    k = 2.0 * torch.einsum("Lpi,Lqi->pq", x, x)
    return j, k


def rhf(mol, B, device, conv_tol=1e-10, grad_tol=1e-7, max_cycle=100,
        diis_space=8):
    """Closed-shell DF-RHF from the core guess with DIIS on FS - SF.
    Returns (mo_coeff, fock_ao, e_tot, cycles); raises if it does not
    converge within max_cycle."""
    S_np, T_np = native.ovlp_kin(mol)
    S = torch.from_numpy(S_np).to(device)
    h = torch.from_numpy(T_np + native.nuc(mol)).to(device)
    enuc = mol.energy_nuc()
    nocc = mol.nelectron // 2
    s, U = torch.linalg.eigh(S)
    X = U / torch.sqrt(s)

    def diag(f):
        e, c = torch.linalg.eigh(X.T @ f @ X)
        return X @ c

    C = diag(h)
    e_last = 0.0
    focks, errs = [], []
    for cycle in range(1, max_cycle + 1):
        co = C[:, :nocc]
        dm = 2.0 * co @ co.T
        j, k = _jk(B, dm, co)
        f = h + j - 0.5 * k
        e = float(torch.sum(dm * (h + 0.5 * (j - 0.5 * k)))) + enuc
        err = X.T @ (f @ dm @ S - S @ dm @ f) @ X
        gnorm = float(torch.linalg.norm(err))
        if abs(e - e_last) < conv_tol and gnorm < grad_tol:
            return C, f, e, cycle
        e_last = e
        focks.append(f)
        errs.append(err)
        del focks[:-diis_space], errs[:-diis_space]
        n = len(focks)
        Bm = torch.zeros((n + 1, n + 1), dtype=torch.float64)
        for a in range(n):
            for b in range(a + 1):
                Bm[a, b] = Bm[b, a] = float(torch.sum(errs[a] * errs[b]))
        Bm[n, :n] = Bm[:n, n] = -1.0
        rhs = torch.zeros(n + 1, dtype=torch.float64)
        rhs[n] = -1.0
        c = torch.linalg.lstsq(Bm, rhs[:, None]).solution[:n, 0]
        f = sum(float(c[a]) * focks[a] for a in range(n))
        C = diag(f)
    raise RuntimeError(f"the DF-RHF did not converge in {max_cycle} cycles")


def make_inputs(cfg, seed, device):
    """The inputs of one run of configuration ``cfg`` (its JSON dict).

    Returns a dict: B (naux, nao, nao), mo (nao, nmo - frozen) and fock_ao
    (nao, nao) as fp64 tensors on device; nocc (active occupied), frozen,
    nao, naux, e_scf, scf_cycles; and the seconds of the integrals, the
    fitting and the SCF.

    The configuration's ``spin`` (2S, 0 where absent) chooses the SCF.  At
    0 it is the closed-shell ``rhf`` above.  Otherwise it is the DF-UHF of
    ``uscf.uhf``, and the keys that differ by spin are pairs, alpha first:
    mo (C_a[:, frozen:], C_b[:, frozen:]), fock_ao (F_a, F_b) and nocc
    (n_a - frozen, n_b - frozen), with ``frozen`` cut from each spin; s2,
    the UHF's <S^2>, is added.  Every other key is as above."""
    t0 = time.perf_counter()
    atoms = geometry(cfg["atoms"], seed, cfg["translation_angstrom"])
    if cfg.get("spin", 0):
        from ccbench.inputmaker import uscf  # uscf builds on this module
        return uscf.make_inputs(cfg, atoms, device, t0)
    mol = M(atom=atoms, basis=cfg["basis"])
    t1 = time.perf_counter()
    B = df_factors(mol, cfg["auxbasis"], device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    C, fock_ao, e_scf, cycles = rhf(mol, B, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t3 = time.perf_counter()
    frozen = int(cfg["frozen"])
    return dict(B=B, mo=C[:, frozen:].contiguous(), fock_ao=fock_ao,
                nocc=mol.nelectron // 2 - frozen, frozen=frozen, nao=mol.nao,
                naux=int(B.shape[0]), e_scf=e_scf, scf_cycles=cycles,
                mol_s=t1 - t0, df_s=t2 - t1, scf_s=t3 - t2)
