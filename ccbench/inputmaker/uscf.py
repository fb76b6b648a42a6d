"""A plain DF-UHF in fp64 for the benchmark's open-shell configurations.

The unrestricted twin of ``scf.rhf`` on the same fitted factors B: J from
the total density, K per spin from B and that spin's occupied
coefficients, commutator DIIS on both spins' errors stacked together, the
same convergence test.  The guess is a superposition of atomic densities
(fractional-occupation atomic RHF, each fitted with the configuration's own
auxiliary basis), split evenly between the spins: it depends on the
geometry only through the atoms' positions, so a rigidly moved molecule
starts, and ends, in the same state.
"""

from __future__ import annotations

import time

import torch

from ccbench.inputmaker import native
from ccbench.inputmaker.elements import charge as elem_charge
from ccbench.inputmaker.mole import M, Mole
from ccbench.inputmaker.scf import df_factors


def _frac_occ(e, nelec):
    """Aufbau occupations of ``nelec`` electrons over orbital energies
    ``e``, spread evenly over each set within 1e-5 Eh of one another (an
    atom's open shell)."""
    occ = torch.zeros_like(e)
    order = torch.argsort(e).tolist()
    left, i = float(nelec), 0
    while i < len(order) and left > 1e-12:
        j = i
        while (j + 1 < len(order)
               and float(e[order[j + 1]] - e[order[j]]) < 1e-5):
            j += 1
        take = min(2.0 * (j + 1 - i), left)
        occ[order[i:j + 1]] = take / (j + 1 - i)
        left -= take
        i = j + 1
    return occ


def _k_of(B, dm):
    """K of a general density: sum_L B_L dm B_L."""
    return torch.einsum("Lpr,rs,Lqs->pq", B, dm, B)


def atom_density(symbol, basis, auxbasis, device):
    """Spherically averaged density of a free atom: a damped
    fractional-occupation DF-RHF in the atom's own basis, to 1e-10 Eh or
    200 cycles (a guess: it need not converge)."""
    mol = Mole(atom=[[symbol, (0.0, 0.0, 0.0)]], basis=basis,
               spin=elem_charge(symbol) % 2).build()
    B = df_factors(mol, auxbasis, device)
    S_np, T_np = native.ovlp_kin(mol)
    S = torch.from_numpy(S_np).to(device)
    h = torch.from_numpy(T_np + native.nuc(mol)).to(device)
    sval, U = torch.linalg.eigh(S)
    X = U / torch.sqrt(sval)

    def occupied(f):
        e, c = torch.linalg.eigh(X.T @ f @ X)
        c = X @ c
        return (c * _frac_occ(e, mol.nelectron)) @ c.T

    dm = occupied(h)
    e_last = float("inf")
    for _ in range(200):
        j = torch.einsum("Lpq,L->pq", B, torch.einsum("Lrs,rs->L", B, dm))
        f = h + j - 0.5 * _k_of(B, dm)
        e = 0.5 * float(torch.sum(dm * (h + f)))
        dm = 0.7 * occupied(f) + 0.3 * dm
        if abs(e - e_last) < 1e-10:
            break
        e_last = e
    return dm


def guess_density(mol, auxbasis, device):
    """The block-diagonal superposition of the atoms' densities."""
    blocks = {sym: atom_density(sym, mol.basis, auxbasis, device)
              for sym in set(mol.symbols)}
    return torch.block_diag(*(blocks[s] for s in mol.symbols))


def _extrapolate(focks, errs):
    """Commutator DIIS: the combination of the stored Fock pairs whose
    stacked errors have the least norm (deterministic SVD least squares)."""
    n = len(focks)
    Bm = torch.zeros((n + 1, n + 1), dtype=torch.float64)
    for a in range(n):
        for b in range(a + 1):
            Bm[a, b] = Bm[b, a] = float(torch.sum(errs[a] * errs[b]))
    Bm[n, :n] = Bm[:n, n] = -1.0
    rhs = torch.zeros(n + 1, dtype=torch.float64)
    rhs[n] = -1.0
    c = torch.linalg.lstsq(Bm, rhs[:, None], driver="gelsd").solution[:n, 0]
    return sum(float(c[a]) * focks[a] for a in range(n))


def spin_square(c_a, c_b, S):
    """<S^2> of the determinant with occupied orbitals c_a and c_b."""
    sz = 0.5 * (c_a.shape[1] - c_b.shape[1])
    ovlp = c_a.T @ S @ c_b
    return sz * (sz + 1) + c_b.shape[1] - float(torch.sum(ovlp * ovlp))


def uhf(mol, B, auxbasis, device, conv_tol=1e-10, grad_tol=1e-7,
        max_cycle=100, diis_space=8):
    """Open-shell DF-UHF from the atomic guess with DIIS on both spins'
    F D S - S D F.  Returns ((C_a, C_b), (F_a, F_b), e_tot, s2, cycles);
    raises if it does not converge within max_cycle."""
    S_np, T_np = native.ovlp_kin(mol)
    S = torch.from_numpy(S_np).to(device)
    h = torch.from_numpy(T_np + native.nuc(mol)).to(device)
    enuc = mol.energy_nuc()
    nocc = mol.nelec
    sval, U = torch.linalg.eigh(S)
    X = U / torch.sqrt(sval)

    def diag(f):
        e, c = torch.linalg.eigh(X.T @ f @ X)
        return X @ c

    dm = guess_density(mol, auxbasis, device)
    j = torch.einsum("Lpq,L->pq", B, torch.einsum("Lrs,rs->L", B, dm))
    c0 = diag(h + j - 0.5 * _k_of(B, dm))
    C = torch.stack((c0, c0))
    e_last = 0.0
    focks, errs = [], []
    for cycle in range(1, max_cycle + 1):
        co = [C[s][:, :nocc[s]] for s in (0, 1)]
        dm = torch.stack([c @ c.T for c in co])
        j = torch.einsum("Lpq,L->pq", B,
                         torch.einsum("Lrs,rs->L", B, dm[0] + dm[1]))
        x = [torch.einsum("Lpq,qi->Lpi", B, c) for c in co]
        f = torch.stack([h + j - torch.einsum("Lpi,Lqi->pq", x[s], x[s])
                         for s in (0, 1)])
        e = 0.5 * float(torch.sum(dm * (h + f))) + enuc
        err = torch.stack([X.T @ (f[s] @ dm[s] @ S - S @ dm[s] @ f[s]) @ X
                           for s in (0, 1)])
        gnorm = float(torch.linalg.norm(err))
        if abs(e - e_last) < conv_tol and gnorm < grad_tol:
            return ((C[0], C[1]), (f[0], f[1]), e,
                    spin_square(co[0], co[1], S), cycle)
        e_last = e
        focks.append(f)
        errs.append(err)
        del focks[:-diis_space], errs[:-diis_space]
        fx = _extrapolate(focks, errs)
        C = torch.stack((diag(fx[0]), diag(fx[1])))
    raise RuntimeError(f"the DF-UHF did not converge in {max_cycle} cycles")


def make_inputs(cfg, atoms, device, t0):
    """``scf.make_inputs`` for a configuration with a ``spin``: the
    molecule at ``atoms`` (the seeded geometry), its factors B and the
    DF-UHF, with the per-spin keys that function's docstring lists.  ``t0``
    is the host clock at the start of the inputs."""
    mol = M(atom=atoms, basis=cfg["basis"], spin=int(cfg["spin"]))
    t1 = time.perf_counter()
    B = df_factors(mol, cfg["auxbasis"], device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    C, fock_ao, e_scf, s2, cycles = uhf(mol, B, cfg["auxbasis"], device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t3 = time.perf_counter()
    frozen = int(cfg["frozen"])
    return dict(B=B, mo=tuple(c[:, frozen:].contiguous() for c in C),
                fock_ao=fock_ao, nocc=tuple(n - frozen for n in mol.nelec),
                s2=s2, frozen=frozen, nao=mol.nao, naux=int(B.shape[0]),
                e_scf=e_scf, scf_cycles=cycles, mol_s=t1 - t0, df_s=t2 - t1,
                scf_s=t3 - t2)
