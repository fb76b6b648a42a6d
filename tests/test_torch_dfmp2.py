"""The port's DF-MP2 drivers (pyscf_mpcc_tpu_torch.mp.dfmp2) against the
JAX package.

Both drivers get the same mean field: the JAX package's DF-RHF of H2O
(sto-3g, and cc-pVDZ for the frozen-core relaxed density), whose orbitals,
energies and DF factor are handed to a port RHF of the same molecule.  The
JAX references are computed once (module fixture).  Tolerances: energies
1e-12 (the same fp64 arithmetic); unrelaxed densities 1e-8 and relaxed
densities 1e-8 (the Z-vector solves stop at 1e-10 of the right-hand side
in both packages, by the same rules but over other iterations).  The
solvers' own contracts: CG on an SPD system and GMRES on a nonsymmetric
one reach tol |b|.
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.mp import dfmp2 as jdfmp2
from pyscf_mpcc_tpu.scf import RHF as JRHF
from pyscf_mpcc_tpu_torch import convert, gto
from pyscf_mpcc_tpu_torch.mp import dfmp2
from pyscf_mpcc_tpu_torch.scf import RHF

torch.set_num_threads(1)

CPU = torch.device("cpu")
GEOM = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
ATOL_E, ATOL_DM = 1e-12, 1e-8
# (basis, class, frozen): every density is compared in both representations
CASES = [("sto-3g", "DFRMP2", 0), ("sto-3g", "DFRMP2", 1),
         ("sto-3g", "SCSDFRMP2", 0), ("sto-3g", "SCSDFRMP2", 1),
         ("cc-pvdz", "DFRMP2", 1)]


def _mfs(basis):
    """(JAX mean field, port mean field with the JAX solution)."""
    jmf = JRHF(jgto.M(atom=GEOM, basis=basis, unit="angstrom")).density_fit()
    jmf.conv_tol = 1e-12
    jmf.kernel()
    mf = RHF(gto.M(atom=GEOM, basis=basis, unit="angstrom")).density_fit()
    mf.with_df._B = np.asarray(jmf.with_df.B_ao())
    mf.mo_coeff = np.asarray(jmf.mo_coeff)
    mf.mo_energy = np.asarray(jmf.mo_energy)
    mf.mo_occ = np.asarray(jmf.mo_occ)
    mf.e_tot = jmf.e_tot
    return jmf, mf


@pytest.fixture(scope="module")
def ref():
    mfs = {b: _mfs(b) for b in ("sto-3g", "cc-pvdz")}
    out = {}
    for basis, cls, frozen in CASES:
        m = getattr(jdfmp2, cls)(mfs[basis][0], frozen=frozen).run()
        dms = {(rel, ao): np.asarray(m.make_rdm1(relaxed=rel, ao_repr=ao))
               for rel in (False, True) for ao in (False, True)}
        # the JAX package's relaxed natural orbitals fail on a frozen core
        # (ROADMAP queue C); there its unrelaxed ones are the reference
        out[basis, cls, frozen] = (m.e_corr, m.e_tot, dms,
                                   m.make_natorbs(relaxed=not frozen))
    return mfs, out


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_energy_and_densities_match_jax(ref, case):
    basis, cls, frozen = case
    mfs, out = ref
    e_corr, e_tot, dms, (occ, _) = out[case]
    m = getattr(dfmp2, cls)(mfs[basis][1], frozen=frozen, device=CPU).run()
    assert m.t2.dtype == torch.float64
    assert abs(m.e_corr - e_corr) < ATOL_E
    assert abs(m.e_tot - e_tot) < ATOL_E
    for (rel, ao), want in dms.items():
        got = convert.to_numpy(m.make_rdm1(relaxed=rel, ao_repr=ao))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_DM,
                                   err_msg=f"relaxed={rel} ao_repr={ao}")
    nat_occ, _ = m.make_natorbs(relaxed=not frozen)
    np.testing.assert_allclose(convert.to_numpy(nat_occ), occ, rtol=0,
                               atol=ATOL_DM)
    # relaxed natural orbitals: all electrons, S-orthonormal orbitals
    nat_occ, nat = m.make_natorbs(relaxed=True)
    assert abs(float(nat_occ.sum()) - m.mol.nelectron) < 1e-8
    assert bool((nat_occ[1:] <= nat_occ[:-1] + 1e-12).all())
    S = torch.as_tensor(m._scf.get_ovlp())
    np.testing.assert_allclose(convert.to_numpy(nat.T @ S @ nat),
                               np.eye(nat.shape[1]), atol=1e-8)


def test_relaxed_solvers_on_same_inputs(ref):
    """The two Z-vector functions on one set of numpy inputs (B_ao, C0,
    h_ao and the amplitudes), each package called directly."""
    jmf, mf = ref[0]["sto-3g"]
    B, C0, h = (np.asarray(jmf.with_df.B_ao()), np.asarray(jmf.mo_coeff),
                np.asarray(jmf.get_hcore()))
    jm = jdfmp2.DFRMP2(jmf).run()
    t2 = np.asarray(jm.t2)
    jm1 = jdfmp2.DFRMP2(jmf, frozen=1).run()
    t2f = np.asarray(jm1.t2)
    nocc = mf.mol.nelectron // 2
    tB, tC, th, tt2, tt2f = convert.tensors_from_numpy(B, C0, h, t2, t2f,
                                                       device=CPU)
    got = dfmp2._relaxed_rdm1_ao(tB, tC, th, tt2, nocc, ps=1.2, pt=0.5)
    want = jdfmp2._relaxed_rdm1_ao(B, C0, h, t2, nocc, ps=1.2, pt=0.5)
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=0, atol=ATOL_DM)
    got = dfmp2._relaxed_rdm1_ao_frozen(tB, tC, th, tt2f, nocc, 1)
    want = jdfmp2._relaxed_rdm1_ao_frozen(B, C0, h, t2f, nocc, 1)
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=0, atol=ATOL_DM)


def test_cg_and_gmres_reach_tolerance():
    rng = np.random.default_rng(3)
    n = 30
    a = rng.standard_normal((n, n))
    spd = torch.tensor(a @ a.T + n * np.eye(n))
    gen = torch.tensor(a + n * np.eye(n))
    b = torch.tensor(rng.standard_normal(n))
    x = dfmp2._cg(lambda v: spd @ v, b, tol=1e-10, maxiter=200)
    assert float(torch.linalg.norm(spd @ x - b)) <= 1e-10 * float(
        torch.linalg.norm(b))
    # restart 7 < n: several restart cycles
    x = dfmp2._gmres(lambda v: gen @ v, b, tol=1e-10, restart=7, maxiter=400)
    assert float(torch.linalg.norm(gen @ x - b)) <= 1e-10 * float(
        torch.linalg.norm(b))
    # an exactly solvable Krylov space ends a cycle early (breakdown)
    x = dfmp2._gmres(lambda v: 2.0 * v, b, tol=1e-12, restart=20,
                     maxiter=400)
    np.testing.assert_allclose(x.numpy(), 0.5 * b.numpy(), rtol=1e-14)
