"""The port's generalized MP2 (mp/gmp2: kernel, update_amps,
kernel_iterative, make_rdm1, make_rdm2, GMP2) and DF-GMP2 (mp/dfgmp2:
spinorb_Lov, DFGMP2) against the JAX package, in fp64 on the CPU.

Inputs: H2O/sto-3g RHF and O2 triplet/sto-3g UHF (the JAX package's
test_gmp2.py and test_torch_ump2.py molecules) with the JAX mean field's
orbitals in the port's, so both packages see the same spin-orbital
integrals; H2O/sto-3g and 6-31g DF-RHF, with and without a frozen core,
and OH/sto-3g DF-UHF for DF-GMP2, and the reference pins of
tests/test_dfgmp2.py (docs/reference_pins.json ``h2o_dfgmp2``).
Tolerances: energies 1e-12 against the JAX package (the same fp64
algebra), amplitudes and RDMs 1e-12, the pins 1e-9 (the JAX test's
bound), the RDM energy identity 1e-10 Ha.
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu.mp import dfgmp2 as jdf
from pyscf_mpcc_tpu.mp import gmp2 as jgmp2
from pyscf_mpcc_tpu_torch import gto, mp, scf
from pyscf_mpcc_tpu_torch.mp import dfgmp2, gmp2

torch.set_num_threads(1)

CPU = torch.device("cpu")
H2O = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
O2 = "O 0 0 0; O 0 0 1.21"
OH = "O 0 0 0; H 0 0 0.97"
# reference pins of tests/test_dfgmp2.py (PIN h2o_<basis>_dfgmp2)
PIN = {"sto-3g": -0.035490285389463326, "631g": -0.12877271226149506}
# (atom, basis, spin, cls, density_fit)
SYSTEMS = {"h2o": (H2O, "sto-3g", 0, "RHF", False),
           "o2": (O2, "sto-3g", 2, "UHF", False),
           "h2o_df": (H2O, "sto-3g", 0, "RHF", True),
           "h2o_631g_df": (H2O, "631g", 0, "RHF", True),
           "oh_df": (OH, "sto-3g", 1, "UHF", True)}


def _mf(pkg_gto, pkg_scf, name):
    atom, basis, spin, cls, df = SYSTEMS[name]
    mf = getattr(pkg_scf, cls)(pkg_gto.M(atom=atom, basis=basis, spin=spin,
                                         unit="angstrom"))
    if df:
        mf = mf.density_fit()
    mf.conv_tol = 1e-13
    mf.kernel()
    assert mf.converged
    return mf


def _pair(name):
    """(port mean field carrying the JAX orbitals, JAX mean field)."""
    jmf = _mf(jgto, jscf, name)
    mf = _mf(gto, scf, name)
    assert abs(mf.e_tot - jmf.e_tot) < 1e-10
    for k in ("mo_coeff", "mo_energy", "mo_occ"):
        setattr(mf, k, np.asarray(getattr(jmf, k)))
    return mf, jmf


@pytest.fixture(scope="module")
def ref():
    out = {}
    for name in ("h2o", "o2"):
        mf, jmf = _pair(name)
        m = jgmp2.GMP2(jmf).run()
        out[name] = dict(mf=mf, e=m.e_corr, t2=np.asarray(m.t2),
                         rdm1=m.make_rdm1(), rdm2=m.make_rdm2(),
                         it=jgmp2.kernel_iterative(m.eris, tol=1e-12)[0],
                         upd=np.asarray(jgmp2.update_amps(m.t2, m.eris)))
    for name in ("h2o_df", "h2o_631g_df", "oh_df"):
        mf, jmf = _pair(name)
        for frozen in (0, 1):
            pt = jdf.DFGMP2(jmf, frozen=frozen).run()
            out[name, frozen] = dict(mf=mf, e=pt.e_corr,
                                     t2=np.asarray(pt.t2),
                                     rdm1=pt.make_rdm1())
    return out


@pytest.mark.parametrize("name", ["h2o", "o2"])
def test_gmp2_matches_jax(ref, name):
    r = ref[name]
    m = gmp2.GMP2(r["mf"], device=CPU).run()
    assert m.t2.dtype == torch.float64
    assert abs(m.e_corr - r["e"]) < 1e-12
    np.testing.assert_allclose(m.t2.numpy(), r["t2"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(m.make_rdm1(), r["rdm1"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(m.make_rdm2(), r["rdm2"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(gmp2.update_amps(m.t2, m.eris).numpy(),
                               r["upd"], rtol=0, atol=1e-12)
    e_it, _ = gmp2.kernel_iterative(m.eris, tol=1e-12, device=CPU)
    assert abs(e_it - r["it"]) < 1e-12
    # the RDM energy identity: E_HF,elec + E_MP2
    er = m.eris
    no = er.nocc
    h = er.fock - np.einsum("piqi->pq", er.ints[:, :no, :, :no])
    g1, g2 = m.make_rdm1(), m.make_rdm2()
    e_dm = np.sum(h * g1) + 0.25 * np.einsum("pqrs,pqrs->", er.ints, g2)
    e_hf = r["mf"].e_tot - r["mf"].mol.energy_nuc()
    assert abs(e_dm - (e_hf + m.e_corr)) < 1e-10
    assert abs(m.e_tot - (r["mf"].e_tot + m.e_corr)) < 1e-12
    assert abs(gmp2.kernel_from_scf(r["mf"], device=CPU)[0] - r["e"]) < 1e-12


@pytest.mark.parametrize("name", ["h2o_df", "h2o_631g_df", "oh_df"])
@pytest.mark.parametrize("frozen", [0, 1])
def test_dfgmp2_matches_jax(ref, name, frozen):
    r = ref[name, frozen]
    pt = dfgmp2.DFGMP2(r["mf"], frozen=frozen, device=CPU).run()
    assert abs(pt.e_corr - r["e"]) < 1e-12
    np.testing.assert_allclose(pt.t2.numpy(), r["t2"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(pt.make_rdm1(), r["rdm1"], rtol=0,
                               atol=1e-12)
    assert abs(np.trace(pt.make_rdm1()) - pt.nocc) < 1e-9


@pytest.mark.parametrize("basis", ["sto-3g", "631g"])
def test_dfgmp2_reference_pin(basis):
    mf = scf.RHF(gto.M(atom=H2O, basis=basis, unit="angstrom"))
    mf.conv_tol = 1e-13
    mf.kernel()
    pt = mp.dfgmp2.DFGMP2(mf, device=CPU).run()
    assert abs(pt.e_corr - PIN[basis]) < 1e-9
