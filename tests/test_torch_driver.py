"""The port's CCSD facade beyond the solve (pyscf_mpcc_tpu_torch.cc.driver,
scf.hf) against the JAX package's driver: chk and DIIS-ring restarts, the
T1/D1/D2 diagnostics, Lambda and the RDMs through the driver, and the SCF
and CCSD geometry scanners.

H2O (the pinned geometry of tests/test_rccsd.py) in fp64 on the CPU.  The
diagnostics are computed by both drivers on the same amplitudes (1e-12);
chk files and DIIS rings pass between the packages unchanged; restarts
reach the uninterrupted energy within 1e-9; the scanners agree with the
JAX scanners within 1e-9 (SCF) and 1e-8 (CCSD, as tests/test_scanner.py).
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu.cc.driver import CCSD as JCCSD
from pyscf_mpcc_tpu.cc.driver import RCCSDDriver as JRCCSDDriver
from pyscf_mpcc_tpu.lib import chkfile as jchkfile
from pyscf_mpcc_tpu.lib import diis as jdiis
from pyscf_mpcc_tpu_torch import ao2mo, gto, testing
from pyscf_mpcc_tpu_torch.cc.driver import CCSD
from pyscf_mpcc_tpu_torch.convert import to_numpy
from pyscf_mpcc_tpu_torch.lib import diis
from pyscf_mpcc_tpu_torch.scf import RHF

torch.set_num_threads(1)

CPU = torch.device("cpu")
E_CCSD = -0.2133432312951   # pyscf/cc/test/test_h2o.py (tests/test_rccsd.py)
GEOM1 = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
GEOM2 = "O 0 0 0.1273; H 0 0.7672 -0.4692; H 0 -0.7672 -0.4692"


def _cc(mf, **kw):
    cc = CCSD(mf, device=CPU, **kw)
    cc.conv_tol = 1e-10
    cc.conv_tol_normt = 1e-8
    return cc


@pytest.fixture(scope="module")
def solved():
    mf = RHF(testing.mol_of("sym"))
    mf.conv_tol = 1e-12
    mf.run()
    cc = _cc(mf).run()
    assert cc.converged and abs(cc.e_corr - E_CCSD) < 1e-7
    return mf, cc


def test_diagnostics_match_jax_driver(solved):
    mf, cc = solved
    jcc = JRCCSDDriver(mf)
    jcc.t1, jcc.t2 = to_numpy(cc.t1), to_numpy(cc.t2)
    for name in ("get_t1_diagnostic", "get_d1_diagnostic",
                 "get_d2_diagnostic"):
        a, b = getattr(cc, name)(), getattr(jcc, name)()
        assert isinstance(a, float) and a > 0
        assert abs(a - b) < 1e-12, name


def test_chk_round_trip_between_packages(solved, tmp_path):
    mf, cc = solved
    p = str(tmp_path / "port.chk")
    cc.dump_chk(p)
    data = jchkfile.load_cc(p)
    np.testing.assert_array_equal(data["t2"], to_numpy(cc.t2))
    assert float(data["e_corr"]) == cc.e_corr
    # a JAX-written chk restores into the port, on its device and dtype
    q = str(tmp_path / "jax.chk")
    jchkfile.dump_cc(q, cc.e_corr, to_numpy(cc.t1) * 0.5,
                     to_numpy(cc.t2) * 0.5, mo_coeff=cc.mo_coeff)
    warm = _cc(mf, dtype=torch.float32).restore_from_chk(q)
    assert warm.t2.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(warm.t1),
                                  (to_numpy(cc.t1) * 0.5).astype(np.float32))
    # a warm restart from the port's own chk lands on the same energy
    cc2 = _cc(mf).restore_from_chk(p)
    cc2.max_cycle = 3
    e, _, _ = cc2.kernel(t1=cc2.t1, t2=cc2.t2)
    assert abs(e - cc.e_corr) < 1e-9


def test_restore_from_diis_(solved, tmp_path):
    mf, cc = solved
    p = str(tmp_path / "ccsd_diis.npz")
    cut = _cc(mf)
    cut.diis_file = p
    cut.max_cycle = 5
    cut.kernel()
    assert not cut.converged
    # the spilled ring is the JAX package's format too
    ring, jring = diis.DIIS.restore(p), jdiis.DIIS.restore(p)
    assert len(ring._xs) == len(jring._xs) >= 3
    for a, b in zip(ring._xs, jring._xs):
        np.testing.assert_array_equal(a, b)
    resumed = _cc(mf).restore_from_diis_(p)
    resumed.kernel()
    assert resumed.converged and resumed._adiis is None
    assert abs(resumed.e_corr - cc.e_corr) < 1e-9


def test_lambda_and_rdms_through_the_driver(solved):
    mf, cc = solved
    l1, l2 = cc.solve_lambda()
    assert cc.l1 is l1 and l2.shape == cc.t2.shape
    rdm1, rdm2 = cc.make_rdm12()
    assert rdm1.device == CPU and rdm1.dtype == torch.float64
    assert abs(float(torch.trace(rdm1)) - 10.0) < 1e-9
    mo = torch.tensor(cc.mo_coeff)
    h = mo.T @ torch.tensor(mf.get_hcore()) @ mo
    g = ao2mo.full(torch.tensor(cc._eri_ao), mo)
    e = float(torch.einsum("pq,pq->", h, rdm1)
              + 0.5 * torch.einsum("pqrs,pqrs->", g, rdm2)) + mf.e_nuc
    assert abs(e - cc.e_tot) < 1e-9
    assert torch.allclose(cc.make_rdm1(), rdm1, rtol=0, atol=1e-12)


def test_scf_scanner_matches_jax():
    mol = gto.M(atom=GEOM1, basis="sto-3g", unit="angstrom")
    jmol = jgto.M(atom=GEOM1, basis="sto-3g", unit="angstrom")
    mf, jmf = RHF(mol), jscf.RHF(jmol)
    for m in (mf, jmf):
        m.conv_tol = 1e-11
        m.kernel()
    scan, jscan = mf.as_scanner(), jmf.as_scanner()
    e2, je2 = scan(GEOM2), jscan(GEOM2)
    assert scan.converged and abs(e2 - je2) < 1e-9
    # a pre-built Mole works too and returns to geometry 1
    e1 = scan(gto.M(atom=GEOM1, basis="sto-3g", unit="angstrom"))
    assert abs(e1 - mf.e_tot) < 1e-9


def test_ccsd_scanner_matches_jax():
    def first(mod_gto, rhf, ccsd, **kw):
        mf = rhf(mod_gto.M(atom=GEOM1, basis="6-31g", unit="angstrom"))
        mf.conv_tol = 1e-11
        mf.kernel()
        cc = ccsd(mf, frozen=1, **kw)
        cc.conv_tol = 1e-10
        cc.conv_tol_normt = 1e-8
        cc.kernel()
        return cc

    cc = first(gto, RHF, CCSD, device=CPU, dtype=torch.float64)
    jcc = first(jgto, jscf.RHF, JCCSD)
    scan, jscan = cc.as_scanner(), jcc.as_scanner()
    e2, je2 = scan(GEOM2), jscan(GEOM2)
    assert scan.converged and abs(e2 - je2) < 1e-8
    assert scan.cc.device == CPU and scan.cc.dtype == torch.float64
    # the warm start: seeded with the previous geometry's amplitudes, one
    # sweep already lands within 1e-6 of the converged energy
    probe = CCSD(scan._mf_scan.mf, frozen=1, device=CPU)
    probe.max_cycle = 1
    probe.kernel(t1=scan.cc.t1, t2=scan.cc.t2)
    assert abs(probe.e_corr - scan.cc.e_corr) < 1e-6
