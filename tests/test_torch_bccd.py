"""The port's BCCD and BCCD(T) (cc/bccd: kernel, kernel_t) against the
JAX package, in fp64 on the CPU.

Input: H2O/sto-3g RHF (the JAX package's test_bccd.py BCCD(T) molecule),
the JAX mean field's orbitals in the port's.  Tolerances: the Brueckner
energy and E(T) 1e-9 Ha against the JAX package (both solve to t1 below
1e-7 with CCSD at 1e-9), the same number of macro-iterations, Brueckner
orbitals S-orthonormal to 1e-8, and BCCD(T) within 2e-4 Ha of CCSD(T)
(the JAX test's bound).
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu.cc import bccd as jbccd
from pyscf_mpcc_tpu_torch import gto, scf
from pyscf_mpcc_tpu_torch.cc import bccd, ccsd_t, rccsd
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod

torch.set_num_threads(1)

CPU = torch.device("cpu")
ATOM = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"


def _rhf(pkg_gto, pkg_scf):
    mf = pkg_scf.RHF(pkg_gto.M(atom=ATOM, basis="sto-3g", unit="angstrom"))
    mf.conv_tol = 1e-12
    mf.kernel()
    return mf


@pytest.fixture(scope="module")
def ref():
    jmf = _rhf(jgto, jscf)
    eri = jgto.intor_eri(jmf.mol)
    e_b, mo_b, _, nmac = jbccd.kernel(jmf, eri, t1_tol=1e-7)
    e_b2, e_bt, _ = jbccd.kernel_t(jmf, eri, t1_tol=1e-7)
    return dict(jmf=jmf, e_b=e_b, mo_b=mo_b, nmac=nmac, e_bt=e_bt)


@pytest.fixture(scope="module")
def mf(ref):
    mf = _rhf(gto, scf)
    assert abs(mf.e_tot - ref["jmf"].e_tot) < 1e-10
    mf.mo_coeff = np.asarray(ref["jmf"].mo_coeff)
    return mf


def test_bccd_matches_jax(ref, mf):
    e_b, mo_b, t2, nmac = bccd.kernel(mf, gto.intor_eri(mf.mol),
                                      t1_tol=1e-7, device=CPU)
    assert t2.dtype == torch.float64 and nmac == ref["nmac"]
    assert abs(e_b - ref["e_b"]) < 1e-9
    ov = mo_b.T @ mf.S @ mo_b
    assert np.abs(ov - np.eye(ov.shape[0])).max() < 1e-8


def test_bccd_t_matches_jax_and_tracks_ccsd_t(ref, mf):
    eri = gto.intor_eri(mf.mol)
    e_b, e_bt, _ = bccd.kernel_t(mf, eri, t1_tol=1e-7, device=CPU)
    assert abs(e_b - ref["e_b"]) < 1e-9
    assert abs(e_bt - ref["e_bt"]) < 1e-9 and e_bt < 0
    er = eris_mod.make_eris_incore(eri, mf.mo_coeff,
                                   mf.get_fock(mf.make_rdm1()), 5,
                                   device=CPU)
    c, e_c, t1, t2 = rccsd.kernel(er, conv_tol=1e-11, conv_tol_normt=1e-9)
    assert c
    e_ct = ccsd_t.kernel(t1, t2, er, tile=8)
    assert abs((e_b + e_bt) - (float(e_c) + e_ct)) < 2e-4
