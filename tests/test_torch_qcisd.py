"""The port's QCISD(T) (cc/qcisd: make_geris_rhf, map_closed_shell, the
QCISD facade and its .ccsd_t(), the vfac=2 path of the restricted (T)
engine) against the JAX package, in fp64 on the CPU.

Inputs: H2O/cc-pVDZ RHF (the JAX package's test_qcisd.py molecule) with
the JAX RHF's orbitals in the port's mean field, so both packages
transform the same orbitals; CH4/cc-pVDZ with a frozen core for the
reference pin (E_tot -40.3839884, the JAX test's value from the
reference's test_qcisd.py).  Tolerances: the nine spinor blocks 1e-12
(the same fp64 algebra); QCISD energies 1e-9 Ha against the JAX facade
and the JAX package's qcisd_slow oracle; QCISD(T) 1e-10 against JAX's
and against the dense functional ccsd_t_rdm.e_t_dense(v_fac=2) on the
mapped amplitudes; the CH4 pin 1e-6 (its printed digits).
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu.cc import gccsd_slow as jgslow
from pyscf_mpcc_tpu.cc import qcisd as jq
from pyscf_mpcc_tpu.cc import qcisd_slow
from pyscf_mpcc_tpu_torch import gto, scf
from pyscf_mpcc_tpu_torch.cc import ccsd_t_rdm, gccsd, qcisd
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod

torch.set_num_threads(1)

CPU = torch.device("cpu")
H2O = [[8, (0., 0., 0.)], [1, (0., -0.757, 0.587)], [1, (0., 0.757, 0.587)]]
CH4 = """C  0.000  0.000  0.000
         H  0.637  0.637  0.637
         H -0.637 -0.637  0.637
         H -0.637  0.637 -0.637
         H  0.637 -0.637 -0.637"""
E_TOT_CH4 = -40.3839884


def _rhf(pkg_gto, pkg_scf, atom):
    mf = pkg_scf.RHF(pkg_gto.M(atom=atom, basis="cc-pvdz"))
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    mf.kernel()
    assert mf.converged
    return mf


@pytest.fixture(scope="module")
def ref():
    jmf = _rhf(jgto, jscf, H2O)
    q = jq.QCISD(jmf).run()
    assert q.converged
    so = jgslow.eris_from_scf(jmf)
    e_slow, _, _, c = qcisd_slow.kernel(so, conv_tol=1e-10,
                                        conv_tol_normt=1e-8)
    assert c
    return dict(jmf=jmf, e=q.e_corr, e_slow=e_slow, et=q.ccsd_t(tile=4),
                blocks={k: np.asarray(v) for k, v in q._geris.b.items()},
                fock=np.asarray(q._geris.fock))


@pytest.fixture(scope="module")
def mf(ref):
    mf = _rhf(gto, scf, H2O)
    assert abs(mf.e_tot - ref["jmf"].e_tot) < 1e-10
    mf.mo_coeff = np.asarray(ref["jmf"].mo_coeff)
    return mf


def test_make_geris_rhf_blocks_match_jax(ref, mf):
    er = qcisd.make_geris_rhf(mf, device=CPU)
    assert er.nocc == 10 and er.nso == 48
    for k in gccsd.GERIs.BLOCKS:
        np.testing.assert_allclose(er.b[k].numpy(), ref["blocks"][k],
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(er.fock.numpy(), ref["fock"], rtol=0,
                               atol=1e-12)


def test_qcisd_and_qcisd_t_match_jax(ref, mf):
    q = qcisd.QCISD(mf, device=CPU).run()
    assert q.converged and q.t2.dtype == torch.float64
    assert abs(q.e_corr - ref["e"]) < 1e-9
    assert abs(q.e_corr - ref["e_slow"]) < 1e-9
    assert abs(q.e_tot - (mf.e_tot + q.e_corr)) < 1e-12
    et = q.ccsd_t(tile=4, engine="xla")
    assert abs(et - ref["et"]) < 1e-10
    assert abs(et) > 1e-6
    # the restricted vfac=2 tile engine against the dense functional on
    # the mapped amplitudes
    t1, t2 = qcisd.map_closed_shell(q.t1, q.t2, 5, 19)
    er = eris_mod.make_eris_incore(gto.intor_eri(mf.mol), mf.mo_coeff,
                                   mf.get_fock(mf.make_rdm1()), 5,
                                   device=CPU)
    assert abs(float(ccsd_t_rdm.e_t_dense(t1, t2, er, v_fac=2.0)) - et) \
        < 1e-10


def test_qcisd_ch4_frozen_core_pin():
    mf = _rhf(gto, scf, CH4)
    q = qcisd.QCISD(mf, frozen=1, device=CPU)
    q.conv_tol, q.conv_tol_normt = 1e-10, 1e-8
    q.run()
    assert q.converged
    assert abs(q.e_tot - E_TOT_CH4) < 1e-6
