"""The (T)-response and spin-orbital layer on the card.

Needs a CUDA device; skipped elsewhere.  Run on the card with
``python -m pytest tests/test_torch_spinorb_gpu.py -o addopts='' --noconftest``
(tests/conftest.py imports jax, which the card's machine may not have;
this file imports only the port).  The same calls on the CPU are the
reference:

- QCISD(T) of H2O/sto-3g (the vfac=2 path) in fp64 through the combine
  kernel (chunk 1 and 3), the resident kernel and engine='xla': 1e-10
  against each other and the CPU, and in fp32 through engine='auto'
  (the combine kernel; the resident one at dot_precision='high') within
  1e-6 Ha of fp64;
- BCCD(T) of H2O/sto-3g in fp64 through the combine kernel, 1e-9;
- GCCSD of OH/sto-3g GHF, the dense R and GHF (T) functionals, GMP2 and
  DF-GMP2, and the device DF J/K, fp64 card against CPU 1e-10.
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu_torch import gto, scf
from pyscf_mpcc_tpu_torch.cc import (bccd, ccsd_t_rdm, gccsd, gccsd_t_rdm,
                                     qcisd, rccsd)
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.mp import dfgmp2, gmp2
from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
from pyscf_mpcc_tpu_torch.ops import triples_resident as tr
from pyscf_mpcc_tpu_torch.scf.hf import _JKDF

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
F64, F32 = torch.float64, torch.float32
H2O = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
OH = "O 0 0 0; H 0 0 0.97"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyscf_mpcc_tpu_torch.lib import device
    device.set_fp32_precision()
    return torch.device("cuda")


def _mf(cls, atom, spin=0):
    mf = getattr(scf, cls)(gto.M(atom=atom, basis="sto-3g", spin=spin,
                                 unit="angstrom"))
    mf.conv_tol = 1e-12
    mf.kernel()
    return mf


def _qcisd(mf, dev, dt):
    q = qcisd.QCISD(mf, device=dev, dtype=dt)
    if dt == F32:
        q.conv_tol, q.conv_tol_normt = 1e-7, 1e-5
    return q.run()


def test_qcisd_t_engines_on_the_card(cuda):
    mf = _mf("RHF", H2O)
    ref = _qcisd(mf, CPU, F64)
    e_ref = ref.ccsd_t(engine="xla")
    q = _qcisd(mf, cuda, F64)
    assert q.converged and abs(q.e_corr - ref.e_corr) < 1e-10
    runs = {"fused": (tc, dict(engine="fused")),
            "chunk": (tc, dict(engine="fused", chunk=3)),
            "resident": (tr, dict(engine="resident")),
            "xla": (None, dict(engine="xla"))}
    for name, (mod, kw) in runs.items():
        if mod is not None:
            mod.launch_count = 0
        e = q.ccsd_t(**kw)
        assert abs(e - e_ref) < 1e-10, name
        if mod is not None:
            assert mod.launch_count > 0, name
    q32 = _qcisd(mf, cuda, F32)
    assert q32.t2.dtype == F32 and abs(q32.e_corr - ref.e_corr) < 1e-6
    for mod, kw in ((tc, {}), (tr, dict(dot_precision="high"))):
        mod.launch_count = 0
        assert abs(q32.ccsd_t(**kw) - e_ref) < 1e-6
        assert mod.launch_count > 0


def test_bccd_t_on_the_card(cuda):
    mf = _mf("RHF", H2O)
    eri = gto.intor_eri(mf.mol)
    ref = bccd.kernel_t(mf, eri, t1_tol=1e-7, device=CPU)
    tc.launch_count = 0
    got = bccd.kernel_t(mf, eri, t1_tol=1e-7, device=cuda, dtype=F64)
    assert tc.launch_count > 0
    assert abs(got[0] - ref[0]) < 1e-9 and abs(got[1] - ref[1]) < 1e-9


def test_gccsd_and_t_functionals_on_the_card(cuda):
    mf = _mf("GHF", OH, spin=1)
    out = []
    for dev in (CPU, cuda):
        er = gccsd.make_eris_ghf(mf, dtype=F64, device=dev)
        e, t1, t2, c = gccsd.kernel(er, conv_tol=1e-11, conv_tol_normt=1e-9)
        assert c and t2.device.type == dev.type
        out.append((e, float(gccsd_t_rdm.e_t_g(t1, t2, er))))
    assert abs(out[1][0] - out[0][0]) < 1e-10
    assert abs(out[1][1] - out[0][1]) < 1e-13
    rmf = _mf("RHF", H2O)
    et = []
    for dev in (CPU, cuda):
        er = eris_mod.make_eris_incore(gto.intor_eri(rmf.mol), rmf.mo_coeff,
                                       rmf.get_fock(rmf.make_rdm1()), 5,
                                       F64, device=dev)
        _, _, t1, t2 = rccsd.kernel(er, conv_tol=1e-11, conv_tol_normt=1e-9)
        et.append(float(ccsd_t_rdm.e_t_dense(t1, t2, er, v_fac=2.0)))
    assert abs(et[1] - et[0]) < 1e-12


def test_gmp2_dfgmp2_and_device_jk_on_the_card(cuda):
    mf = _mf("RHF", H2O)
    e = [gmp2.GMP2(mf, device=d, dtype=F64).run().e_corr
         for d in (CPU, cuda)]
    assert abs(e[1] - e[0]) < 1e-12
    e = [dfgmp2.DFGMP2(mf, device=d, dtype=F64).run().e_corr
         for d in (CPU, cuda)]
    assert abs(e[1] - e[0]) < 1e-12
    B = mf.with_df.B_ao()
    dm = mf.make_rdm1()
    host = _JKDF(B).get_jk(dm)
    for dt, tol in ((F64, 1e-10), (F32, 1e-4)):
        got = _JKDF(B, device=cuda, dtype=dt).get_jk(dm)
        for g, w in zip(got, host):
            assert g.dtype == np.float64
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
