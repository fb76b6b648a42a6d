"""MP2 and MP-CC on the card: the H2O/cc-pVDZ pins.

Needs a CUDA device; skipped elsewhere.  Run on the card with
``python -m pytest tests/test_torch_mpcc_gpu.py -o addopts='' --noconftest``
(tests/conftest.py imports jax, which the card's machine may not have).
The incore integrals of the port's own fp64 RHF are built on the card:

- fp64 on the card: E_MP2 (1e-9), the masked solver's all-frozen limit
  (E_MP2, 1e-9) and nothing-frozen limit (E_CCSD, 1e-7), MPCCSD(4,2)
  between them on both DIIS rings, and the low-level energy on
  exact-Cholesky factors (1e-8), the JAX package's pins
  (tests/test_mpcc.py:14-15, tests/test_lowlevel.py:10);
- the same MPCCSD(4,2) and low-level solves in fp32 within 1e-6 Ha of
  fp64, with the frozen blocks equal to the bath bit for bit.
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu_torch import gto, testing
from pyscf_mpcc_tpu_torch.cc import rccsd
from pyscf_mpcc_tpu_torch.cc.eris import RERIs, df_factors, make_eris_incore
from pyscf_mpcc_tpu_torch.mp import mp2
from pyscf_mpcc_tpu_torch.mpcc import lowlevel, rmpccsd
from pyscf_mpcc_tpu_torch.mpcc.masks import frozen_masks
from pyscf_mpcc_tpu_torch.scf import RHF

pytestmark = pytest.mark.cuda

NOCC = 5
E_MP2 = -0.2040199672883385
E_CCSD = -0.2133432312951
E_LL = -0.20549941032564464
SPACE = dict(act_hole=[2, 3, 4], act_particle=[0, 1, 2, 3], idx_s=[],
             idx_d=list(range(15)))
TOL = {torch.float64: dict(conv_tol=1e-10, conv_tol_normt=1e-8,
                           max_cycle=100),
       torch.float32: dict(conv_tol=1e-7, conv_tol_normt=1e-5,
                           max_cycle=100)}


@pytest.fixture(scope="module")
def h2o():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    mol = testing.mol_of("sym")
    mf = RHF(mol)
    mf.conv_tol = 1e-13
    mf.conv_tol_grad = 1e-10
    mf.kernel()
    eri = gto.intor_eri(mol)
    fock_ao = mf.get_fock(mf.make_rdm1())
    er = make_eris_incore(eri, mf.mo_coeff, fock_ao, NOCC, torch.float64,
                          device=dev)
    nao = eri.shape[0]
    w, v = np.linalg.eigh(eri.reshape(nao * nao, nao * nao))
    keep = w > 1e-12
    b_chol = (v[:, keep] * np.sqrt(w[keep])).T.reshape(-1, nao, nao)
    return dict(eris={torch.float64: er,
                      torch.float32: RERIs(*(None if x is None else x.float()
                                             for x in er))},
                b=b_chol, mo=mf.mo_coeff,
                fock_mo=mf.mo_coeff.T @ fock_ao @ mf.mo_coeff)


def test_mp2_and_limits_fp64(h2o):
    er = h2o["eris"][torch.float64]
    e, _ = mp2.kernel(er.mo_energy[:NOCC], er.mo_energy[NOCC:], er.ovov)
    assert abs(float(e) - E_MP2) < 1e-9
    conv, e, *_ = rmpccsd.kernel(er, [0, 1], [0, 1], list(range(4)),
                                 list(range(16)), **TOL[torch.float64])
    assert conv and abs(e - E_MP2) < 1e-9
    conv, e, *_ = rmpccsd.kernel(er, [0, 1], [0, 1], [], [],
                                 **TOL[torch.float64])
    assert conv and abs(e - E_CCSD) < 1e-7


def _mpccsd42(er, ring):
    _, t1_0, t2_0 = rccsd.init_amps(er)
    conv, e, t1, t2 = rmpccsd.kernel(er, **SPACE, t1=t1_0, t2=t2_0,
                                     diis_backend=ring, **TOL[t2_0.dtype])
    m1, m2 = (torch.as_tensor(m, device=t2.device) for m in frozen_masks(
        SPACE["act_hole"], SPACE["act_particle"], NOCC, er.nvir,
        SPACE["idx_s"], SPACE["idx_d"]))
    assert conv and t2.dtype == t2_0.dtype
    assert torch.equal(t1[m1], t1_0[m1]) and torch.equal(t2[m2], t2_0[m2])
    return e


@pytest.mark.parametrize("ring", ["host", "device"])
def test_mpccsd42_fp64_and_fp32(h2o, ring):
    e64 = _mpccsd42(h2o["eris"][torch.float64], ring)
    assert E_CCSD - 1e-9 < e64 < E_MP2 + 1e-9
    e32 = _mpccsd42(h2o["eris"][torch.float32], ring)
    assert abs(e32 - e64) < 1e-6


def test_lowlevel_fp64_and_fp32(h2o):
    e = {}
    for dt, tol in ((torch.float64, 1e-9), (torch.float32, 1e-6)):
        L = df_factors(h2o["b"], h2o["mo"], NOCC, dt,
                       device=torch.device("cuda"))
        conv, e[dt], t1, _ = lowlevel.kernel(*L, h2o["fock_mo"], NOCC,
                                             conv_tol=tol)
        assert conv and t1.dtype == dt and t1.device.type == "cuda"
    assert abs(e[torch.float64] - E_LL) < 1e-8
    assert abs(e[torch.float32] - e[torch.float64]) < 1e-6
