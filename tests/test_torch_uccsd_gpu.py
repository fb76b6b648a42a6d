"""The open-shell path on the card.

Needs a CUDA device; skipped elsewhere.  Run on the card with
``python -m pytest tests/test_torch_uccsd_gpu.py -o addopts='' --noconftest``
(tests/conftest.py imports jax, which the card's machine may not have;
this file imports only the port).  Inputs: O2 triplet/sto-3g UHF, solved
on the host; the same calls on the CPU are the reference:

- UCCSD, UCCSD(T), unrestricted Λ (device ring) and the Lagrangian in
  fp64 on the card against the CPU: 1e-10 (the same fp64 algebra on
  another BLAS);
- the response RDMs' energy identity on the card, 1e-8;
- an fp32 UCCSD sweep on synthetic UERIs against the fp64 sweep: the
  relative t2 difference below 1e-5 (true fp32 GEMMs give about 1e-6, a
  TF32 matmul about 1e-3);
- DF-UMP2 energy and relaxed density in fp64, card against CPU, 1e-10.
"""

import pytest
import torch

from pyscf_mpcc_tpu_torch import ao2mo, gto, scf, testing
from pyscf_mpcc_tpu_torch.cc import lambda_ad, uccsd
from pyscf_mpcc_tpu_torch.cc.driver import CCSD
from pyscf_mpcc_tpu_torch.mp import DFUMP2

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
F64 = torch.float64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyscf_mpcc_tpu_torch.lib import device
    device.set_fp32_precision()
    return torch.device("cuda")


def _uhf(df=False):
    mf = scf.UHF(gto.M(atom="O 0 0 0; O 0 0 1.21", basis="sto-3g", spin=2))
    if df:
        mf.density_fit()
    mf.conv_tol, mf.conv_tol_grad = 1e-12, 1e-9
    return mf.run()


def _solve(mf, dev):
    cc = CCSD(mf, device=dev, dtype=F64).set(conv_tol=1e-11,
                                              conv_tol_normt=1e-9)
    cc.run()
    cl, l1, l2 = lambda_ad.kernel_u(cc.t1, cc.t2, cc.eris, conv_tol=1e-10,
                                    max_cycle=100, diis_backend="device")
    assert cc.converged and cl
    e_l = float(lambda_ad.lagrangian_energy_u(cc.t1, cc.t2, l1, l2,
                                              cc.eris))
    return cc, l1, l2, cc.ccsd_t(tile=2), e_l


def test_uccsd_t_lambda_fp64_card_matches_cpu(cuda):
    mf = _uhf(df=True)
    cpu = _solve(mf, CPU)
    card = _solve(mf, cuda)
    assert card[0].t2[1].device.type == cuda.type
    assert abs(card[0].e_corr - cpu[0].e_corr) < 1e-10
    assert abs(card[3] - cpu[3]) < 1e-10 and abs(card[4] - cpu[4]) < 1e-10
    for a, b in zip((*card[1], *card[2]), (*cpu[1], *cpu[2])):
        assert float((a.cpu() - b).abs().max()) < 1e-10


def test_rdm_energy_identity_on_card(cuda):
    mf = _uhf()
    cc, l1, l2, _, _ = _solve(mf, cuda)
    moa, mob = (torch.as_tensor(c, dtype=F64, device=cuda)
                for c in mf.mo_coeff)
    eri = torch.as_tensor(gto.intor_eri(mf.mol), dtype=F64, device=cuda)
    h = torch.as_tensor(mf.get_hcore(), dtype=F64, device=cuda)
    ints = (moa.T @ h @ moa, mob.T @ h @ mob, ao2mo.full(eri, moa),
            ao2mo.general(eri, (moa, moa, mob, mob)), ao2mo.full(eri, mob))
    (d1a, d1b), (d2aa, d2ab, d2bb) = lambda_ad.make_rdm12_u(
        *ints, cc.t1, cc.t2, l1, l2, *mf.mol.nelec)
    h_a, h_b, g_aa, g_ab, g_bb = ints
    e = float((h_a * d1a).sum() + (h_b * d1b).sum()
              + 0.5 * (g_aa * d2aa).sum() + 0.5 * (g_bb * d2bb).sum()
              + (g_ab * d2ab).sum()) + mf.mol.energy_nuc()
    assert abs(e - cc.e_tot) < 1e-8


def test_fp32_sweep_against_fp64(cuda):
    er64 = testing.synthetic_ueris(6, 5, 30, 31, 60, device=cuda, dtype=F64)
    er32 = uccsd.UERIs(*(x.float() if torch.is_tensor(x) else x
                         for x in er64))
    _, t1, t2 = uccsd.init_amps(er64)
    _, b2 = uccsd.update_amps(t1, t2, er64, ntile=3)
    _, a2 = uccsd.update_amps(tuple(x.float() for x in t1),
                              tuple(x.float() for x in t2), er32, ntile=3)
    rel = max(float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))
              for a, b in zip(a2, b2))
    assert rel < 1e-5


def test_dfump2_card_matches_cpu(cuda):
    mf = _uhf(df=True)
    out = []
    for dev in (cuda, CPU):
        pt = DFUMP2(mf, device=dev, dtype=F64).run()
        out.append((pt.e_corr, pt.make_rdm1(relaxed=True).cpu()))
    assert abs(out[0][0] - out[1][0]) < 1e-10
    assert float((out[0][1] - out[1][1]).abs().max()) < 1e-10
