"""The EOM sigma and the host-streamed ladder on the card.

Needs a CUDA device; skipped elsewhere.  Run on the card with
``python -m pytest tests/test_torch_eom_gpu.py -o addopts='' --noconftest``
(tests/conftest.py imports jax, which the card's machine may not have).

- The EE sigma (cc/eom.ee_sigma, a torch.func.jvp of the CCSD residual)
  of H2O/sto-3g in fp64 on the card against the same sigma on the CPU,
  1e-10 of its scale (the same contractions on another BLAS); the port's
  own host RHF and a CPU CCSD give the inputs.
- The streamed ladder (lib/hoststore, cc/stream_ladder) on the card in
  fp32 at a synthetic (nocc, nvir, naux) = (8, 160, 400), ntile 8, with
  a seeded t1 of 1e-2: one CCSD sweep and one Lambda step against the
  resident ones, relative
  1e-5 (fp32 along other GEMM blockings), and in each the streamed peak
  below the resident peak by at least Lvv less three row tiles: the
  backward pass must not keep fetched tiles alive.
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu_torch import gto, testing
from pyscf_mpcc_tpu_torch.cc import eom, lambda_ad, rccsd
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.lib.hoststore import HostStore
from pyscf_mpcc_tpu_torch.scf import RHF

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
H2O = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
NTILE = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyscf_mpcc_tpu_torch.lib import device
    device.set_fp32_precision()
    return torch.device("cuda")


def test_ee_sigma_card_matches_cpu(cuda):
    mol = gto.M(atom=H2O, basis="sto-3g", unit="angstrom")
    mf = RHF(mol)
    mf.conv_tol = 1e-12
    mf.kernel()
    args = (gto.intor_eri(mol), mf.mo_coeff, mf.get_fock(mf.make_rdm1()), 5)
    er = eris_mod.make_eris_incore(*args, device=CPU)
    conv, _, t1, t2 = rccsd.kernel(er, conv_tol=1e-11, conv_tol_normt=1e-9)
    assert conv
    rng = np.random.default_rng(0)
    r1 = torch.tensor(rng.standard_normal(t1.shape))
    r2 = torch.tensor(rng.standard_normal(t2.shape))
    r2 = 0.5 * (r2 + r2.permute(1, 0, 3, 2))
    ref = eom.ee_sigma(t1, t2, er, r1, r2)
    erc = eris_mod.make_eris_incore(*args, dtype=torch.float64, device=cuda)
    got = eom.ee_sigma(*(x.to(cuda) for x in (t1, t2)), erc,
                       r1.to(cuda), r2.to(cuda))
    for a, b in zip(got, ref):
        assert a.device.type == cuda.type
        assert float((a.cpu() - b).abs().max()) < 1e-10 * float(
            b.abs().max())


def _peaks(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def test_streamed_ladder_card_matches_resident_below_its_peak(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    er = testing.synthetic_eris(8, 160, 400, device=cuda, generator=gen,
                                build_ovvv=False)
    _, t1, t2 = rccsd.init_amps(er)
    # the MP2 guess has t1 = 0 (a diagonal Fock): dress the tiles
    t1 = 1e-2 * torch.randn(t1.shape, generator=gen, device=cuda,
                            dtype=t2.dtype)

    def run(e):
        (_, a2), p_sweep = _peaks(lambda: rccsd.update_amps(t1, t2, e,
                                                            ntile=NTILE))
        step, p_lam = _peaks(lambda: lambda_ad._lambda_step(
            t1, t2, t1, t2, e, ntile=NTILE))
        return a2.cpu(), step[3].cpu(), p_sweep, p_lam

    res = run(er)
    lvv = er.Lvv.numel() * er.Lvv.element_size()
    store = HostStore.from_tensor(er.Lvv, cuda, ntile=NTILE)
    assert store.tiles.is_pinned()
    er = er._replace(Lvv=None, Lvv_stream=store)
    torch.cuda.empty_cache()
    st = run(er)
    for a, b in zip(st[:2], res[:2]):
        assert float((a - b).norm() / b.norm()) < 1e-5
    need = lvv - 3 * store.nbytes // store.ntile
    assert res[2] - st[2] >= need, (res[2], st[2], need)
    assert res[3] - st[3] >= need, (res[3], st[3], need)
    assert store.bytes_moved >= 2 * store.nbytes
