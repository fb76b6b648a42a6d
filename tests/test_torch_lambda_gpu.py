"""The Lambda step and the device DIIS ring on the card.

Needs a CUDA device; skipped elsewhere.  Run on the card with
``python -m pytest tests/test_torch_lambda_gpu.py -o addopts='' --noconftest``
(tests/conftest.py imports jax, which the card's machine may not have).
The inputs are the synthetic DF integrals of ``testing.synthetic_eris``
(nocc=4, nvir=11, naux=30), made on the CPU from seed 0 and copied to the
card, with ntile=3 so the ladder pads nvir to 12:

- the fp64 Lambda step on the card against the same step on the CPU,
  1e-10 of the scale (the same contractions on another BLAS);
- converged multipliers with the device DIIS ring against the host ring,
  both on the card in fp64, 1e-8 (tests/test_lambda_rdm.py);
- the fp32 step against the fp64 step on the card: relative difference
  of the residuals below 1e-5 (true fp32 GEMMs give about 1e-6; a TF32
  matmul about 1e-3).
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu_torch import testing
from pyscf_mpcc_tpu_torch.cc import lambda_ad, rccsd
from pyscf_mpcc_tpu_torch.cc.eris import RERIs

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
NTILE = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyscf_mpcc_tpu_torch.lib import device
    device.set_fp32_precision()
    return torch.device("cuda")


def _problem():
    """fp64 CPU eris, converged amplitudes and perturbed multipliers."""
    er = testing.synthetic_eris(4, 11, 30, device=CPU, dtype=torch.float64,
                                build_ovvv=False)
    conv, _, t1, t2 = rccsd.kernel(er, ntile=NTILE, conv_tol=1e-11,
                                   conv_tol_normt=1e-9)
    assert conv
    rng = np.random.default_rng(4)
    l1 = t1 + 0.01 * torch.from_numpy(rng.standard_normal(t1.shape))
    l2 = t2 + 0.01 * torch.from_numpy(rng.standard_normal(t2.shape))
    return er, t1, t2, l1, 0.5 * (l2 + l2.permute(1, 0, 3, 2))


def _to(xs, dev, dtype=torch.float64):
    if isinstance(xs, RERIs):
        return RERIs(*(None if x is None else x.to(dev, dtype) for x in xs))
    return [x.to(dev, dtype) for x in xs]


def _scaled(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1.0)


def test_step_fp64_matches_cpu(cuda):
    er, t1, t2, l1, l2 = _problem()
    ref = lambda_ad._lambda_step(l1, l2, t1, t2, er, ntile=NTILE)
    out = lambda_ad._lambda_step(*_to((l1, l2, t1, t2), cuda),
                                 _to(er, cuda), ntile=NTILE)
    assert out[0].device.type == cuda.type
    for a, b in zip(out, ref):
        assert _scaled(a, b) < 1e-10


def test_device_ring_matches_host_ring(cuda):
    er, t1, t2, _, _ = _problem()
    erc, (t1c, t2c) = _to(er, cuda), _to((t1, t2), cuda)
    out = {}
    for backend in ("host", "device"):
        conv, l1, l2 = lambda_ad.kernel(t1c, t2c, erc, ntile=NTILE,
                                        conv_tol=1e-10, max_cycle=80,
                                        diis_backend=backend)
        assert conv and l2.device.type == cuda.type
        out[backend] = (l1, l2)
    for a, b in zip(out["device"], out["host"]):
        assert float((a - b).abs().max()) < 1e-8


def test_step_fp32_matches_fp64(cuda):
    er, t1, t2, l1, l2 = _problem()
    s64 = lambda_ad._lambda_step(*_to((l1, l2, t1, t2), cuda),
                                 _to(er, cuda), ntile=NTILE)
    s32 = lambda_ad._lambda_step(*_to((l1, l2, t1, t2), cuda, torch.float32),
                                 _to(er, cuda, torch.float32), ntile=NTILE)
    assert s32[3].dtype == torch.float32
    for k in (2, 3):
        rel = float(torch.linalg.norm(s32[k].double() - s64[k])
                    / torch.linalg.norm(s64[k]))
        assert rel < 1e-5, (k, rel)
