"""The open-shell MP-CC layer on the card.

Needs a CUDA device; skipped elsewhere.  Run on the card with
``python -m pytest tests/test_torch_umpcc_gpu.py -o addopts='' --noconftest``
(tests/conftest.py imports jax, which the card's machine may not have;
this file imports only the port).  Inputs: O2 triplet/sto-3g UHF and
H2O/6-31g RHF (as UHF blocks), solved on the host; the same calls on the
CPU are the reference:

- fp64 on the card against the CPU, 1e-10 (the same fp64 algebra on
  another BLAS): the masked UMPCC solve on both DIIS rings, one OO-MP2
  relaxation per variant, the masked Lambda, kernel_pert_df (ccsdt-3) and
  ccsdt_env.kernel (ccsdt-1, ccsdt-3) on the active space of
  tests/test_ccsdt_act.py;
- the same UMPCC and kernel_pert_df solves in fp32 within 1e-6 Ha of
  fp64, with fp32 results and the frozen blocks equal to the bath bit for
  bit.
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu_torch import gto, scf
from pyscf_mpcc_tpu_torch.cc import ccsdt_env, uccsd
from pyscf_mpcc_tpu_torch.mpcc import oomp2, umpccsd

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
F64, F32 = torch.float64, torch.float32
O2_SPACE = (([7, 8], [5, 6]), ([0], [0, 1]))
H2O_SPACE = (([2, 3, 4], [2, 3, 4]), ([0, 1, 3], [0, 1, 3]))
FREEZE = dict(idx_s=[], idx_d=list(range(15)))
# fp32 t3 steps stall near the fp32 resolution of the blocks
ENV_TOL = {F64: 1e-8, F32: 1e-6}
TOL = {F64: dict(conv_tol=1e-11, conv_tol_normt=1e-9, max_cycle=100),
       F32: dict(conv_tol=1e-7, conv_tol_normt=1e-5, max_cycle=100)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyscf_mpcc_tpu_torch.lib import device
    device.set_fp32_precision()
    return torch.device("cuda")


def _o2():
    mf = scf.UHF(gto.M(atom="O 0 0 0; O 0 0 1.21", basis="sto-3g", spin=2))
    mf.conv_tol, mf.conv_tol_grad = 1e-12, 1e-9
    return mf.run()


def _h2o_df(dev, dtype):
    """UERIs, full-MO factors B (exact Cholesky) and h of H2O/6-31g."""
    mol = gto.M(atom="O 0 0 0; H 0 -0.757 0.587; H 0 0.757 0.587",
                basis="6-31g")
    mf = scf.UHF(mol)
    mf.conv_tol, mf.conv_tol_grad = 1e-12, 1e-9
    mf.run()
    eri = gto.intor_eri(mol)
    nao = eri.shape[0]
    w, v = np.linalg.eigh(eri.reshape(nao * nao, nao * nao))
    keep = w > 1e-12
    b_ao = (v[:, keep] * np.sqrt(w[keep])).T.reshape(-1, nao, nao)
    B = tuple(np.einsum("Lmn,mp,nq->Lpq", b_ao, c, c, optimize=True)
              for c in mf.mo_coeff)
    hc = mf.get_hcore()
    h = tuple(c.T @ hc @ c for c in mf.mo_coeff)
    er = uccsd.eris_from_scf(mf, dtype, device=dev)
    return mf, er, B, h


def _maxdiff(xs, ys):
    return max(float((a.double().cpu() - b.double().cpu()).abs().max())
               for a, b in zip(xs, ys))


def test_umpcc_card_matches_cpu_and_fp32(cuda):
    mf = _o2()
    out = {}
    for dev, dt, ring in ((CPU, F64, "host"), (cuda, F64, "host"),
                          (cuda, F64, "device"), (cuda, F32, "host")):
        er = uccsd.eris_from_scf(mf, dt, device=dev)
        _, _, bath = uccsd.init_amps(er)
        conv, e, t1, t2 = umpccsd.kernel(er, *O2_SPACE, **FREEZE,
                                         diis_backend=ring, **TOL[dt])
        assert conv and t2[1].dtype == dt and t2[1].device.type == dev.type
        masks = umpccsd.frozen_masks_u(
            *O2_SPACE, mf.mol.nelec, tuple(x.shape[1] for x in t1),
            *umpccsd._index_lists(**FREEZE), device=dev)
        for t, b, m in zip(t2, bath, masks[2:]):
            assert torch.equal(t[m], b[m])
        out[(dev.type, dt, ring)] = (e, t1, t2)
    ref = out[("cpu", F64, "host")]
    for key in (("cuda", F64, "host"), ("cuda", F64, "device")):
        assert abs(out[key][0] - ref[0]) < 1e-10
        assert _maxdiff((*out[key][1], *out[key][2]), (*ref[1], *ref[2])) \
            < 1e-9
    assert abs(out[("cuda", F32, "host")][0] - ref[0]) < 1e-6


@pytest.mark.parametrize("variant", oomp2.VARIANTS)
def test_oomp2_relaxation_card_matches_cpu(cuda, variant):
    mf = _o2()
    es = []
    for dev in (CPU, cuda):
        er = uccsd.eris_from_scf(mf, F64, device=dev)
        conv, e, *_ = umpccsd.kernel(er, *O2_SPACE, idx_s=[3], idx_d=[15],
                                     oo_mp2=True, oomp2_variant=variant,
                                     **TOL[F64])
        assert conv
        es.append(e)
    assert abs(es[0] - es[1]) < 1e-10


def test_lambda_kernel_card_matches_cpu(cuda):
    mf = _o2()
    ls = []
    for dev in (CPU, cuda):
        er = uccsd.eris_from_scf(mf, F64, device=dev)
        _, _, t1, t2 = umpccsd.kernel(er, *O2_SPACE, **FREEZE, **TOL[F64])
        conv, l1, l2 = umpccsd.lambda_kernel(er, t1, t2, *O2_SPACE,
                                             **FREEZE, conv_tol=1e-10,
                                             max_cycle=100)
        assert conv
        ls.append((*l1, *l2))
    assert _maxdiff(ls[0], ls[1]) < 1e-9


def test_triples_card_matches_cpu_and_fp32(cuda):
    res = {}
    for dev, dt in ((CPU, F64), (cuda, F64), (cuda, F32)):
        mf, er, B, h = _h2o_df(dev, dt)
        conv, e, t1, t2, t3 = umpccsd.kernel_pert_df(
            er, B, h, *H2O_SPACE, **FREEZE, model="ccsdt-3", **TOL[dt])
        assert conv and t3["aabaab"].dtype == dt
        env = {m: ccsdt_env.kernel(B, h, t1, t2, mf.mol.nelec, *H2O_SPACE,
                                   tuple(mf.mo_energy), model=m,
                                   conv_tol=ENV_TOL[dt], device=dev,
                                   dtype=dt)
               for m in ("ccsdt-1", "ccsdt-3")}
        assert all(x[2] for x in env.values())
        res[(dev.type, dt)] = (e, {m: x[0] for m, x in env.items()})
    ref = res[("cpu", F64)]
    for key, tol in ((("cuda", F64), 1e-10), (("cuda", F32), 1e-6)):
        assert abs(res[key][0] - ref[0]) < tol
        for m in ref[1]:
            assert abs(res[key][1][m] - ref[1][m]) < tol
