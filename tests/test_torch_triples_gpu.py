"""The hand-written CUDA (T) epilogue against its plain PyTorch version.

Needs an NVIDIA GPU with sm_90a (H100) and nvcc; skipped elsewhere.  Run on
the card with ``python -m pytest tests/test_torch_triples_gpu.py -o addopts=''
--noconftest`` (tests/conftest.py imports jax, which the card's machine may
not have).
Inputs are prepared by the port's own fused prep (cc/ccsd_t.make_prep_fused)
from seeded numpy problems, so the kernel sees the W_PLAN layouts the
(T) driver hands it.
"""

import pytest
import torch

from pyscf_mpcc_tpu_torch import testing
from pyscf_mpcc_tpu_torch.cc import ccsd_t
from pyscf_mpcc_tpu_torch.ops import triples_combine as tc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyscf_mpcc_tpu_torch.lib import device
    device.set_fp32_precision()
    return torch.device("cuda")


def _problem(nocc, nvir, seed, dev, dtype, df=False):
    return testing.triples_tensors(*testing.random_triples_problem(
        nocc, nvir, seed, naux=11 if df else None), dev, dtype)


def _tiles(t1, t2, eris, tile, act):
    kw = dict(act_hole=[0, 2], act_particle=[1, 3, 4]) if act else {}
    big = ccsd_t._prepare(t1, t2, eris, tile, t2.dtype,
                          kw.get("act_hole"), kw.get("act_particle"), 1.0,
                          "fused")
    prep = ccsd_t.make_prep_fused(big)
    eijk, actocc = ccsd_t.fused_shared(big)
    trips = ccsd_t._tile_triples(big["nvp"] // tile)
    return [prep(abc) for abc in trips], eijk, actocc


@pytest.mark.parametrize("nocc", [3, 5])
@pytest.mark.parametrize("mode", [None, "exclude_active", "only_active"])
@pytest.mark.parametrize("K", [1, 4])
def test_kernel_matches_plain_fp64(cuda, nocc, mode, K):
    t1, t2, eris = _problem(nocc, 7, 11 + nocc, cuda, torch.float64,
                            df=(K == 4))
    outs, eijk, actocc = _tiles(t1, t2, eris, 3, mode is not None)
    out = ccsd_t.stack_prep(outs[:K])
    kw = {}
    if mode is not None:
        kw = dict(actv=out[10], actocc=actocc, act_mode=mode)
    args = (*out[:8], eijk, *out[8:10])
    n0 = tc.launch_count
    e_k = tc.tile_energy_fused_chunk(*args, **kw)
    torch.cuda.synchronize()
    assert tc.launch_count == n0 + 1
    e_p = tc.tile_energy_fused_reference_chunk(*args, **kw)
    assert e_k.shape == (K,)
    assert torch.isfinite(e_k).all()
    torch.testing.assert_close(e_k, e_p, rtol=1e-10, atol=1e-14)


def test_kernel_single_tile_entry(cuda):
    t1, t2, eris = _problem(4, 7, 3, cuda, torch.float64)
    outs, eijk, _ = _tiles(t1, t2, eris, 3, False)
    for out in outs[:3]:
        args = (*out[:8], eijk, *out[8:10])
        e_k = tc.tile_energy_fused(*args)
        e_p = tc.tile_energy_fused_reference(*args)
        torch.testing.assert_close(e_k, e_p, rtol=1e-10, atol=1e-14)


def test_ccsd_t_fused_engine_matches_xla_engine(cuda):
    t1, t2, eris = _problem(5, 9, 5, cuda, torch.float64, df=True)
    e_x = ccsd_t.kernel(t1, t2, eris, tile=4, engine="xla")
    n0 = tc.launch_count
    e_f = ccsd_t.kernel(t1, t2, eris, tile=4, engine="auto")
    assert tc.launch_count > n0
    assert abs(e_f - e_x) <= 1e-10 * abs(e_x)


def test_kernel_rejects_bad_input(cuda):
    t1, t2, eris = _problem(3, 7, 1, cuda, torch.float64)
    outs, eijk, _ = _tiles(t1, t2, eris, 3, False)
    out = outs[0]
    with pytest.raises(TypeError):
        tc.tile_energy_fused(*out[:8], eijk.float(), *out[8:10])
    with pytest.raises(ValueError):
        tc.tile_energy_fused(*out[:8], eijk.cpu(), *out[8:10])


def test_unstaged_kernel_large_nocc(cuda):
    # fp64 at nocc=30: the cell's W no longer fits in shared memory, so the
    # kernel runs its unstaged form (orbits split over several blocks)
    t1, t2, eris = _problem(30, 4, 9, cuda, torch.float64)
    outs, eijk, _ = _tiles(t1, t2, eris, 2, False)
    out = ccsd_t.stack_prep(outs[1:3])
    args = (*out[:8], eijk, *out[8:10])
    e_k = tc.tile_energy_fused_chunk(*args)
    e_p = tc.tile_energy_fused_reference_chunk(*args)
    torch.testing.assert_close(e_k, e_p, rtol=1e-10, atol=1e-14)
