"""The hand-written CUDA resident (T) kernel against its plain PyTorch
version on the card.

Needs an NVIDIA GPU with sm_90a (H100) and nvcc; skipped elsewhere.  Run on
the card with ``python -m pytest tests/test_torch_resident_gpu.py
-o addopts='' --noconftest`` (tests/conftest.py imports jax, which the
card's machine may not have).  Inputs come from the port's resident prep
(cc/ccsd_t.make_prep_resident) on seeded numpy problems.

Tolerances: fp64 mode 'f32', rtol 1e-10 (same function, only the
summation order differs); fp32 modes 'split' and 'bf16', rtol 1e-5
against the plain version in the same mode (both form identical bf16
products and accumulate in fp32, in different orders).
"""

import pytest
import torch

from pyscf_mpcc_tpu_torch import testing
from pyscf_mpcc_tpu_torch.cc import ccsd_t
from pyscf_mpcc_tpu_torch.ops import triples_resident as tr

pytestmark = pytest.mark.cuda

ACT = dict(act_hole=[0, 2], act_particle=[1, 3, 4])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyscf_mpcc_tpu_torch.lib import device
    device.set_fp32_precision()
    return torch.device("cuda")


def _chunk(nocc, nvir, seed, dev, dtype, tile, tiles, act=None, df=False):
    """Stacked resident prep of the given tile indices, eijk, actocc and
    the kwargs of the act mode."""
    t1, t2, eris = testing.triples_tensors(*testing.random_triples_problem(
        nocc, nvir, seed, naux=11 if df else None), dev, dtype)
    kw = ACT if act else dict(act_hole=None, act_particle=None)
    big = ccsd_t._prepare(t1, t2, eris, tile, dtype, kw["act_hole"],
                          kw["act_particle"], 1.0, "resident")
    prep = ccsd_t.make_prep_resident(big)
    eijk, actocc = ccsd_t.fused_shared(big)
    trips = ccsd_t._tile_triples(big["nvp"] // tile)
    out = ccsd_t.stack_prep_resident([prep(trips[n]) for n in tiles])
    akw = dict(act3=out[9], actocc=actocc, act_mode=act) if act else {}
    return (*out[:7], eijk, *out[7:9]), akw


@pytest.mark.parametrize("nocc", [3, 5])
@pytest.mark.parametrize("act", [None, "exclude_active", "only_active"])
@pytest.mark.parametrize("K", [1, 4])
def test_kernel_matches_plain_fp64(cuda, nocc, act, K):
    args, kw = _chunk(nocc, 7, 11 + nocc, cuda, torch.float64, 3,
                      range(K), act, df=(K == 4))
    n0 = tr.launch_count
    e_k = tr.tile_energy_resident_chunk(*args, mode="f32", **kw)
    torch.cuda.synchronize()
    assert tr.launch_count == n0 + 1
    e_p = tr.tile_energy_resident_reference_chunk(*args, mode="f32", **kw)
    assert e_k.shape == (K,) and torch.isfinite(e_k).all()
    torch.testing.assert_close(e_k, e_p, rtol=1e-10, atol=1e-14)


def test_odd_tile_padding_fp64(cuda):
    # nvir=7, tile=4: padded virtuals (weight-zero cells, 1e6 energies)
    args, _ = _chunk(4, 7, 9, cuda, torch.float64, 4, range(4))
    e_k = tr.tile_energy_resident_chunk(*args, mode="f32")
    e_p = tr.tile_energy_resident_reference_chunk(*args, mode="f32")
    torch.testing.assert_close(e_k, e_p, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("mode", ["split", "bf16"])
@pytest.mark.parametrize("act", [None, "only_active"])
def test_tensor_core_modes_match_plain_fp32(cuda, mode, act):
    args, kw = _chunk(5, 9, 4, cuda, torch.float32, 3, range(4), act,
                      df=True)
    e_k = tr.tile_energy_resident_chunk(*args, mode=mode, **kw)
    e_p = tr.tile_energy_resident_reference_chunk(*args, mode=mode, **kw)
    torch.testing.assert_close(e_k, e_p, rtol=1e-5, atol=1e-9)


def test_single_tile_entry(cuda):
    args, _ = _chunk(4, 7, 3, cuda, torch.float64, 3, [2])
    one = [a[0] for a in args[:7]] + [args[7]] + [a[0] for a in args[8:]]
    e_k = tr.tile_energy_resident(*one, mode="f32")
    e_p = tr.tile_energy_resident_reference(*one, mode="f32")
    assert e_k.dim() == 0
    torch.testing.assert_close(e_k, e_p, rtol=1e-10, atol=1e-14)


def test_ccsd_t_resident_engine_matches_xla_engine(cuda):
    t1, t2, eris = testing.triples_tensors(*testing.random_triples_problem(
        5, 9, 5, naux=11), cuda, torch.float64)
    e_x = ccsd_t.kernel(t1, t2, eris, tile=4, engine="xla")
    n0 = tr.launch_count
    e_r = ccsd_t.kernel(t1, t2, eris, tile=4, engine="resident", chunk=3)
    assert tr.launch_count > n0
    assert abs(e_r - e_x) <= 1e-10 * abs(e_x)


def test_kernel_rejects_bad_input(cuda):
    args, _ = _chunk(3, 7, 1, cuda, torch.float64, 3, [0])
    with pytest.raises(ValueError):          # a CPU tensor among CUDA ones
        tr.tile_energy_resident_chunk(*args[:7], args[7].cpu(), *args[8:],
                                      mode="f32")
    with pytest.raises(TypeError):           # mixed dtypes
        tr.tile_energy_resident_chunk(*args[:7], args[7].float(),
                                      *args[8:], mode="f32")
    with pytest.raises(NotImplementedError):  # bf16 modes take fp32
        tr.tile_energy_resident_chunk(*args, mode="split")


def test_kernel_raises_over_shared_memory(cuda):
    # fp64 at nocc=30: the cell's W and the staging exceed 227 KB
    args, _ = _chunk(30, 4, 9, cuda, torch.float64, 2, [1])
    with pytest.raises(NotImplementedError, match="shared memory"):
        tr.tile_energy_resident_chunk(*args, mode="f32")
