"""The hand-written CUDA probe kernels (ops/csrc/triples_probe.cu,
ops/csrc/slab_relayout.cu) against their plain PyTorch versions on the card.

Needs an NVIDIA GPU with sm_90a (H100) and nvcc; skipped elsewhere.  Run on
the card with ``python -m pytest tests/test_torch_probes_gpu.py
-o addopts='' --noconftest`` (tests/conftest.py imports jax, which the
card's machine may not have).  Inputs are seeded numpy arrays.

Tolerances: dispatch, smem and the slab relayout copy values, so they are
exact.  dots: rtol 1e-5 plus an atol of 1e-5 times the largest plain value
(kernel and plain version sum the same fp32, or exact bf16, products over
K in different orders; inputs of both signs cancel, so elements near zero
are held to the product's scale).  stream: fp64 sums of the same fp32
values in different orders, rtol 1e-10; its value (two row sums rounded to
fp32) rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu_torch.tools import slab_loop_probe as slab
from pyscf_mpcc_tpu_torch.tools import triples_probe_v6 as probe

pytestmark = pytest.mark.cuda

RTOL_DOTS = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyscf_mpcc_tpu_torch.lib import device
    device.set_fp32_precision()
    return torch.device("cuda")


def _rand(shape, seed, dev, lo=-1.0, hi=1.0):
    x = np.random.default_rng(seed).uniform(lo, hi, shape)
    return torch.tensor(x, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("grid", [(8,), (8, 8)])
def test_dispatch_matches_plain(cuda, grid):
    x = _rand((1, 1), 1, cuda)
    n0 = probe.launch_count["dispatch"]
    out = probe.dispatch(x, grid)
    torch.cuda.synchronize()
    assert probe.launch_count["dispatch"] == n0 + 1
    assert torch.equal(out, probe.dispatch_reference(x))


def test_dispatch_chain_in_a_graph(cuda):
    x = _rand((1, 1), 2, cuda)
    bufs = [torch.empty_like(x), torch.empty_like(x)]

    def chain():
        y = x
        for n in range(64):
            y = probe.dispatch(y, (8, 8), out=bufs[n % 2])
        return y

    chain()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = chain()
    bufs[0].zero_()
    bufs[1].zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, x)


def test_smem_cap_equals_optin_attribute(cuda):
    x = _rand((8, 1024), 3, cuda)
    cap, out = probe.smem_cap(x)
    optin, blocks = probe.smem_limits(cap)
    assert cap == optin
    assert blocks >= 1
    assert out.item() == x[0, 0].item()
    # a refused size raises outside the bisect, and leaves no error behind
    with pytest.raises(RuntimeError, match="refused"):
        probe.smem_copy(x, cap + 1)
    assert probe.smem_copy(x, cap).item() == x[0, 0].item()
    assert probe.smem_copy(x, 4096).item() == x[0, 0].item()
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode", ["bf16", "split", "f32"])
@pytest.mark.parametrize("shape", [(128, 40, 256), (256, 424, 1024),
                                   (384, 20, 128)])
def test_dots_match_plain(cuda, mode, shape):
    # K = 40 and 424 end on a ragged k-step (32 + 8, 13 x 32 + 8); K = 20
    # is one partial step
    M, K, N = shape
    a, b = _rand((M, K), 4, cuda), _rand((K, N), 5, cuda)
    n0 = probe.launch_count["dots"]
    out, cs = probe.dots(a, b, mode, reps=3)
    torch.cuda.synchronize()
    assert probe.launch_count["dots"] == n0 + 1
    ref, rcs = probe.dots_reference(a, b, mode, reps=3)
    assert out.shape == ref.shape and cs.shape == rcs.shape
    assert torch.isfinite(out).all()
    scale = ref.abs().max().item()
    torch.testing.assert_close(out, ref, rtol=RTOL_DOTS,
                               atol=RTOL_DOTS * scale)
    torch.testing.assert_close(cs, rcs, rtol=RTOL_DOTS,
                               atol=RTOL_DOTS * rcs.abs().max().item())


@pytest.mark.parametrize("mode", ["bf16", "split", "f32"])
def test_dots_ones_exact(cuda, mode):
    a = torch.ones((256, 424), device=cuda)
    b = torch.ones((424, 1024), device=cuda)
    out, cs = probe.dots(a, b, mode, reps=48)
    assert out[0, 0].item() == 48 * 424 == 20352
    assert torch.all(out == 20352)
    assert cs.sum().item() == 48 * 256 * 424 * 1024


def test_dots_reject_bad_input(cuda):
    a = torch.ones((100, 424), device=cuda)
    b = torch.ones((424, 1024), device=cuda)
    with pytest.raises(ValueError, match="multiples"):
        probe.dots(a, b, "bf16", 1)
    with pytest.raises(TypeError):
        probe.dots(b.T.contiguous().double(), b.double(), "bf16", 1)
    with pytest.raises(ValueError, match="unknown mode"):
        probe.dots(b.T.contiguous(), b, "tf32", 1)


@pytest.mark.parametrize("shape", [((3, 8, 424, 1024), (6, 8, 8, 32, 424)),
                                   ((3, 2, 16, 128), (6, 2, 2, 4, 16))])
def test_stream_matches_plain(cuda, shape):
    t2, ov = _rand(shape[0], 6, cuda), _rand(shape[1], 7, cuda)
    n0 = probe.launch_count["stream"]
    value, partial = probe.stream_sum(t2, ov)
    torch.cuda.synchronize()
    assert probe.launch_count["stream"] == n0 + 1
    rv, rp = probe.stream_sum_reference(t2, ov)
    torch.testing.assert_close(partial.sum(), rp.sum(), rtol=1e-10, atol=0)
    torch.testing.assert_close(value, rv, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("o,T", [(32, 8), (4, 2), (8, 3)])
def test_slab_relayout_bitwise(cuda, o, T):
    w = _rand((T, o, T, o * o), o, cuda)
    n0 = slab.launch_count
    out = slab.relayout(w)
    torch.cuda.synchronize()
    assert slab.launch_count == n0 + 1
    assert torch.equal(out, slab.relayout_reference(w))


def test_probe_entry_points_on_the_card(cuda, monkeypatch):
    # p1, p2 and the slab probe at their own size; p3 and p4 cut small
    # (T*o a multiple of the dots kernel's 128-row tile)
    res = probe.p1_dispatch()
    assert all(r["value"] == 1.0 and r["ms_graph"] > 0 for r in res.values())
    cap = probe.p2_smem()["cap"]
    assert cap["cap"] == cap["optin"]
    for k, v in dict(o=64, T=2, F=40, OO=128).items():
        monkeypatch.setattr(probe, k, v)
    res = probe.p3_dots()
    assert [r["value"] for r in res.values()] == [6.0 * 2 * 40] * 9
    assert probe.p4_stream()["fetch"]["value"] == 128.0 + 40.0
    s = slab.main()
    assert s["value"] == s["expect"]
