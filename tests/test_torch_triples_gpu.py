"""The hand-written CUDA (T) epilogue against its plain PyTorch version.

Needs an NVIDIA GPU with sm_90a (H100) and nvcc; skipped elsewhere.  Run on
the card with ``python -m pytest tests/test_torch_triples_gpu.py -o addopts=''
--noconftest`` (tests/conftest.py imports jax, which the card's machine may
not have).
Inputs are prepared by the port's own fused prep (cc/ccsd_t.make_prep_fused)
from seeded numpy problems, so the kernel sees the W_PLAN layouts the
(T) loop hands it.  The fused engine's bf16 tiers (dot_precision 'high'
and 'default': one bf16 GEMM with fp32 output a W1 dot, then the kernel)
are held to their plain versions and to the resident engine at nocc 32,
and run at nocc 40, past the resident kernel's shared-memory cap.
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


# the kernel's forms by nocc (triples_combine.cu): fp32 8 (16-byte
# vectors, one w2 chunk a perm), 17 (odd: the threads copy the W streams
# and vooo), 32 (the bench nocc), 33 (two w2 column blocks), 35 (V-term
# inputs from device memory), 36 (the top of the staged range, one w2
# buffer); fp64 26 (the top of the V staging), 28 (the top of the staged
# range).  K = 4 tiles a launch, every act mode.
@pytest.mark.parametrize("act", [None, "exclude_active", "only_active"])
@pytest.mark.parametrize("dtype,nocc", [
    (torch.float32, 8), (torch.float32, 17), (torch.float32, 32),
    (torch.float32, 33), (torch.float32, 35), (torch.float32, 36),
    (torch.float64, 26), (torch.float64, 28)])
def test_kernel_nocc_forms(cuda, dtype, nocc, act):
    t1, t2, eris = _problem(nocc, 6, 40 + nocc, cuda, dtype)
    outs, eijk, actocc = _tiles(t1, t2, eris, 2, act is not None)
    out = ccsd_t.stack_prep(outs[:4])
    kw = dict(actv=out[10], actocc=actocc, act_mode=act) if act else {}
    args = (*out[:8], eijk, *out[8:10])
    staged = tc._lib().triples_combine_staged_bytes(nocc, dtype.itemsize)
    assert staged <= tc._lib().triples_combine_smem_max()
    assert tc._lib().triples_combine_v_staged(nocc, dtype.itemsize) == (
        nocc <= (34 if dtype == torch.float32 else 26))
    e_k = tc.tile_energy_fused_chunk(*args, **kw)
    e_p = tc.tile_energy_fused_reference_chunk(*args, **kw)
    assert torch.isfinite(e_k).all() and e_p.abs().max() > 0
    if dtype == torch.float64:
        torch.testing.assert_close(e_k, e_p, rtol=1e-10, atol=1e-14)
    else:
        # fp32 on both sides: a masked tile whose energy nearly cancels is
        # held to the chunk's largest energy
        torch.testing.assert_close(e_k, e_p, rtol=1e-5,
                                   atol=1e-5 * float(e_p.abs().max()))


# the profile form (the kernel's template flag that stamps each phase of a
# cell) against the plain version and, bit for bit, the kernel, in fp64 at
# nocc 8 (vooo fragments from L2) and 26 (w2 chunks staged by the threads)
@pytest.mark.parametrize("nocc", [8, 26])
def test_profile_form(cuda, nocc):
    t1, t2, eris = _problem(nocc, 6, 2, cuda, torch.float64)
    outs, eijk, _ = _tiles(t1, t2, eris, 2, False)
    args = (*outs[3][:8], eijk, *outs[3][8:10])
    n0 = tc.launch_count
    e_p, cyc = tc.tile_energy_fused_profile(*args)
    assert tc.launch_count == n0              # counted apart
    assert cyc.shape == (2, 2, 2, len(tc.PHASES) + 1)
    busy = cyc[..., -1] > 0
    assert busy.any()
    assert (cyc[..., :-1].sum(-1)[busy] == cyc[..., -1][busy]).all()
    torch.testing.assert_close(e_p, tc.tile_energy_fused_reference(*args),
                               rtol=1e-10, atol=1e-14)
    assert e_p.item() == tc.tile_energy_fused(*args).item()


def test_profile_form_rejects_unstaged(cuda):
    # fp64 at nocc=30 runs the unstaged form, several blocks a cell
    t1, t2, eris = _problem(30, 4, 9, cuda, torch.float64)
    outs, eijk, _ = _tiles(t1, t2, eris, 2, False)
    with pytest.raises(ValueError, match="staged form only"):
        tc.tile_energy_fused_profile(*outs[1][:8], eijk, *outs[1][8:10])


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


@pytest.mark.parametrize("prec", ["high", "default"])
def test_w1_gemm_matches_plain(cuda, prec):
    """emit_w_dot's bf16 GEMM (torch.mm(..., out_dtype=torch.float32))
    against its plain version on the same bf16 parts, every perm, at
    the bench nocc: the same exact products summed in another order."""
    mode = tc.w1_mode(prec)
    g = torch.Generator(device=cuda).manual_seed(3)
    T, o, nvp = 4, 32, 40
    t2T = torch.rand((nvp, nvp, o * o), generator=g, device=cuda) - 0.5
    store = tc.w1_t2(t2T, mode)
    for p in tc.PERMS:
        ov = torch.rand((T, T, o, nvp), generator=g, device=cuda) - 0.5
        a = tc.w1_ov(ov, mode)
        b = tc.w1_t2_slice(store, 8, T, mode)
        w = tc.emit_w_dot(p, a, b, torch.float32, T, o, prec)
        r = tc.emit_w_dot_reference(p, a, b, torch.float32, T, o, prec)
        assert w.dtype == torch.float32 and w.is_contiguous()
        torch.testing.assert_close(w, r, rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("prec", ["high", "default"])
def test_fused_bf16_tiers_match_resident(cuda, prec):
    """At nocc 32 (where engine='auto' takes the bf16 tiers to the
    resident kernel) the fused engine through the combine kernel equals
    the resident engine and the plain 'xla' engine at the same tier
    (fp32: 1e-5), and 'high' stays within the JAX package's 5e-4 of full
    precision."""
    t1, t2, eris = _problem(32, 6, 7, cuda, torch.float32, df=True)
    mode = tc.w1_mode(prec)
    assert ccsd_t.auto_engine("cuda", 32, torch.float32, mode) == "resident"
    n0 = tc.launch_count
    e_f = ccsd_t.kernel(t1, t2, eris, tile=2, engine="fused",
                        dot_precision=prec)
    assert tc.launch_count > n0
    e_r = ccsd_t.kernel(t1, t2, eris, tile=2, engine="resident",
                        dot_precision=prec)
    e_x = ccsd_t.kernel(t1, t2, eris, tile=2, engine="xla",
                        dot_precision=prec)
    assert abs(e_f - e_r) <= 1e-5 * abs(e_r)
    assert abs(e_f - e_x) <= 1e-5 * abs(e_x)
    if prec == "high":
        e_full = ccsd_t.kernel(t1, t2, eris, tile=2, engine="fused")
        assert abs(e_f - e_full) <= 5e-4 * abs(e_full)


@pytest.mark.parametrize("prec", ["high", "default"])
def test_bf16_tiers_past_the_resident_cap(cuda, prec):
    """At nocc 40 the resident kernel cannot hold a cell and raises;
    engine='auto' runs the tier on the fused engine, equal to 'xla'."""
    from pyscf_mpcc_tpu_torch.ops import triples_resident as tr
    t1, t2, eris = _problem(40, 4, 8, cuda, torch.float32)
    mode = tc.w1_mode(prec)
    assert tr.max_nocc(torch.float32, mode) < 40
    assert ccsd_t.auto_engine("cuda", 40, torch.float32, mode) == "fused"
    with pytest.raises(NotImplementedError, match="engine='fused'"):
        ccsd_t.kernel(t1, t2, eris, tile=2, engine="resident",
                      dot_precision=prec)
    n0, r0 = tc.launch_count, tr.launch_count
    e_a = ccsd_t.kernel(t1, t2, eris, tile=2, dot_precision=prec)
    assert tc.launch_count > n0 and tr.launch_count == r0
    e_x = ccsd_t.kernel(t1, t2, eris, tile=2, engine="xla",
                        dot_precision=prec)
    assert abs(e_a - e_x) <= 1e-5 * abs(e_x)


def test_bf16_tiers_take_float32(cuda):
    t1, t2, eris = _problem(3, 7, 1, cuda, torch.float64)
    for engine in ("auto", "fused", "resident"):
        with pytest.raises(ValueError, match="float32"):
            ccsd_t.kernel(t1, t2, eris, tile=3, engine=engine,
                          dot_precision="high")
