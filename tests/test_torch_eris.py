"""The port's integral containers, AO->MO transforms and memory planners
against the JAX package, on the same numpy inputs (fp64 on the CPU).

Blocks agree to rtol 1e-10 / atol 1e-13 (the port transforms in fp64
with another summation order); the planners are the same shape
arithmetic and must return identical tiles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import ao2mo as jao2mo
from pyscf_mpcc_tpu.cc import eris as jeris
from pyscf_mpcc_tpu.df import DF
from pyscf_mpcc_tpu.lib import memory as jmemory
from pyscf_mpcc_tpu.testutil import h2o_ccpvdz, mol_of
from pyscf_mpcc_tpu_torch import ao2mo, config, convert
from pyscf_mpcc_tpu_torch.cc import eris as teris
from pyscf_mpcc_tpu_torch.lib import memory

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-10, 1e-13


@pytest.fixture(scope="module")
def h2o():
    d = h2o_ccpvdz()
    d["B"] = DF(mol_of("sym")).B_ao()
    return d


def _assert_same(port, ref):
    for name in ref._fields:
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if b is not None:
            np.testing.assert_allclose(convert.to_numpy(a), np.asarray(b),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def test_ao2mo_general_matches_jax(h2o):
    rng = np.random.default_rng(0)
    nao = 6
    eri = rng.standard_normal((nao,) * 4)
    cs = [rng.standard_normal((nao, n)) for n in (2, 3, 4, 5)]
    ref = np.asarray(jao2mo.general(jnp.asarray(eri),
                                    [jnp.asarray(c) for c in cs]))
    out = ao2mo.general(torch.tensor(eri), [torch.tensor(c) for c in cs])
    np.testing.assert_allclose(convert.to_numpy(out), ref, rtol=RTOL,
                               atol=ATOL)


def test_make_eris_incore_matches_jax(h2o):
    args = (h2o["eri_ao"], h2o["mo_coeff"], h2o["fock_ao"], 5)
    _assert_same(teris.make_eris_incore(*args, device=CPU),
                 jeris.make_eris_incore(*args))


@pytest.mark.parametrize("keep_ovvv", [True, False])
def test_make_eris_df_matches_jax(h2o, keep_ovvv):
    args = (h2o["B"], h2o["mo_coeff"], h2o["fock_ao"], 5)
    port = teris.make_eris_df(*args, keep_ovvv=keep_ovvv, device=CPU)
    _assert_same(port, jeris.make_eris_df(*args, keep_ovvv=keep_ovvv))
    np.testing.assert_array_equal(
        convert.to_numpy(port.get_ovvo()),
        convert.to_numpy(port.ovov).transpose(0, 1, 3, 2))
    # the out-of-core container: the same fields with Lvv in a host store
    st = teris.make_eris_df(*args, stream_vv=True, device=CPU)
    assert st.Lvv is None and st.ovvv is None and port.Lvv_stream is None
    lvv = convert.to_numpy(port.Lvv)
    np.testing.assert_allclose(st.Lvv_stream.to_dense().numpy(), lvv,
                               rtol=0, atol=1e-13 * np.abs(lvv).max())
    for k in ("fock", "mo_energy", "oooo", "ovoo", "ovov", "oovv", "Lov",
              "Loo"):
        np.testing.assert_allclose(
            convert.to_numpy(getattr(st, k)),
            convert.to_numpy(getattr(port, k)), rtol=0, atol=1e-13,
            err_msg=k)
    with pytest.raises(NotImplementedError):
        teris.make_eris_df(*args, device=CPU, transform_backend="ozaki")


def test_eris_from_numpy_round_trip(h2o):
    ref = jeris.make_eris_df(h2o["B"], h2o["mo_coeff"], h2o["fock_ao"], 5)
    fields = {k: None if v is None else np.asarray(v)
              for k, v in ref._asdict().items()}
    _assert_same(convert.eris_from_numpy(fields, CPU), ref)
    with pytest.raises(ValueError):
        convert.eris_from_numpy(dict(fields, bogus=None), CPU)


@pytest.mark.parametrize("shape", [(5, 19, 84), (32, 424, 1216),
                                   (10, 200, 500)])
@pytest.mark.parametrize("gib", [4, 16, 80])
def test_planners_match_jax(shape, gib):
    budget = gib * 2**30
    for dtype, jdt in ((torch.float32, "float32"),
                       (torch.float64, "float64")):
        assert memory.plan_ladder_ntile(*shape, dtype, budget=budget) == \
            jmemory.plan_ladder_ntile(*shape, jdt, budget=budget)
        assert memory.plan_ladder_ntile(*shape, dtype, budget=budget,
                                        vjp=True) == \
            jmemory.plan_ladder_ntile(*shape, jdt, budget=budget, vjp=True)
        assert memory.plan_triples_tile(*shape, dtype, budget=budget) == \
            jmemory.plan_triples_tile(*shape, jdt, budget=budget)


def test_cpu_budget_needs_explicit_limit(monkeypatch):
    monkeypatch.setattr(config, "MAX_MEMORY", 0)
    with pytest.raises(ValueError):
        memory.hbm_budget_bytes(CPU)
    with pytest.raises(ValueError):
        memory.plan_ladder_ntile(5, 19, 84, device=CPU)
    monkeypatch.setattr(config, "MAX_MEMORY", 2048)
    assert memory.hbm_budget_bytes(CPU) == 2048 * 2**20


def test_resident_triples_tile_counts_its_t2_operand():
    """plan_triples_tile(engine='resident') counts the W1 operand that the
    resident prep makes of t2 (ops.triples_resident.t2_operand): at the
    (H2O)8 shape in fp32, a budget that just holds the fused engine's
    tile 8 gives the resident engine a smaller tile, and it gets tile 8
    once the operand's split (3.5 padded copies) fits too."""
    from pyscf_mpcc_tpu_torch.ops import triples_resident as tr
    no, nv, na = 32, 424, 1216
    persistent = (3 * nv**2 * no**2 + na * nv**2 + na * no * nv) * 4
    fused8 = (6 * 8**3 * no**3 + 6 * 8**2 * no * nv) * 4 * 4
    # the counted copy at tile 8: t2T (424, 424, 32^2), its contracted
    # axis padded to a multiple of 32
    opnd8 = 424 * 448 * 1024 * 4
    budget = persistent + fused8
    assert memory.plan_triples_tile(no, nv, na, budget=budget) == 8
    assert memory.plan_triples_tile(no, nv, na, budget=budget,
                                    engine="resident") < 8
    assert memory.plan_triples_tile(no, nv, na,
                                    budget=persistent + 7 * opnd8 // 2,
                                    engine="resident") == 8
    # the count bounds what the prep keeps: the split parts of a real
    # operand (nvp 12, o 3) against the same formula
    t2T = torch.rand((12, 12, 9), dtype=torch.float32)
    hi, lo = tr.t2_operand(t2T, "split")
    assert hi.nbytes + lo.nbytes <= 12 * 32 * 16 * 4


@pytest.mark.parametrize("prec", ["high", "default"])
def test_fused_triples_tile_counts_its_bf16_parts(prec):
    """plan_triples_tile(engine='fused', dot_precision='high'|'default')
    counts the bf16 parts of t2T and t2Ts that the fused prep keeps
    (ops.triples_combine.w1_t2) and what is live while t2Ts is split: at
    the (H2O)8 shape in fp32, a budget that just holds full-precision
    tile 8 gives 'high' (one fp32 copy's bytes a layout of parts) a
    smaller tile; with one more t2 copy of room (and the split's chunk
    temporaries and the per-tile operands) it gets tile 8 again.
    'default' keeps hi only, as many bytes as the dropped fp32 t2Ts, so
    it fits where full precision does once the per-tile operands do."""
    from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
    no, nv, na = 32, 424, 1216
    o2v2 = nv**2 * no**2
    persistent = (3 * o2v2 + na * nv**2 + na * no * nv) * 4
    fused8 = (6 * 8**3 * no**3 + 6 * 8**2 * no * nv) * 4 * 4
    budget = persistent + fused8
    assert memory.plan_triples_tile(no, nv, na, budget=budget) == 8
    k = 3 if prec == "high" else 1
    tile_ops = (6 * 8 * 8 * no + 4 * 8 * no * no) * k * nv * 2
    chunk_tmp = 2 * 4 * o2v2 // tc.T2_SPLIT_CHUNKS + 1
    more = (o2v2 * 4 if prec == "high" else 0) + chunk_tmp + tile_ops
    if prec == "high":
        assert memory.plan_triples_tile(no, nv, na, budget=budget,
                                        dot_precision=prec) < 8
    assert memory.plan_triples_tile(no, nv, na, budget=budget + more,
                                    dot_precision=prec) == 8
    # the count bounds what the prep keeps: w1_t2's parts of a real t2
    # layout against one fp32 copy (two bf16 parts) or half of one
    t2T = torch.rand((12, 12, 9), dtype=torch.float32)
    parts = tc.w1_t2(t2T, tc.w1_mode(prec))
    assert parts.nbytes == t2T.nbytes * (1 if prec == "high" else 0.5)


def _floor_check(shape, ntile, dtype, budget, vjp):
    """plan_ladder_ntile's own test that one pair's block fits."""
    nocc, nvir, naux = shape
    isz = dtype.itemsize
    persistent = (naux * nvir * nvir + naux * nocc * nvir
                  + (7 if vjp else 4) * nocc * nocc * nvir * nvir) * isz
    avail = max(budget - persistent, budget // 8)
    tsz = -(-nvir // ntile)
    return tsz * tsz * nvir * nvir * isz * (4 if vjp else 2) <= avail // 2


@pytest.mark.parametrize("shape", [(5, 19, 84), (21, 243, 360),
                                   (32, 424, 1112), (32, 424, 1216),
                                   (10, 200, 500)])
@pytest.mark.parametrize("gib", [4, 16, 64, 80])
@pytest.mark.parametrize("vjp", [False, True])
def test_ladder_tiles_at_or_above_the_memory_floor(shape, gib, vjp):
    """plan_ladder_tiles never plans fewer tiles than plan_ladder_ntile,
    its block passes the floor's own fit test wherever the floor's does,
    and a count above the floor keeps the tau contraction's outputs."""
    budget = gib * 2**30
    for dtype in (torch.float32, torch.float64):
        floor = memory.plan_ladder_ntile(*shape, dtype, budget=budget,
                                         vjp=vjp)
        nt = memory.plan_ladder_tiles(*shape, dtype, budget=budget, vjp=vjp)
        assert nt >= floor
        if _floor_check(shape, floor, dtype, budget, vjp):
            assert _floor_check(shape, nt, dtype, budget, vjp)
        if nt > floor:
            tsz = -(-shape[1] // nt)
            assert shape[0] ** 2 * tsz ** 2 >= memory.MIN_TAU_OUTPUTS
            assert memory.ladder_sweep_model_s(*shape, nt, dtype) < \
                memory.ladder_sweep_model_s(*shape, floor, dtype)


def test_ladder_tiles_split_benzene_at_an_80gb_budget():
    """At the benchmark's shapes on an 80 GB card (0.85 of it free, less
    the DIIS ring) the floor is one tile for benzene/cc-pVTZ, the dense
    ladder; the work rule splits it, and builds less of W."""
    budget = 64 * 2**30
    bz, w8 = (21, 243, 360), (32, 424, 1112)
    assert memory.plan_ladder_ntile(*bz, budget=budget) == 1
    nt = memory.plan_ladder_tiles(*bz, budget=budget)
    assert nt > 1
    assert memory.ladder_sweep_model_s(*bz, nt) < \
        0.8 * memory.ladder_sweep_model_s(*bz, 1)
    for vjp in (False, True):
        assert memory.plan_ladder_tiles(*w8, budget=budget, vjp=vjp) >= \
            memory.plan_ladder_ntile(*w8, budget=budget, vjp=vjp)


def test_plan_solver_plans_by_work_and_an_explicit_ntile_wins():
    from pyscf_mpcc_tpu_torch.examples import campaign as cp
    nocc, nvir, naux = 21, 243, 360
    n = nocc * nvir + (nocc * nvir) ** 2
    f32, budget = torch.float32, 64 * 2**30
    for vjp in (False, True):
        kw = cp.plan_solver(n, nocc, nvir, naux, f32, budget, vjp=vjp)
        edt = kw["diis_err_dtype"] or f32
        ring = kw["diis_space"] * n * (f32.itemsize + edt.itemsize)
        assert kw["ntile"] == memory.plan_ladder_tiles(
            nocc, nvir, naux, f32, budget=budget - ring, vjp=vjp) > 1
        assert cp.plan_solver(n, nocc, nvir, naux, f32, budget, vjp=vjp,
                              ntile=1)["ntile"] == 1
    assert cp.plan_solver(n, nocc, nvir, naux, f32, None)["ntile"] == 1


def test_streamed_campaign_keeps_its_own_ntile(monkeypatch):
    """The streamed Lvv ladder fetches more host bytes as ntile grows, so
    its campaign passes its own count, which the work rule leaves."""
    from pyscf_mpcc_tpu_torch.examples import w8aug_stream_certify as w8aug
    for k in ("W8AUG_NTILE", "W8AUG_DIIS_SPACE", "W8AUG_DIIS_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    nocc, nvir, naux = 32, 424, 1112
    n = nocc * nvir + (nocc * nvir) ** 2
    for lam in (False, True):
        kw = w8aug._solver(n, nocc, nvir, naux, torch.float32, 64 * 2**30,
                           lam=lam)
        assert kw["ntile"] == w8aug.NTILE
    assert memory.plan_ladder_tiles(nocc, nvir, naux,
                                    budget=64 * 2**30) != w8aug.NTILE
