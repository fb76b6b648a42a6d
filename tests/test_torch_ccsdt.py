"""The port's DF T3 engines (cc.ccsdt_act, cc.ccsdt_env) and the coupled
UMPCC driver (mpcc.umpccsd.kernel_pert_df) against the JAX package.

Inputs: the O2 triplet/sto-3g UHF of tests/_torch_uinputs (nelec (9, 7),
nmo 10), its exact-Cholesky full-MO 3-center factors B and one-electron
integrals h (the setup of tests/test_ccsdt_act.py), seeded random t1 and
t2, and the active space of that test, ([7, 8], [5, 6]) holes and
([0], [0, 1]) particles: every canonical t3 signature has a block.  The
JAX references are computed once (module fixture) by the JAX package's
own functions, jitted there to keep the fixture short (its dress_df,
t3_residual_act and feedback_act wrapped in jax.jit, the same functions).
The spin-orbital oracle is not run: the JAX package's tests hold these
engines to it.

Tolerance: 1e-10 on every t3 block, amplitude and energy, fp64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.cc import ccsdt_act as ja
from pyscf_mpcc_tpu.cc import ccsdt_env as je
from pyscf_mpcc_tpu.cc import uccsd as ju
from pyscf_mpcc_tpu.cc.spinsum import ST as JST
from pyscf_mpcc_tpu.cc.spinsum import t2_st as jt2_st
from pyscf_mpcc_tpu.mpcc import umpccsd as jum
from pyscf_mpcc_tpu_torch import convert
from pyscf_mpcc_tpu_torch.cc import ccsdt_act, ccsdt_env, uccsd
from pyscf_mpcc_tpu_torch.cc.spinsum import t2_st
from pyscf_mpcc_tpu_torch.mpcc import umpccsd

from _torch_uinputs import (cholesky, fields, mean_field, np_tuple,
                             uhf_arrays)

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-10
AH, AP = ([7, 8], [5, 6]), ([0], [0, 1])
# MPCCSD(4,2)-style freeze: doubles relax on the all-active block only
FREEZE = dict(idx_s=[], idx_d=list(range(15)))
PERT = dict(model="ccsdt-3", conv_tol=1e-10, conv_tol_normt=1e-8)
# (model, env_amplitudes, seeded with an active t3)
ENV_CASES = (("ccsdt-1", True, False), ("ccsdt-3", False, True))


def _st_fn(f, *static):
    """jax.jit of f(t2: ST, t3: ST | None, ...) over the blocks' dicts."""
    @jax.jit
    def g(t2b, t3b, arrs):
        return f(JST(t2b), None if t3b is None else JST(t3b), arrs,
                 *static).b
    return lambda t2, t3, arrs: JST(g(t2.b, None if t3 is None else t3.b,
                                      arrs))


def _jitted(monkeypatch):
    """Route the JAX package's ccsdt_act entry points through jax.jit (the
    same functions; eager JAX takes minutes on these graphs).  One
    compiled function per active space, model and driving mode."""
    cache = {}
    resid, fb = ja.t3_residual_act, ja.feedback_act

    def space(dd):
        return (dd.nocc, dd.nmo, tuple(map(tuple, dd.act_hole)),
                tuple(map(tuple, dd.act_particle)))

    def residual(t2, t3, dd, arrs, model="ccsdt", driving="full"):
        key = ("r", space(dd), model, driving, t3 is None)
        if key not in cache:
            cache[key] = _st_fn(lambda a, b, c: resid(a, b, dd, c, model,
                                                      driving))
        return cache[key](t2, t3, arrs)

    def feedback(t3, dd, arrs):
        key = ("f", space(dd))
        if key not in cache:
            cache[key] = jax.jit(lambda b, c: fb(JST(b), dd, c))
        return cache[key](t3.b, arrs)

    dress = jax.jit(ja.dress_df, static_argnums=3)
    for mod in (ja, je):
        monkeypatch.setattr(mod, "t3_residual_act", residual)
        monkeypatch.setattr(mod, "feedback_act", feedback)
    monkeypatch.setattr(ja, "dress_df", lambda B, h, t1, nocc: dress(
        tuple(jnp.asarray(x) for x in B), tuple(jnp.asarray(x) for x in h),
        tuple(jnp.asarray(x) for x in t1), tuple(nocc)))


def _canon_np(c):
    return {k: np.asarray(v) for k, v in c.items()}


@pytest.fixture(scope="module")
def ref():
    mf = mean_field("o2")
    mo_a, mo_b, fa, fb, na, nb = uhf_arrays(mf)
    eri = jgto.intor_eri(mf.mol)
    b_ao = cholesky(eri)
    B = tuple(np.einsum("Lmn,mp,nq->Lpq", b_ao, c, c, optimize=True)
              for c in (mo_a, mo_b))
    hc = np.asarray(mf.get_hcore())
    h = tuple(c.T @ hc @ c for c in (mo_a, mo_b))
    nocc, nmo = (na, nb), (mo_a.shape[1], mo_b.shape[1])
    mo_e = tuple(np.asarray(e) for e in mf.mo_energy)
    jer = ju.make_eris_incore(eri, mo_a, mo_b, fa, fb, na, nb)
    # the fixed (t1, t2): converged UCCSD amplitudes (the port's solver,
    # held to the JAX package's in tests/test_torch_uccsd.py)
    conv, _, t1, t2 = uccsd.kernel(convert.ueris_from_numpy(fields(jer),
                                                            CPU),
                                   conv_tol=1e-11, conv_tol_normt=1e-9)
    assert conv
    t1, t2 = (tuple(convert.to_numpy(x) for x in t) for t in (t1, t2))
    rng = np.random.default_rng(11)
    t3_rand = {}
    for sig in ja.T3_CANONICAL:
        sp = ["ab".index(c) for c in sig]
        t3_rand[sig] = 0.01 * rng.standard_normal(
            tuple(len(AH[s]) for s in sp[:3])
            + tuple(len(AP[s]) for s in sp[3:]))
    out = dict(B=B, h=h, nocc=nocc, nmo=nmo, mo_e=mo_e, t1=t1, t2=t2,
               t3=t3_rand, fields=fields(jer))
    with pytest.MonkeyPatch.context() as mp:
        _jitted(mp)
        dd = ja.DressedDF(nocc, nmo, AH, AP)
        arrs = ja.dress_df(B, h, t1, nocc)
        out["arrs"] = {k: np.asarray(v) for k, v in arrs.items()}
        T2 = jt2_st(tuple(jnp.asarray(x) for x in t2))
        T3 = ja.expand_t3({k: jnp.asarray(v) for k, v in t3_rand.items()})
        # the driving terms and each model's couplings; ccsdt-3's as the
        # whole residual less the driving terms (the calls kernel_pert_df
        # makes, so that their compiles are shared)
        out["drive"] = {d: _canon_np(ja.reduce_t3(ja.t3_residual_act(
            T2, None, dd, arrs, driving=d))) for d in ("full", "linear")}
        full = _canon_np(ja.reduce_t3(ja.t3_residual_act(
            T2, T3, dd, arrs, model="ccsdt-3")))
        out["couple"] = {m: _canon_np(ja.reduce_t3(ja.t3_residual_act(
            T2, T3, dd, arrs, model=m, driving="none")))
            for m in ("ccsdt", "ccsdt-1")}
        out["couple"]["ccsdt-3"] = {k: v - out["drive"]["full"][k]
                                    for k, v in full.items()}
        out["feedback"] = np_tuple(
            x for pair in ja.feedback_act(T3, dd, arrs) for x in pair)
        canon, conv = ja.solve_t3_act(t2, dd, arrs, mo_e, conv_tol=1e-11)
        assert conv
        out["solve"] = _canon_np(canon)
        conv, e, jt1, jt2, jt3 = jum.kernel_pert_df(jer, B, h, AH, AP,
                                                    **FREEZE, **PERT)
        assert conv
        out["pert"] = (e, np_tuple(jt1), np_tuple(jt2), _canon_np(jt3))
        # unseeded with the inactive-amplitude pairing; seeded
        out["env"] = {}
        for model, amp, seed in ENV_CASES:
            e, t3e, conv = je.kernel(
                B, h, t1, t2, nocc, AH, AP, mo_e, model=model,
                env_amplitudes=amp,
                t3_act=t3_rand if seed else None)
            assert conv
            out["env"][model] = (e, _canon_np(t3e))
    return out


@pytest.fixture(scope="module")
def port(ref):
    """The same inputs as tensors, and the port's dressed arrays."""
    t = dict(B=convert.tensors_from_numpy(*ref["B"], device=CPU),
             h=convert.tensors_from_numpy(*ref["h"], device=CPU),
             t1=convert.tensors_from_numpy(*ref["t1"], device=CPU),
             t2=convert.tensors_from_numpy(*ref["t2"], device=CPU),
             t3=convert.t3_from_numpy(ref["t3"], CPU))
    t["dd"] = ccsdt_act.DressedDF(ref["nocc"], ref["nmo"], AH, AP,
                                  device=CPU)
    t["arrs"] = ccsdt_act.dress_df(t["B"], t["h"], t["t1"], ref["nocc"])
    t["eris"] = convert.ueris_from_numpy(ref["fields"], CPU)
    return t


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=0, atol=tol)


def _close_canon(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], tol)


def test_dress_df_matches_jax(ref, port):
    assert sorted(port["arrs"]) == sorted(ref["arrs"])
    for k, v in ref["arrs"].items():
        assert port["arrs"][k].dtype == torch.float64
        _close(port["arrs"][k], v)


@pytest.mark.parametrize("driving", ["full", "linear", "none"])
@pytest.mark.parametrize("model", ["ccsdt", "ccsdt-3", "ccsdt-1"])
def test_t3_residual_matches_jax(ref, port, model, driving):
    """Each (model, driving) residual against JAX's driving terms of that
    mode plus JAX's couplings of that model (the residual is their sum)."""
    got = ccsdt_act.reduce_t3(ccsdt_act.t3_residual_act(
        t2_st(port["t2"]), ccsdt_act.expand_t3(port["t3"]), port["dd"],
        port["arrs"], model=model, driving=driving))
    want = {k: v + (ref["drive"][driving][k] if driving != "none" else 0.0)
            for k, v in ref["couple"][model].items()}
    _close_canon(got, want)


def test_t3_residual_rejects_unknown_model(port):
    with pytest.raises(ValueError, match="model"):
        ccsdt_act.t3_residual_act(t2_st(port["t2"]), None, port["dd"],
                                  port["arrs"], model="ccsdtq")


def test_feedback_matches_jax(ref, port):
    (r1a, r1b), (r2aa, r2ab, r2bb) = ccsdt_act.feedback_act(
        ccsdt_act.expand_t3(port["t3"]), port["dd"], port["arrs"])
    for g, w in zip((r1a, r1b, r2aa, r2ab, r2bb), ref["feedback"]):
        _close(g, w)


def test_expand_reduce_roundtrip(port):
    x = ccsdt_act.expand_t3(port["t3"])
    assert len(x.keys()) == 20
    for k, v in ccsdt_act.reduce_t3(x).items():
        assert torch.equal(v, port["t3"][k])


def test_solve_t3_act_matches_jax(ref, port):
    canon, conv = ccsdt_act.solve_t3_act(port["t2"], port["dd"],
                                         port["arrs"], ref["mo_e"],
                                         conv_tol=1e-11)
    assert conv
    _close_canon(canon, ref["solve"])


def test_kernel_pert_df_matches_jax(ref, port):
    e_j, t1_j, t2_j, t3_j = ref["pert"]
    eris = port["eris"]
    conv, e, t1, t2, t3 = umpccsd.kernel_pert_df(
        eris, ref["B"], ref["h"], AH, AP, **FREEZE, **PERT)
    assert conv and abs(e - e_j) < TOL
    for g, w in zip((*t1, *t2), (*t1_j, *t2_j)):
        _close(g, w)
    _close_canon(t3, t3_j)
    # the frozen doubles are the bath's (the MP2 guess) bit for bit
    _, _, bath = uccsd.init_amps(eris)
    nvir = tuple(n - o for n, o in zip(ref["nmo"], ref["nocc"]))
    m = umpccsd.frozen_masks_u(AH, AP, ref["nocc"], nvir, ([], []),
                               [FREEZE["idx_d"]] * 3, device=CPU)
    for g, b, mm in zip(t2, bath, m[2:]):
        assert mm.any() and torch.equal(g[mm], b[mm])


@pytest.mark.parametrize("case", ENV_CASES, ids=lambda c: c[0])
def test_ccsdt_env_kernel_matches_jax(ref, case):
    model, amp, seed = case
    e_j, t3_j = ref["env"][model]
    e, t3, conv = ccsdt_env.kernel(
        ref["B"], ref["h"], ref["t1"], ref["t2"], ref["nocc"], AH, AP,
        ref["mo_e"], model=model, env_amplitudes=amp,
        t3_act=ref["t3"] if seed else None, device=CPU)
    assert conv and abs(e - e_j) < TOL
    _close_canon(t3, t3_j)


def test_solve_t3_env_and_energy_match_jax(ref, port):
    """The seeded solve and its energy, called one by one: the active slot
    holds the seed, and the energy pairs only the environment."""
    e_j, t3_j = ref["env"]["ccsdt-3"]
    t3, conv = ccsdt_env.solve_t3_env(
        port["t2"], ref["nocc"], ref["nmo"], AH, AP, port["arrs"],
        ref["mo_e"], model="ccsdt-3", t3_act=ref["t3"])
    assert conv
    _close_canon(t3, t3_j)
    e = ccsdt_env.env_energy(t3, ref["nocc"], ref["nmo"], AH, AP,
                             port["arrs"], port["t1"], port["t2"])
    assert abs(e - e_j) < TOL
    # the seed's slot, through the DIIS extrapolation (tests/test_ccsdt_env.py
    # bound)
    masks = ccsdt_env.env_masks(ref["nocc"], ref["nmo"], AH, AP)
    for k in ccsdt_act.T3_CANONICAL:
        active = convert.to_numpy(t3[k])[~masks[k]]
        np.testing.assert_allclose(active, ref["t3"][k].ravel(), rtol=0,
                                   atol=1e-12)


def test_env_masks_match_jax(ref):
    got = ccsdt_env.env_masks(ref["nocc"], ref["nmo"], AH, AP)
    want = je.env_masks(ref["nocc"], ref["nmo"], AH, AP)
    for k in ja.T3_CANONICAL:
        np.testing.assert_array_equal(got[k], want[k])


def test_t3_from_numpy_rejects_unknown_signature(ref):
    with pytest.raises(ValueError, match="signatures"):
        convert.t3_from_numpy({"aaabbb": ref["t3"]["aaaaaa"]}, CPU)


def test_ccsdt_env_kernel_defaults_to_cuda(ref):
    call = lambda: ccsdt_env.kernel(  # noqa: E731
        ref["B"], ref["h"], ref["t1"], ref["t2"], ref["nocc"], AH, AP,
        ref["mo_e"], max_cycle=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the solve would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
