"""The port's MP-CC solvers (pyscf_mpcc_tpu_torch.mpcc.rmpccsd, .lowlevel)
against the JAX package and its pins.

Inputs: the H2O/cc-pVDZ RHF of the JAX package's cached fixture, its
incore MO integrals (JAX's make_eris_incore, handed to the port as numpy),
exact-Cholesky DF factors of the AO integrals (tests/test_lowlevel.py),
the frozen-block masks of masks.frozen_masks, and seeded random
amplitudes.  The JAX references are computed once (module fixture).
Tolerances: one update in fp64, 1e-10; converged energies against the
JAX package's pins (tests/test_mpcc.py:14-15, tests/test_lowlevel.py:10)
at its own bounds; the frozen blocks of a converged solve against the
bath (and against JAX's solve) 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu.cc import eris as jeris_mod
from pyscf_mpcc_tpu.mpcc import lowlevel as jlowlevel
from pyscf_mpcc_tpu.mpcc import rmpccsd as jrmpccsd
from pyscf_mpcc_tpu.mpcc.masks import frozen_masks
from pyscf_mpcc_tpu.testutil import h2o_ccpvdz
from pyscf_mpcc_tpu_torch import convert
from pyscf_mpcc_tpu_torch.cc import rccsd
from pyscf_mpcc_tpu_torch.mpcc import lowlevel, rmpccsd

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-10, 1e-13
NOCC = 5
E_MP2 = -0.2040199672883385
E_CCSD = -0.2133432312951
E_LL = -0.20549941032564464
# MPCCSD(4,2)-style space of tests/test_mpcc.py: doubles frozen unless all
# four indices are active
ACT = dict(act_hole=[2, 3, 4], act_particle=[0, 1, 2, 3], idx_s=[],
           idx_d=list(range(15)))
TIGHT = dict(conv_tol=1e-10, conv_tol_normt=1e-8, max_cycle=100)


def _factors(d):
    nao = d["eri_ao"].shape[0]
    w, v = np.linalg.eigh(d["eri_ao"].reshape(nao * nao, nao * nao))
    keep = w > 1e-12
    B = (v[:, keep] * np.sqrt(w[keep])).T.reshape(-1, nao, nao)
    mo = d["mo_coeff"]
    L = np.einsum("Lpq,pi,qj->Lij", B, mo, mo, optimize=True)
    return (L[:, :NOCC, :NOCC], L[:, :NOCC, NOCC:], L[:, NOCC:, NOCC:],
            mo.T @ d["fock_ao"] @ mo)


@pytest.fixture(scope="module")
def ref():
    d = h2o_ccpvdz()
    jer = jeris_mod.make_eris_incore(d["eri_ao"], d["mo_coeff"],
                                     d["fock_ao"], NOCC)
    fields = {k: None if v is None else np.asarray(v)
              for k, v in jer._asdict().items()}
    nvir = jer.nvir
    rng = np.random.default_rng(5)
    t1 = rng.standard_normal((NOCC, nvir)) * 0.02
    t2 = rng.standard_normal((NOCC, NOCC, nvir, nvir)) * 0.02
    t2 = t2 + t2.transpose(1, 0, 3, 2)
    m1, m2 = frozen_masks(ACT["act_hole"], ACT["act_particle"], NOCC, nvir,
                          [0, 2], ACT["idx_d"])
    upd = {mode: tuple(np.asarray(x) for x in jrmpccsd.update_amps_masked(
        jnp.asarray(t1), jnp.asarray(t2), jer, jnp.asarray(m1),
        jnp.asarray(m2), bath_update=mode)) for mode in ("freeze", "mp2")}
    conv, e, jt1, jt2 = jrmpccsd.kernel(jer, **ACT, **TIGHT)
    assert conv
    Loo, Lov, Lvv, fock = _factors(d)
    # a non-canonical Fock: the reference's diagonal plus a small
    # symmetric perturbation of the off-diagonal blocks
    pert = rng.standard_normal(fock.shape) * 1e-3
    fock_nc = fock + pert + pert.T
    eo, ev = np.diag(fock_nc)[:NOCC], np.diag(fock_nc)[NOCC:]
    ll_in = (t1, Loo, Lov, Lvv, fock_nc[:NOCC, :NOCC] - np.diag(eo),
             fock_nc[NOCC:, NOCC:] - np.diag(ev), ev[None, :] - eo[:, None])
    ll = tuple(np.asarray(x) for x in jlowlevel.update_amps(
        *(jnp.asarray(x) for x in ll_in)))
    return dict(fields=fields, t=(t1, t2), masks=(m1, m2), upd=upd,
                solve=(e, np.asarray(jt1), np.asarray(jt2)),
                factors=(Loo, Lov, Lvv, fock), ll_in=ll_in, ll=ll)


@pytest.fixture(scope="module")
def eris(ref):
    return convert.eris_from_numpy(ref["fields"], CPU)


@pytest.mark.parametrize("mode", ["freeze", "mp2"])
def test_update_amps_masked_matches_jax(ref, eris, mode):
    t1, t2, m1, m2 = convert.tensors_from_numpy(*ref["t"], *ref["masks"],
                                                device=CPU)
    assert m1.dtype == m2.dtype == torch.bool
    got = rmpccsd.update_amps_masked(t1, t2, eris, m1, m2, bath_update=mode)
    for g, w in zip(got, ref["upd"][mode]):
        np.testing.assert_allclose(convert.to_numpy(g), w, rtol=RTOL,
                                   atol=ATOL)
    # the frozen blocks: the incoming amplitudes ('freeze'); zero t1
    # ('mp2')
    fro1 = convert.to_numpy(got[0])[ref["masks"][0]]
    want1 = ref["t"][0][ref["masks"][0]] if mode == "freeze" else 0.0
    np.testing.assert_array_equal(fro1, want1)


def test_update_amps_masked_rejects_unknown_mode(ref, eris):
    t1, t2, m1, m2 = convert.tensors_from_numpy(*ref["t"], *ref["masks"],
                                                device=CPU)
    with pytest.raises(ValueError, match="bath_update"):
        rmpccsd.update_amps_masked(t1, t2, eris, m1, m2, bath_update="cc")


@pytest.mark.parametrize("ring", ["host", "device"])
@pytest.mark.parametrize("bath", ["freeze", "mp2"])
def test_kernel_limits(eris, ring, bath):
    """Every block frozen: the bath's MP2 energy; nothing frozen: CCSD
    (tests/test_mpcc.py's pins and bounds)."""
    conv, e, *_ = rmpccsd.kernel(eris, [0], [0], list(range(4)),
                                 list(range(16)), bath_update=bath,
                                 diis_backend=ring, **TIGHT)
    assert conv and abs(e - E_MP2) < (1e-9 if bath == "freeze" else 1e-8)
    conv, e, *_ = rmpccsd.kernel(eris, [0], [0], [], [], bath_update=bath,
                                 diis_backend=ring, **TIGHT)
    assert conv and abs(e - E_CCSD) < 1e-7


@pytest.mark.parametrize("ring", ["host", "device"])
def test_partial_freeze_matches_jax(ref, eris, ring):
    e_j, t1_j, t2_j = ref["solve"]
    conv, e, t1, t2 = rmpccsd.kernel(eris, **ACT, diis_backend=ring,
                                     **TIGHT)
    assert conv and E_CCSD - 1e-9 < e < E_MP2 + 1e-9
    assert abs(e - e_j) < 1e-9
    _, t1_0, t2_0 = rccsd.init_amps(eris)
    m1, m2 = frozen_masks(ACT["act_hole"], ACT["act_particle"], NOCC,
                          eris.nvir, ACT["idx_s"], ACT["idx_d"])
    t2n, t2b = convert.to_numpy(t2), convert.to_numpy(t2_0)
    np.testing.assert_allclose(t2n[m2], t2b[m2], rtol=0, atol=1e-12)
    np.testing.assert_allclose(t2n[m2], t2_j[m2], rtol=0, atol=1e-12)
    # the relaxed block moved off the bath
    assert np.abs(t2n[~m2] - t2b[~m2]).max() > 1e-6


def test_partial_freeze_mp2_bath_between(eris):
    conv, e, *_ = rmpccsd.kernel(eris, **ACT, bath_update="mp2", **TIGHT)
    assert conv and E_CCSD - 1e-9 < e < E_MP2 + 1e-9


def test_kernel_rejects_unknown_ring(eris):
    with pytest.raises(ValueError, match="diis_backend"):
        rmpccsd.kernel(eris, **ACT, diis_backend="gpu")


def test_lowlevel_update_matches_jax(ref):
    got = lowlevel.update_amps(*convert.tensors_from_numpy(*ref["ll_in"],
                                                           device=CPU))
    for g, w in zip(got, ref["ll"]):
        np.testing.assert_allclose(convert.to_numpy(g), w, rtol=RTOL,
                                   atol=ATOL)


def test_lowlevel_zeroth_iteration_is_mp2(ref):
    Loo, Lov, Lvv, fock = ref["factors"]
    eo, ev = np.diag(fock)[:NOCC], np.diag(fock)[NOCC:]
    nvir = len(ev)
    args = convert.tensors_from_numpy(
        np.zeros((NOCC, nvir)), Loo, Lov, Lvv, np.zeros((NOCC, NOCC)),
        np.zeros((nvir, nvir)), ev[None, :] - eo[:, None], device=CPU)
    _, t2, de, _ = lowlevel.update_amps(*args)
    assert t2.shape == (nvir, NOCC, nvir, NOCC)
    assert abs(float(de) - E_MP2) < 1e-10


def test_lowlevel_kernel_pin(ref):
    Loo, Lov, Lvv, fock = ref["factors"]
    tensors = convert.tensors_from_numpy(Loo, Lov, Lvv, device=CPU)
    conv, e, t1, t2 = lowlevel.kernel(*tensors, fock, NOCC, conv_tol=1e-9)
    assert conv and t1.dtype == torch.float64
    assert abs(e - E_LL) < 1e-8 and e < E_MP2
