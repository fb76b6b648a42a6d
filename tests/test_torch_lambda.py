"""The port's Lambda / Lagrangian / RDM layer (pyscf_mpcc_tpu_torch.cc
.lambda_ad, and rccsd.residual_segments) against the JAX package.

Both packages get the same numpy inputs: the synthetic DF fields of
tests/test_torch_rccsd.py (NOCC, NVIR, NAUX = 4, 11, 30) in the 'df',
'df_direct' and 'vvvv' forms, and H2O/cc-pVDZ (incore) for the converged
multipliers and the RDMs.  Each JAX reference is computed once (module
fixtures).  fp64 throughout; tolerances:

- each residual segment: rtol 1e-10 (the same contractions);
- residual, the Lambda step (with masks; ntile=3 pads nvir=11 to 12):
  1e-10 of the scale, as tests/test_lambda_seg.py;
- Lagrangian energy: 1e-10;
- converged multipliers: 1e-8 host and device ring, 1e-7 with the bf16
  error ring (its path differs; tests/test_lambda_rdm.py);
- RDMs: 1e-9, and the identities tr(rdm1) = N, h.rdm1 + 1/2 g.rdm2 +
  E_nuc = E_tot and natural occupations in [0, 2], each to 1e-9 / 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import ao2mo as jao2mo
from pyscf_mpcc_tpu.cc import eris as jeris_mod
from pyscf_mpcc_tpu.cc import lambda_ad as jlam
from pyscf_mpcc_tpu.cc import rccsd as jrccsd
from pyscf_mpcc_tpu.cc.eris import RERIs as JRERIs
from pyscf_mpcc_tpu.testutil import h2o_ccpvdz
from pyscf_mpcc_tpu_torch import convert
from pyscf_mpcc_tpu_torch.cc import lambda_ad as tlam
from pyscf_mpcc_tpu_torch.cc import rccsd as trccsd
from test_torch_rccsd import NOCC, NVIR, _amps, _fields

torch.set_num_threads(1)

CPU = torch.device("cpu")
SEG_CASES = [("df", 1), ("df", 3), ("df_direct", 3), ("vvvv", 1)]
STEP_CASES = [("df", 3, False), ("df", 3, True), ("df_direct", 3, False),
              ("vvvv", 1, True)]


def _mults():
    t1, t2 = _amps()
    rng = np.random.default_rng(3)
    l1 = t1 + 0.01 * rng.standard_normal(t1.shape)
    l2 = t2 + 0.01 * rng.standard_normal(t2.shape)
    return l1, 0.5 * (l2 + l2.transpose(1, 0, 3, 2))


def _masks():
    m1 = np.zeros((NOCC, NVIR), bool)
    m1[:2] = True
    m2 = np.zeros((NOCC, NOCC, NVIR, NVIR), bool)
    m2[:2, :2] = True
    return m1, m2


def _jax_eris(f):
    return JRERIs(**{k: None if v is None else jnp.asarray(v)
                     for k, v in f.items()})


def _np(x):
    return convert.to_numpy(x) if torch.is_tensor(x) else np.asarray(x)


def _close_scaled(a, b, tol=1e-10):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() / (np.abs(b).max() + 1.0) < tol


@pytest.fixture(scope="module")
def jax_small():
    """JAX segments, residual, Lambda step and Lagrangian energy on the
    synthetic fields, once."""
    t1, t2 = (jnp.asarray(x) for x in _amps())
    l1, l2 = (jnp.asarray(x) for x in _mults())
    m1, m2 = (jnp.asarray(x) for x in _masks())
    out = {}
    for form, ntile in SEG_CASES:
        je = _jax_eris(_fields(form))
        out["seg", form, ntile] = [
            (fn.__name__, kind, np.asarray(fn(t1, t2)))
            for fn, kind in jrccsd.residual_segments(je, ntile=ntile)]
        out["lag", form, ntile] = float(jlam.lagrangian_energy(
            t1, t2, l1, l2, je, ntile=ntile))
    for form, ntile, masked in STEP_CASES:
        je = _jax_eris(_fields(form))
        mk = dict(m1=m1, m2=m2) if masked else {}
        out["res", form, ntile, masked] = [np.asarray(x) for x in
                                           jlam.residual(t1, t2, je, ntile,
                                                         **mk)]
        step = jlam._lambda_step(jnp.array(l1), jnp.array(l2), t1, t2, je,
                                 ntile=ntile, **mk)
        out["step", form, ntile, masked] = [np.asarray(x) for x in step]
    return out


def _inputs(form):
    te = convert.eris_from_numpy(_fields(form), CPU)
    t1, t2 = convert.amps_from_numpy(*_amps(), CPU)
    l1, l2 = convert.amps_from_numpy(*_mults(), CPU)
    return te, t1, t2, l1, l2


@pytest.mark.parametrize("form,ntile", SEG_CASES)
def test_residual_segments_match_jax(jax_small, form, ntile):
    te, t1, t2, _, _ = _inputs(form)
    ref = jax_small["seg", form, ntile]
    segs = trccsd.residual_segments(te, ntile=ntile)
    assert [(fn.__name__, kind) for fn, kind in segs] == \
        [(name, kind) for name, kind, _ in ref]
    for (fn, _), (name, _, r) in zip(segs, ref):
        np.testing.assert_allclose(_np(fn(t1, t2)), r, rtol=1e-10,
                                   atol=1e-10 * np.abs(r).max(),
                                   err_msg=name)
    # the pieces plus the constant and diagonal ones are the residual
    r1a, r2a = tlam.residual(t1, t2, te, ntile=ntile)
    r1b, r2b = trccsd.residual_from_segments(t1, t2, te, ntile=ntile)
    _close_scaled(r1b, r1a, 1e-11)
    _close_scaled(r2b, r2a, 1e-11)


@pytest.mark.parametrize("form,ntile,masked", STEP_CASES)
def test_residual_and_lambda_step_match_jax(jax_small, form, ntile, masked):
    te, t1, t2, l1, l2 = _inputs(form)
    mk = ({} if not masked else
          dict(zip(("m1", "m2"), (torch.from_numpy(m) for m in _masks()))))
    for a, b in zip(tlam.residual(t1, t2, te, ntile, **mk),
                    jax_small["res", form, ntile, masked]):
        _close_scaled(a, b)
    step = tlam._lambda_step(l1, l2, t1, t2, te, ntile=ntile, **mk)
    ref = jax_small["step", form, ntile, masked]
    for a, b in zip(step, ref):
        _close_scaled(a, b)
    # the inputs are not consumed (the JAX step donates its l buffers)
    assert np.array_equal(_np(l1), _mults()[0])
    if masked:
        m1, m2 = _masks()
        assert not _np(step[2])[m1].any() and not _np(step[3])[m2].any()


@pytest.mark.parametrize("form,ntile", SEG_CASES)
def test_lagrangian_energy_matches_jax(jax_small, form, ntile):
    te, t1, t2, l1, l2 = _inputs(form)
    e = tlam.lagrangian_energy(t1, t2, l1, l2, te, ntile=ntile)
    assert abs(float(e) - jax_small["lag", form, ntile]) < 1e-10
    with pytest.raises(NotImplementedError, match="rule 3"):
        tlam.lagrangian_energy(t1, t2, l1, l2, te, ladder_backend="ozaki")


# ---------------------------------------------------------------- H2O
# name: (diis_backend, error-ring dtype, tolerance on the multipliers)
BACKENDS = {"host": ("host", None, 1e-8),
            "device": ("device", None, 1e-8),
            "device_bf16": ("device", "bfloat16", 1e-7)}


@pytest.fixture(scope="module")
def h2o():
    """H2O/cc-pVDZ incore: converged amplitudes, the JAX multipliers of
    each DIIS backend and the JAX RDMs, once."""
    d = h2o_ccpvdz()
    je = jeris_mod.make_eris_incore(d["eri_ao"], d["mo_coeff"], d["fock_ao"],
                                    5)
    conv, e_corr, t1, t2 = jrccsd.kernel(je, conv_tol=1e-12,
                                         conv_tol_normt=1e-10, max_cycle=200)
    assert conv
    lam = {}
    for name, (backend, edt, _) in BACKENDS.items():
        c, l1, l2 = jlam.kernel(t1, t2, je, conv_tol=1e-9, max_cycle=80,
                                diis_backend=backend,
                                diis_err_dtype=edt and getattr(jnp, edt))
        assert c
        lam[name] = (np.asarray(l1), np.asarray(l2))
    mo = d["mo_coeff"]
    h_mo = mo.T @ d["hcore"] @ mo
    eri_mo = np.asarray(jao2mo.full(jnp.asarray(d["eri_ao"]),
                                    jnp.asarray(mo)))
    l1, l2 = (jnp.asarray(x) for x in lam["host"])
    rdm1, rdm2 = jlam.make_rdm12(jnp.asarray(h_mo), jnp.asarray(eri_mo),
                                 t1, t2, l1, l2, 5)
    fields = {k: None if v is None else np.asarray(v)
              for k, v in je._asdict().items()}
    return dict(d=d, fields=fields, e_corr=float(e_corr),
                t=(np.asarray(t1), np.asarray(t2)), lam=lam, h_mo=h_mo,
                eri_mo=eri_mo, rdm=(np.asarray(rdm1), np.asarray(rdm2)))


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_converged_multipliers_match_jax(h2o, backend):
    te = convert.eris_from_numpy(h2o["fields"], CPU)
    t1, t2 = convert.amps_from_numpy(*h2o["t"], CPU)
    diis_backend, edt, tol = BACKENDS[backend]
    conv, l1, l2 = tlam.kernel(t1, t2, te, conv_tol=1e-9, max_cycle=80,
                               diis_backend=diis_backend,
                               diis_err_dtype=edt and getattr(torch, edt))
    assert conv and l2.dtype == torch.float64
    ref1, ref2 = h2o["lam"][backend]
    assert np.abs(_np(l1) - ref1).max() < tol
    assert np.abs(_np(l2) - ref2).max() < tol
    # the multipliers leave t untouched (l defaults to a copy of t)
    assert np.array_equal(_np(t2), h2o["t"][1])


def test_make_rdm12_matches_jax_and_identities(h2o):
    d = h2o["d"]
    t1, t2 = convert.amps_from_numpy(*h2o["t"], CPU)
    l1, l2 = convert.amps_from_numpy(*h2o["lam"]["host"], CPU)
    h_mo = torch.tensor(h2o["h_mo"])
    eri_mo = torch.tensor(h2o["eri_mo"])
    rdm1, rdm2 = tlam.make_rdm12(h_mo, eri_mo, t1, t2, l1, l2, 5)
    assert not rdm1.requires_grad and not rdm2.requires_grad
    np.testing.assert_allclose(_np(rdm1), h2o["rdm"][0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(rdm2), h2o["rdm"][1], rtol=0, atol=1e-9)
    assert abs(float(torch.trace(rdm1)) - 10.0) < 1e-9
    e = float(torch.einsum("pq,pq->", h_mo, rdm1)
              + 0.5 * torch.einsum("pqrs,pqrs->", eri_mo, rdm2)) \
        + float(d["e_nuc"])
    assert abs(e - (float(d["e_tot"]) + h2o["e_corr"])) < 1e-9
    w = np.linalg.eigvalsh(_np(rdm1))
    assert w.min() > -1e-8 and w.max() < 2.0 + 1e-8


def test_lambda_resumes_from_diis_file(h2o, tmp_path):
    # a Lambda solve cut after 4 cycles resumes from its spilled host ring
    te = convert.eris_from_numpy(h2o["fields"], CPU)
    t1, t2 = convert.amps_from_numpy(*h2o["t"], CPU)
    path = str(tmp_path / "lambda_diis.npz")
    conv, _, _ = tlam.kernel(t1, t2, te, conv_tol=1e-9, max_cycle=4,
                             diis_file=path)
    assert not conv
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    conv, l1, l2 = tlam.kernel(t1, t2, te, conv_tol=1e-9, max_cycle=80,
                               adiis=DIIS.restore(path))
    assert conv
    assert np.abs(_np(l2) - h2o["lam"]["host"][1]).max() < 1e-8
