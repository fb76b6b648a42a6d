"""The port's unrestricted Λ, Lagrangian energy and response RDMs
(cc/lambda_ad: _lambda_step_u, kernel_u, residual_u,
lagrangian_energy_u, make_rdm12_u) against the JAX package, in fp64 on
the CPU.

Inputs: O2 triplet/sto-3g UHF (incore UERIs and exact-Cholesky DF
UERIs) with the UCCSD amplitudes the JAX package converges, seeded
perturbed multipliers and seeded frozen-block masks; OH/cc-pVDZ (the
JAX package's test_lambda_u.py molecule) for the stationarity of the
DF-factorized Lagrangian.  The same numpy arrays go to both packages;
the JAX references are computed once (module fixture).  Tolerances: one
step, the Lagrangian and the RDMs 1e-12 (the same fp64 algebra);
converged multipliers 1e-10 on both rings.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_uinputs import cholesky, mean_field, np_tuple, uhf_arrays
from pyscf_mpcc_tpu import ao2mo as jao2mo
from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.cc import lambda_ad as jl
from pyscf_mpcc_tpu.cc import uccsd as ju
from pyscf_mpcc_tpu_torch import ao2mo
from pyscf_mpcc_tpu_torch.cc import lambda_ad, uccsd

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL, TOL_CONV = 1e-12, 1e-10


def _t(xs):
    return tuple(torch.tensor(np.asarray(x)) for x in xs)


def _j(xs):
    return tuple(jnp.asarray(np.asarray(x)) for x in xs)


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def ref():
    mf = mean_field("o2")
    a = uhf_arrays(mf)
    eri = jgto.intor_eri(mf.mol)
    ers = {"incore": ju.make_eris_incore(eri, *a),
           "chol": ju.make_eris_df(cholesky(eri), *a)}
    c, _, t1, t2 = ju.kernel(ers["incore"], conv_tol=1e-12,
                             conv_tol_normt=1e-10, max_cycle=200)
    assert c
    rng = np.random.default_rng(4)
    l1 = tuple(np.asarray(x) + 0.01 * rng.standard_normal(x.shape)
               for x in t1)
    l2 = np_tuple(t2)
    masks = tuple(rng.random(x.shape) < 0.3 for x in (*t1, *t2))
    out = dict(mf=mf, a=a, eri=eri, t1=np_tuple(t1), t2=np_tuple(t2), l1=l1,
               l2=l2, masks=masks)
    for kind, er in ers.items():
        s = jl._lambda_step_u(_j(l1), _j(l2), t1, t2, er)
        out["step", kind] = np_tuple((*s[0], *s[1], *s[2], *s[3]))
        out["lag", kind] = float(jl.lagrangian_energy_u(t1, t2, _j(l1),
                                                        _j(l2), er))
    s = jl._lambda_step_u(_j(l1), _j(l2), t1, t2, ers["incore"],
                          tuple(jnp.asarray(m) for m in masks))
    out["step_masked"] = np_tuple((*s[0], *s[1], *s[2], *s[3]))
    for ring in ("host", "device"):
        c, m1, m2 = jl.kernel_u(t1, t2, ers["incore"], conv_tol=1e-10,
                                max_cycle=100, diis_backend=ring)
        assert c
        out["kernel", ring] = np_tuple((*m1, *m2))
    m1, m2 = out["kernel", "host"][:2], out["kernel", "host"][2:]
    moa, mob = (np.asarray(x) for x in a[:2])
    h = mf.get_hcore()
    ints = (moa.T @ h @ moa, mob.T @ h @ mob,
            np.asarray(jao2mo.full(jnp.asarray(eri), jnp.asarray(moa))),
            np.asarray(jao2mo.general(jnp.asarray(eri),
                                      (moa, moa, mob, mob))),
            np.asarray(jao2mo.full(jnp.asarray(eri), jnp.asarray(mob))))
    out["ints"] = ints
    d = jl.make_rdm12_u(*map(jnp.asarray, ints), t1, t2, _j(m1), _j(m2),
                        9, 7)
    out["rdm"] = np_tuple((*d[0], *d[1]))
    return out


@pytest.fixture(scope="module")
def port(ref):
    a = ref["a"]
    ers = {"incore": uccsd.make_eris_incore(ref["eri"], *a, device=CPU),
           "chol": uccsd.make_eris_df(cholesky(ref["eri"]), *a, device=CPU)}
    return ers, _t(ref["t1"]), _t(ref["t2"]), _t(ref["l1"]), _t(ref["l2"])


@pytest.mark.parametrize("kind", ["incore", "chol"])
def test_lambda_step_matches_jax(ref, port, kind):
    ers, t1, t2, l1, l2 = port
    s = lambda_ad._lambda_step_u(l1, l2, t1, t2, ers[kind])
    _close((*s[0], *s[1], *s[2], *s[3]), ref["step", kind], TOL)


def test_masked_lambda_step_matches_jax(ref, port):
    ers, t1, t2, l1, l2 = port
    m = tuple(torch.tensor(x) for x in ref["masks"])
    s = lambda_ad._lambda_step_u(l1, l2, t1, t2, ers["incore"], m)
    _close((*s[0], *s[1], *s[2], *s[3]), ref["step_masked"], TOL)
    # frozen blocks keep their incoming multipliers
    for x, mm, y in zip((*s[0], *s[1]), m, (*l1, *l2)):
        assert torch.equal(x[mm], y[mm])


@pytest.mark.parametrize("kind", ["incore", "chol"])
def test_lagrangian_energy_matches_jax(ref, port, kind):
    ers, t1, t2, l1, l2 = port
    e = lambda_ad.lagrangian_energy_u(t1, t2, l1, l2, ers[kind])
    assert e.dim() == 0 and abs(float(e) - ref["lag", kind]) < TOL


@pytest.mark.parametrize("ring", ["host", "device"])
def test_kernel_u_matches_jax(ref, port, ring):
    ers, t1, t2, _, _ = port
    c, l1, l2 = lambda_ad.kernel_u(t1, t2, ers["incore"], conv_tol=1e-10,
                                   max_cycle=100, diis_backend=ring)
    assert c
    _close((*l1, *l2), ref["kernel", ring], TOL_CONV)
    _close((*l1, *l2), ref["kernel", "host"], 1e-8)


def test_rdm12_matches_jax_and_energy_identity(ref, port):
    ers, t1, t2, _, _ = port
    m = _t(ref["kernel", "host"])
    ints = _t(ref["ints"])
    (d1a, d1b), (d2aa, d2ab, d2bb) = lambda_ad.make_rdm12_u(
        *ints, t1, t2, m[:2], m[2:], 9, 7)
    _close((d1a, d1b, d2aa, d2ab, d2bb), ref["rdm"], TOL)
    h_a, h_b, g_aa, g_ab, g_bb = ints
    assert abs(float(d1a.trace()) - 9) < 1e-8
    assert abs(float(d1b.trace()) - 7) < 1e-8
    e_rdm = float((h_a * d1a).sum() + (h_b * d1b).sum()
                  + 0.5 * (g_aa * d2aa).sum() + 0.5 * (g_bb * d2bb).sum()
                  + (g_ab * d2ab).sum())
    e_corr = float(uccsd.energy(t1, t2, ers["incore"]))
    mf = ref["mf"]
    assert abs(e_rdm - (mf.e_tot - mf.mol.energy_nuc() + e_corr)) < 1e-8


def test_oh_lagrangian_stationary_and_matches_jax():
    """OH/cc-pVDZ: the DF-factorized Lagrangian is exact at the fixed
    point and quadratic in an amplitude perturbation (the property the
    fp32 certification rests on), and equals the JAX package's there."""
    mf = mean_field("oh")
    a = uhf_arrays(mf)
    eri = jgto.intor_eri(mf.mol)
    er = uccsd.make_eris_df(cholesky(eri), *a, device=CPU)
    c, e, t1, t2 = uccsd.kernel(er, conv_tol=1e-11, conv_tol_normt=1e-9,
                                max_cycle=200)
    cl, l1, l2 = lambda_ad.kernel_u(t1, t2, er, conv_tol=1e-9,
                                    max_cycle=100, diis_backend="device")
    assert c and cl
    assert abs(float(lambda_ad.lagrangian_energy_u(t1, t2, l1, l2, er))
               - e) < 1e-9
    rng = np.random.default_rng(0)
    t1p = tuple(x + 1e-4 * torch.from_numpy(rng.standard_normal(x.shape))
                for x in t1)
    el = float(lambda_ad.lagrangian_energy_u(t1p, t2, l1, l2, er))
    assert abs(el - e) < 1e-7
    jer = ju.make_eris_df(cholesky(eri), *a)
    jel = float(jl.lagrangian_energy_u(_j(t1p), _j(t2), _j(l1), _j(l2), jer))
    assert abs(el - jel) < TOL


def test_unknown_ring_raises(port):
    ers, t1, t2, _, _ = port
    with pytest.raises(ValueError, match="diis_backend"):
        lambda_ad.kernel_u(t1, t2, ers["incore"], diis_backend="gpu")
