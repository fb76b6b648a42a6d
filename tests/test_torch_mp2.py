"""The port's closed-shell MP2 (pyscf_mpcc_tpu_torch.mp.mp2) against the JAX
package.

Inputs are fp64 numpy: the H2O/cc-pVDZ RHF of the JAX package's cached
fixture (tests/test_mp2.py), its (ia|jb) and MO Fock, a localized Fock
(the valence occupied block rotated by a seeded orthogonal matrix, as
tests/test_mp2.py does), its MP2 amplitudes (for the natural orbitals),
seeded random amplitudes and a seeded DF factor.
The same arrays go to both packages; the JAX references are computed once
(module fixture).  Tolerances: the same fp64 arithmetic up to summation
order, rtol 1e-10; converged iterative energies 1e-9 Ha (the JAX pin for
the canonical Fock, JAX's own solve for the localized one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu.mp import mp2 as jmp2
from pyscf_mpcc_tpu.testutil import h2o_ccpvdz
from pyscf_mpcc_tpu_torch import convert, mp
from pyscf_mpcc_tpu_torch.mp import mp2

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-10, 1e-13
NOCC = 5
# pyscf/cc/test/test_h2o.py:60 (tests/test_mp2.py)
E_MP2 = -0.2040199672883385


def _inputs():
    d = h2o_ccpvdz()
    mo = d["mo_coeff"]
    ovov = np.einsum("pqrs,pi,qa,rj,sb->iajb", d["eri_ao"], mo[:, :NOCC],
                     mo[:, NOCC:], mo[:, :NOCC], mo[:, NOCC:], optimize=True)
    fock = mo.T @ d["fock_ao"] @ mo
    # localized surrogate: rotate the valence occupied block only
    q, _ = np.linalg.qr(np.random.RandomState(7).randn(NOCC - 1, NOCC - 1))
    mo_l = mo.copy()
    mo_l[:, 1:NOCC] = mo[:, 1:NOCC] @ q
    ovov_l = np.einsum("pqrs,pi,qa,rj,sb->iajb", d["eri_ao"],
                       mo_l[:, :NOCC], mo_l[:, NOCC:], mo_l[:, :NOCC],
                       mo_l[:, NOCC:], optimize=True)
    fock_l = mo_l.T @ d["fock_ao"] @ mo_l
    rng = np.random.default_rng(11)
    nvir = mo.shape[1] - NOCC
    t2 = rng.standard_normal((NOCC, NOCC, nvir, nvir)) * 0.02
    t2 = t2 + t2.transpose(1, 0, 3, 2)
    Lov = rng.standard_normal((40, NOCC, nvir)) * 0.1
    eo, ev = d["mo_energy"][:NOCC], d["mo_energy"][NOCC:]
    eia = eo[:, None] - ev[None, :]
    t2_mp2 = ovov.transpose(0, 2, 1, 3) / (eia[:, None, :, None]
                                           + eia[None, :, None, :])
    return dict(eo=eo, ev=ev, ovov=ovov, fock=fock, ovov_l=ovov_l,
                fock_l=fock_l, t2=t2, t2_mp2=t2_mp2, Lov=Lov, mo=mo,
                mo_energy=d["mo_energy"])


# name -> call on (module, inputs): the same call for both packages
CALLS = {
    "energy_from_t2": lambda m, a: m.energy_from_t2(a["t2"], a["ovov"]),
    "kernel": lambda m, a: m.kernel(a["eo"], a["ev"], a["ovov"]),
    "kernel_ss_os": lambda m, a: m.kernel_ss_os(a["eo"], a["ev"], a["ovov"]),
    "df_kernel": lambda m, a: m.df_kernel(a["eo"], a["ev"], a["Lov"]),
    "update_amps": lambda m, a: m.update_amps(
        a["t2"], a["ovov_l"], a["fock_l"][:NOCC, :NOCC],
        a["fock_l"][NOCC:, NOCC:]),
    "make_rdm1_vv": lambda m, a: m.make_rdm1_vv(a["t2"]),
    "make_rdm1": lambda m, a: m.make_rdm1(a["t2"], NOCC),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x)
    return np.asarray(x)


@pytest.fixture(scope="module")
def ref():
    a = _inputs()
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    out = {}
    for name, fn in CALLS.items():
        v = fn(jmp2, ja)
        out[name] = (tuple(_np(x) for x in v) if isinstance(v, tuple)
                     else _np(v))
    fno = jmp2.make_fno(ja["t2_mp2"], a["mo_energy"], a["mo"], NOCC,
                        thresh=1e-4)
    e_loc, _, conv = jmp2.iterative_kernel(
        ja["ovov_l"], ja["fock_l"][:NOCC, :NOCC],
        ja["fock_l"][NOCC:, NOCC:], conv_tol=1e-11, max_cycle=200)
    assert conv
    return a, out, fno, e_loc


@pytest.fixture(scope="module")
def tin(ref):
    a = ref[0]
    return {k: convert.tensors_from_numpy(v, device=CPU)[0]
            for k, v in a.items()}


@pytest.mark.parametrize("name", list(CALLS))
def test_function_matches_jax(ref, tin, name):
    got = CALLS[name](mp2, tin)
    want = ref[1][name]
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(convert.to_numpy(g), w, rtol=RTOL,
                                   atol=ATOL)


def test_canonical_mp2_pin(tin):
    e, _ = mp2.kernel(tin["eo"], tin["ev"], tin["ovov"])
    e_ss, e_os = mp2.kernel_ss_os(tin["eo"], tin["ev"], tin["ovov"])
    assert abs(float(e) - E_MP2) < 1e-10
    assert abs(float(e_ss + e_os) - float(e)) < 1e-12


def test_make_fno_matches_jax(ref, tin):
    a, _, (jmo, jkeep, jw), _ = ref
    mo, keep, w = mp2.make_fno(tin["t2_mp2"], a["mo_energy"], a["mo"], NOCC,
                               thresh=1e-4)
    assert keep == jkeep and 0 < keep < len(w)
    np.testing.assert_allclose(w, jw, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mo[:, :NOCC], a["mo"][:, :NOCC], rtol=0,
                               atol=0)
    # the rotated virtuals up to the sign of each natural orbital: the
    # projector weighted by the occupations is sign-free
    cv, jcv = mo[:, NOCC:], np.asarray(jmo)[:, NOCC:]
    np.testing.assert_allclose((cv * w) @ cv.T, (jcv * jw) @ jcv.T,
                               rtol=RTOL, atol=1e-12)
    # a tensor mo_coeff is copied, not rotated in place
    mo_t = torch.tensor(a["mo"])
    mp2.make_fno(tin["t2_mp2"], a["mo_energy"], mo_t, NOCC)
    np.testing.assert_array_equal(mo_t.numpy(), a["mo"])


@pytest.mark.parametrize("ring", ["host", "device"])
@pytest.mark.parametrize("fock", ["canonical", "localized"])
def test_iterative_kernel(ref, tin, ring, fock):
    sfx = "" if fock == "canonical" else "_l"
    f = tin["fock" + sfx]
    e, t2, conv = mp2.iterative_kernel(
        tin["ovov" + sfx], f[:NOCC, :NOCC], f[NOCC:, NOCC:],
        conv_tol=1e-11, max_cycle=200, diis_backend=ring)
    want = E_MP2 if fock == "canonical" else ref[3]
    assert conv and t2.dtype == torch.float64
    assert abs(e - want) < 1e-9
    assert abs(float(mp2.energy_from_t2(t2, tin["ovov" + sfx])) - e) < 1e-14


def test_iterative_kernel_rejects_unknown_ring(tin):
    f = tin["fock"]
    with pytest.raises(ValueError, match="diis_backend"):
        mp2.iterative_kernel(tin["ovov"], f[:NOCC, :NOCC], f[NOCC:, NOCC:],
                             diis_backend="gpu")


@pytest.mark.parametrize("name", ["gmp2", "dfgmp2", "mp2f12", "GMP2"])
def test_open_shell_mp2_not_ported(name):
    """The generalized MP2 modules were stubs that raised; they are ported
    now (tests/test_torch_gmp2.py, tests/test_torch_mp2f12.py), and the
    package exports the port's own."""
    obj = getattr(mp, name)
    mod = obj.__name__ if name != "GMP2" else obj.__module__
    assert mod.startswith("pyscf_mpcc_tpu_torch.mp.")
