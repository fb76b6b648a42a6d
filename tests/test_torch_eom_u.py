"""The port's unrestricted, triplet and spin-orbital EOM-CCSD (cc/eom:
ee_sigma_u, kernel_ee_u, kernel_ee_triplet, kernel_ip_u, kernel_ea_u,
kernel_sf, kernel_ee_g, kernel_ip_g, kernel_ea_g) against the JAX
package, in fp64 on the CPU.

Inputs, made once in the JAX package (module fixtures) and handed to the
port as numpy arrays: OH/sto-3g UHF (tests/test_eom_ip_ea.py), its UERIs
and UCCSD amplitudes; H2O/sto-3g RHF at the geometry of
tests/test_eom_triplet_g.py, its RCCSD amplitudes and closed-shell
UERIs (triplet), and its spin-orbital integrals and GCCSD amplitudes
(the G kernels, which are host NumPy over the host copy
cc/gccsd_slow).  Tolerances: the sigma 1e-10 of its scale; roots 1e-10
Ha (the same Davidson on the same guesses; the G kernels are the same
host code and agree to rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu.cc import eom as jeom
from pyscf_mpcc_tpu.cc import eris as jeris_mod
from pyscf_mpcc_tpu.cc import gccsd_slow as jgs
from pyscf_mpcc_tpu.cc import rccsd as jrccsd
from pyscf_mpcc_tpu.cc import uccsd as juccsd
from pyscf_mpcc_tpu_torch import convert
from pyscf_mpcc_tpu_torch.cc import eom, gccsd_slow

torch.set_num_threads(1)

CPU = torch.device("cpu")
OH = "O 0 0 0; H 0 0 0.97"
H2O = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
TOL = 1e-10
U_CASES = [("kernel_ip_u", "a"), ("kernel_ip_u", "b"), ("kernel_ea_u", "a"),
           ("kernel_ea_u", "b")]
G_CASES = ["kernel_sf", "kernel_ee_g", "kernel_ip_g", "kernel_ea_g"]


def _ufields(er):
    return {k: (v if k in ("nocca", "noccb") or v is None
                else np.asarray(v)) for k, v in er._asdict().items()}


def _np_tuple(xs):
    return tuple(np.asarray(x) for x in xs)


@pytest.fixture(scope="module")
def oh():
    mol = jgto.M(atom=OH, basis="sto-3g", spin=1)
    mf = jscf.UHF(mol)
    mf.conv_tol = 1e-13
    mf.conv_tol_grad = 1e-10
    mf.kernel()
    ue = juccsd.eris_from_scf(mf)
    conv, _, t1, t2 = juccsd.kernel(ue, conv_tol=1e-12,
                                    conv_tol_normt=1e-10, max_cycle=200)
    assert conv
    rng = np.random.default_rng(2)
    r1 = tuple(rng.standard_normal(x.shape) for x in t1)
    r2 = [rng.standard_normal(x.shape) for x in t2]
    r2[0] = np.asarray(jeom._asym4(jnp.asarray(r2[0])))
    r2[2] = np.asarray(jeom._asym4(jnp.asarray(r2[2])))
    s1, s2 = jeom.ee_sigma_u(t1, t2, ue, tuple(map(jnp.asarray, r1)),
                             tuple(map(jnp.asarray, r2)))
    out = dict(fields=_ufields(ue), t1=_np_tuple(t1), t2=_np_tuple(t2),
               r1=r1, r2=tuple(r2), s=_np_tuple((*s1, *s2)))
    for name, spin in U_CASES:
        conv, e, _ = getattr(jeom, name)(t1, t2, ue, nroots=2, tol=1e-9,
                                         spin=spin)
        out[name, spin] = np.asarray(e)
    conv, e, _ = jeom.kernel_ee_u(t1, t2, ue, nroots=3, tol=1e-8)
    assert all(conv)
    out["ee_u"] = np.asarray(e)
    return out


@pytest.fixture(scope="module")
def h2o():
    mol = jgto.M(atom=H2O, basis="sto-3g", unit="angstrom")
    mf = jscf.RHF(mol)
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    mf.kernel()
    eri = np.asarray(jgto.intor_eri(mol))
    f = np.asarray(mf.get_fock(mf.make_rdm1()))
    mo = np.asarray(mf.mo_coeff)
    er = jeris_mod.make_eris_incore(eri, mo, f, 5)
    conv, _, t1, t2 = jrccsd.kernel(er, conv_tol=1e-11, conv_tol_normt=1e-9,
                                    max_cycle=100)
    assert conv
    ue = juccsd.make_eris_incore(eri, mo, mo, f, f, 5, 5)
    conv, e, _ = jeom.kernel_ee_triplet(t1, t2, ue, nroots=2, tol=1e-8)
    assert all(conv)
    so = jgs.eris_from_scf(mf)
    _, t1g, t2g, _ = jgs.kernel(so, conv_tol=1e-11, conv_tol_normt=1e-9)
    out = dict(ufields=_ufields(ue), t1=np.asarray(t1), t2=np.asarray(t2),
               triplet=np.asarray(e), so=so, t1g=t1g, t2g=t2g)
    kw = dict(kernel_sf=dict(nroots=1, tol=1e-7),
              kernel_ee_g=dict(nroots=4, delta_ms=0, tol=1e-7),
              kernel_ip_g=dict(nroots=2, tol=1e-7),
              kernel_ea_g=dict(nroots=2, tol=1e-7))
    for name in G_CASES:
        conv, e, _ = getattr(jeom, name)(t1g, t2g, so, **kw[name])
        assert conv[0]
        out[name] = (kw[name], np.asarray(e))
    return out


def _port_u(oh):
    ue = convert.ueris_from_numpy(oh["fields"], CPU)
    t1, t2 = convert.uamps_from_numpy(oh["t1"], oh["t2"], CPU)
    return t1, t2, ue


def test_ee_sigma_u_matches_jax(oh):
    t1, t2, ue = _port_u(oh)
    r1, r2 = convert.uamps_from_numpy(oh["r1"], oh["r2"], CPU)
    s1, s2 = eom.ee_sigma_u(t1, t2, ue, r1, r2)
    for a, b in zip((*s1, *s2), oh["s"]):
        a = convert.to_numpy(a)
        assert np.abs(a - b).max() < TOL * np.abs(b).max()


def test_kernel_ee_u_matches_jax(oh):
    conv, e, _ = eom.kernel_ee_u(*_port_u(oh), nroots=3, tol=1e-8)
    assert all(conv)
    np.testing.assert_allclose(e, oh["ee_u"], rtol=0, atol=TOL)


@pytest.mark.parametrize("name,spin", U_CASES)
def test_ip_ea_u_match_jax(oh, name, spin):
    conv, e, _ = getattr(eom, name)(*_port_u(oh), nroots=2, tol=1e-9,
                                    spin=spin)
    assert all(conv)
    np.testing.assert_allclose(e, oh[name, spin], rtol=0, atol=TOL)


def test_triplet_matches_jax(h2o):
    ue = convert.ueris_from_numpy(h2o["ufields"], CPU)
    t1, t2 = convert.amps_from_numpy(h2o["t1"], h2o["t2"], CPU)
    conv, e, _ = eom.kernel_ee_triplet(t1, t2, ue, nroots=2, tol=1e-8)
    assert all(conv)
    np.testing.assert_allclose(e, h2o["triplet"], rtol=0, atol=TOL)
    # and the embedded amplitudes are the closed-shell UCCSD ones
    (a1, b1), (aa, ab, bb) = eom.embed_restricted(t1, t2)
    assert torch.equal(a1, b1) and torch.equal(aa, bb)
    np.testing.assert_allclose(convert.to_numpy(aa), h2o["t2"]
                               - h2o["t2"].transpose(0, 1, 3, 2))


@pytest.mark.parametrize("name", G_CASES)
def test_g_kernels_match_jax(h2o, name):
    so = h2o["so"]
    er = gccsd_slow.SpinOrbERIs(np.asarray(so.ints), np.asarray(so.fock),
                                so.nocc, spins=np.asarray(so.spins))
    kw, ref = h2o[name]
    conv, e, _ = getattr(eom, name)(h2o["t1g"], h2o["t2g"], er, **kw)
    assert conv[0]
    np.testing.assert_allclose(e, ref, rtol=0, atol=TOL)
