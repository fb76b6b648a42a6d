"""The port's spin-orbital (T)-response (cc/gccsd_t_rdm: e_t_g,
residual_g, lambda_kernel_g, make_rdm12) against the JAX package, in fp64
on the CPU.

Input: OH/sto-3g GHF (the JAX package's test_gccsd_t_rdm.py system and
the docs/reference_pins.json ``gccsd_t_rdm_oh`` pin), its GERIs and the
GCCSD amplitudes the JAX package converges, handed to both packages as
numpy arrays; the spinor-MO integrals h_so and g_chem made once.
Tolerances: E(T) 1e-14 absolute (it is 2.3e-7) and the pin's et_ref
1e-12 (the JAX test's bound against its oracle); the residual 1e-12;
converged multipliers 1e-9 (the solves stop at |res| 1e-9); the RDMs
1e-8 and their energy identity 1e-9 Ha, with and without (T).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu.cc import gccsd as jg
from pyscf_mpcc_tpu.cc import gccsd_t_rdm as jr
from pyscf_mpcc_tpu_torch import convert
from pyscf_mpcc_tpu_torch.cc import gccsd_t_rdm

torch.set_num_threads(1)

CPU = torch.device("cpu")
ET_PIN = -2.3003877157816884e-07     # reference_pins.json gccsd_t_rdm_oh


@pytest.fixture(scope="module")
def ref():
    mol = jgto.M(atom="O 0 0 0; H 0 0 0.97", basis="sto-3g", spin=1)
    mf = jscf.GHF(mol)
    mf.conv_tol = 1e-12
    mf.kernel()
    er = jg.make_eris_ghf(mf)
    e, t1, t2, c = jg.kernel(er, conv_tol=1e-11, conv_tol_normt=1e-9)
    assert c
    nao = mol.nao
    C = np.asarray(mf.mo_coeff)
    Ca, Cb = C[:nao], C[nao:]
    eri = np.asarray(jgto.intor_eri(mol))
    t = (np.einsum("pqrs,pP,qQ->PQrs", eri, Ca, Ca, optimize=True)
         + np.einsum("pqrs,pP,qQ->PQrs", eri, Cb, Cb, optimize=True))
    g = (np.einsum("PQrs,rR,sS->PQRS", t, Ca, Ca, optimize=True)
         + np.einsum("PQrs,rR,sS->PQRS", t, Cb, Cb, optimize=True))
    h1 = np.asarray(mf.get_hcore())[:nao, :nao]
    hso = Ca.T @ h1 @ Ca + Cb.T @ h1 @ Cb
    out = dict(blocks={k: np.asarray(v) for k, v in er.b.items()},
               fock=np.asarray(er.fock), nocc=er.nocc, e=e,
               t1=np.asarray(t1), t2=np.asarray(t2), hso=hso, g=g,
               e_hf=float(mf.e_tot) - mol.energy_nuc(),
               et=float(jr.e_t_g(t1, t2, er)))
    r1, r2 = jr.residual_g(t1 + 0.01, t2, er)
    out["res"] = (np.asarray(r1), np.asarray(r2))
    for with_t in (True, False):
        c, l1, l2 = jr.lambda_kernel_g(t1, t2, er, conv_tol=1e-9,
                                       max_cycle=100, with_t=with_t)
        assert c
        d1, d2 = jr.make_rdm12(jnp.asarray(hso), jnp.asarray(g), t1, t2,
                               l1, l2, er.nocc, with_t=with_t)
        out["lam", with_t] = (np.asarray(l1), np.asarray(l2))
        out["rdm", with_t] = (np.asarray(d1), np.asarray(d2))
    return out


def _inputs(ref):
    er = convert.geris_from_numpy(ref["blocks"], ref["fock"], ref["nocc"],
                                  CPU)
    return (er, *convert.amps_from_numpy(ref["t1"], ref["t2"], CPU))


def test_e_t_g_matches_jax_and_pin(ref):
    er, t1, t2 = _inputs(ref)
    et = float(gccsd_t_rdm.e_t_g(t1, t2, er))
    assert abs(et - ref["et"]) < 1e-14
    assert abs(et - ET_PIN) < 1e-12 and abs(et) > 1e-9


def test_residual_g_matches_jax(ref):
    er, t1, t2 = _inputs(ref)
    r1, r2 = gccsd_t_rdm.residual_g(t1 + 0.01, t2, er)
    np.testing.assert_allclose(r1.numpy(), ref["res"][0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(r2.numpy(), ref["res"][1], rtol=0, atol=1e-12)


@pytest.mark.parametrize("with_t", [True, False])
def test_lambda_g_and_rdms_match_jax(ref, with_t):
    er, t1, t2 = _inputs(ref)
    c, l1, l2 = gccsd_t_rdm.lambda_kernel_g(t1, t2, er, conv_tol=1e-9,
                                            max_cycle=100, with_t=with_t)
    assert c
    for g, w in zip((l1, l2), ref["lam", with_t]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-9)
    h, g = torch.tensor(ref["hso"]), torch.tensor(ref["g"])
    d1, d2 = gccsd_t_rdm.make_rdm12(h, g, t1, t2, l1, l2, er.nocc,
                                    with_t=with_t)
    for x, w in zip((d1, d2), ref["rdm", with_t]):
        np.testing.assert_allclose(x.numpy(), w, rtol=0, atol=1e-8)
    assert abs(float(torch.trace(d1)) - er.nocc) < 1e-9
    e_dm = float((d1 * h).sum() + 0.5 * (g * d2).sum())
    e_expect = ref["e_hf"] + ref["e"] + (ref["et"] if with_t else 0.0)
    assert abs(e_dm - e_expect) < 1e-9
    assert float((d1 - d1.T).abs().max()) < 1e-12
    assert float((d2 - d2.permute(2, 3, 0, 1)).abs().max()) < 1e-12
