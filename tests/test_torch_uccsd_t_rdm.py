"""The port's unrestricted (T)-response (cc/uccsd_t_rdm: e_t_dense_u,
lambda_kernel_u, make_rdm12) against the JAX package, in fp64 on the CPU.

Inputs: OH/6-31g doublet UHF (the JAX package's test_uccsd_t_rdm.py
molecule and the docs/reference_pins.json ``uccsd_t_rdm_oh`` system), its
incore UERIs and the UCCSD amplitudes the JAX package converges.  The same
numpy arrays go to both packages; the JAX references are computed once
(module fixture).  Tolerances: E(T) 1e-12 (the same fp64 algebra) and the
pin's et_ref 1e-10 (the JAX test's bound); the dense functional against
the port's tiled uccsd_t.kernel 1e-10 at v_fac 1 (the engine leaves out
the f_vo term, zero only to SCF convergence); converged multipliers
1e-9 (the solve stops at |res| 1e-9); the RDMs 1e-8 and their energy
identity 1e-8 Ha.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_uinputs import fields, np_tuple, uhf_arrays
from pyscf_mpcc_tpu import ao2mo as jao2mo
from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu.cc import uccsd as ju
from pyscf_mpcc_tpu.cc import uccsd_t_rdm as jr
from pyscf_mpcc_tpu_torch import convert
from pyscf_mpcc_tpu_torch.cc import uccsd_t, uccsd_t_rdm

torch.set_num_threads(1)

CPU = torch.device("cpu")
ET_PIN = -0.0005574953727482226      # reference_pins.json uccsd_t_rdm_oh


def _t(xs):
    return tuple(torch.tensor(np.asarray(x)) for x in xs)


@pytest.fixture(scope="module")
def ref():
    mol = jgto.M(atom="O 0 0 0; H 0 0 0.97", basis="6-31g", spin=1)
    mf = jscf.UHF(mol)
    mf.conv_tol = 1e-12
    mf.kernel()
    a = uhf_arrays(mf)
    eri = jgto.intor_eri(mol)
    er = ju.make_eris_incore(eri, *a)
    c, e, t1, t2 = ju.kernel(er, conv_tol=1e-11, conv_tol_normt=1e-9,
                             max_cycle=200)
    assert c
    out = dict(fields=fields(er), t1=np_tuple(t1), t2=np_tuple(t2),
               e_corr=float(e), nelec=mol.nelec,
               e_hf=float(mf.e_tot) - mol.energy_nuc())
    for vf in (1.0, 2.0):
        out["et", vf] = float(jr.e_t_dense_u(t1, t2, er, v_fac=vf))
    c, l1, l2 = jr.lambda_kernel_u(t1, t2, er, conv_tol=1e-9, max_cycle=100)
    assert c
    out["l1"], out["l2"] = np_tuple(l1), np_tuple(l2)
    moa, mob = (np.asarray(x) for x in a[:2])
    h = mf.get_hcore()
    ej = jnp.asarray(eri)
    ints = (moa.T @ h @ moa, mob.T @ h @ mob,
            np.asarray(jao2mo.full(ej, jnp.asarray(moa))),
            np.asarray(jao2mo.general(ej, (moa, moa, mob, mob))),
            np.asarray(jao2mo.full(ej, jnp.asarray(mob))))
    out["ints"] = ints
    d1, d2 = jr.make_rdm12(*map(jnp.asarray, ints), t1, t2, l1, l2,
                           *mol.nelec)
    out["rdm"] = np_tuple((*d1, *d2))
    return out


def _inputs(ref):
    er = convert.ueris_from_numpy(ref["fields"], CPU)
    return er, _t(ref["t1"]), _t(ref["t2"])


@pytest.mark.parametrize("v_fac", [1.0, 2.0])
def test_e_t_dense_u_matches_jax(ref, v_fac):
    er, t1, t2 = _inputs(ref)
    et = uccsd_t_rdm.e_t_dense_u(t1, t2, er, v_fac=v_fac)
    assert et.dtype == torch.float64
    assert abs(float(et) - ref["et", v_fac]) < 1e-12
    if v_fac == 1.0:
        assert abs(float(et) - ET_PIN) < 1e-10
        # the tiled engine drops the f_vo term (canonical form), ~1e-11
        # at this SCF convergence
        assert abs(float(et) - uccsd_t.kernel(t1, t2, er, tile=4)) < 1e-10


def test_lambda_t_u_matches_jax(ref):
    er, t1, t2 = _inputs(ref)
    c, l1, l2 = uccsd_t_rdm.lambda_kernel_u(t1, t2, er, conv_tol=1e-9,
                                            max_cycle=100)
    assert c
    for g, w in zip((*l1, *l2), (*ref["l1"], *ref["l2"])):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-9)


def test_rdm12_u_matches_jax_and_energy_identity(ref):
    _, t1, t2 = _inputs(ref)
    l1, l2 = _t(ref["l1"]), _t(ref["l2"])
    ints = _t(ref["ints"])
    na, nb = ref["nelec"]
    (d1a, d1b), (d2aa, d2ab, d2bb) = uccsd_t_rdm.make_rdm12(
        *ints, t1, t2, l1, l2, na, nb)
    got = (d1a, d1b, d2aa, d2ab, d2bb)
    for g, w in zip(got, ref["rdm"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-8)
    assert abs(float(torch.trace(d1a)) - na) < 1e-8
    assert abs(float(torch.trace(d1b)) - nb) < 1e-8
    h_a, h_b, g_aa, g_ab, g_bb = ints
    e_rdm = float((d1a * h_a).sum() + (d1b * h_b).sum()
                  + 0.5 * (g_aa * d2aa).sum() + 0.5 * (g_bb * d2bb).sum()
                  + (g_ab * d2ab).sum())
    e_tot = ref["e_hf"] + ref["e_corr"] + ref["et", 1.0]
    assert abs(e_rdm - e_tot) < 1e-8
