"""The port's closed-shell (T)-response (cc/ccsd_t_rdm: e_t_dense,
lambda_kernel, make_rdm12) against the JAX package, in fp64 on the CPU.

Inputs: H2O/sto-3g RHF (the JAX package's test_ccsd_t_rdm.py molecule),
its incore RERIs and the CCSD amplitudes the JAX package converges, and
the same system with exact-Cholesky DF factors (the Lov/Lvv branch of
e_t_dense).  The same numpy arrays go to both packages; the JAX
references are computed once (module fixture).  Tolerances: E(T) 1e-12
(the same fp64 algebra), the dense functional against the port's tiled
engine (engine='xla') 1e-12 at vfac 1 and 2, converged multipliers
1e-10, the RDMs 1e-9 and their energy identity 1e-9 Ha.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_uinputs import cholesky, mean_field
from pyscf_mpcc_tpu import ao2mo as jao2mo
from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.cc import ccsd_t_rdm as jr
from pyscf_mpcc_tpu.cc import eris as jeris
from pyscf_mpcc_tpu.cc import rccsd as jrccsd
from pyscf_mpcc_tpu_torch import convert
from pyscf_mpcc_tpu_torch.cc import ccsd_t, ccsd_t_rdm

torch.set_num_threads(1)

CPU = torch.device("cpu")
NOCC = 5


def _fields(er):
    return {k: None if v is None else np.asarray(v)
            for k, v in er._asdict().items()}


@pytest.fixture(scope="module")
def ref():
    mf = mean_field("h2o")
    eri = jgto.intor_eri(mf.mol)
    fock = mf.get_fock(mf.make_rdm1())
    er = jeris.make_eris_incore(eri, mf.mo_coeff, fock, NOCC)
    er_df = jeris.make_eris_df(cholesky(eri), mf.mo_coeff, fock, NOCC,
                               keep_ovvv=False)
    c, e, t1, t2 = jrccsd.kernel(er, conv_tol=1e-12, conv_tol_normt=1e-10)
    assert c
    out = dict(fields=_fields(er), fields_df=_fields(er_df),
               t1=np.asarray(t1), t2=np.asarray(t2), e_ccsd=float(e),
               e_hf=float(mf.e_tot) - mf.mol.energy_nuc())
    for vf in (1.0, 2.0):
        out["et", vf] = float(jr.e_t_dense(t1, t2, er, v_fac=vf))
        out["et_df", vf] = float(jr.e_t_dense(t1, t2, er_df, v_fac=vf))
    c, l1, l2 = jr.lambda_kernel(t1, t2, er, conv_tol=1e-10)
    assert c
    out["l1"], out["l2"] = np.asarray(l1), np.asarray(l2)
    mo = np.asarray(mf.mo_coeff)
    h_mo = mo.T @ mf.get_hcore() @ mo
    eri_mo = np.asarray(jao2mo.full(jnp.asarray(eri), jnp.asarray(mo)))
    out["h_mo"], out["eri_mo"] = h_mo, eri_mo
    d1, d2 = jr.make_rdm12(jnp.asarray(h_mo), jnp.asarray(eri_mo), t1, t2,
                           l1, l2, NOCC)
    out["rdm1"], out["rdm2"] = np.asarray(d1), np.asarray(d2)
    return out


def _inputs(ref, df=False):
    er = convert.eris_from_numpy(ref["fields_df" if df else "fields"], CPU)
    t1, t2 = convert.amps_from_numpy(ref["t1"], ref["t2"], CPU)
    return er, t1, t2


@pytest.mark.parametrize("v_fac", [1.0, 2.0])
def test_e_t_dense_matches_jax_and_tiled_engine(ref, v_fac):
    er, t1, t2 = _inputs(ref)
    et = ccsd_t_rdm.e_t_dense(t1, t2, er, v_fac=v_fac)
    assert et.dtype == torch.float64 and et.ndim == 0
    assert abs(float(et) - ref["et", v_fac]) < 1e-12
    tiled = ccsd_t.kernel(t1, t2, er, tile=3, engine="xla", vfac=v_fac)
    assert abs(float(et) - tiled) < 1e-12
    assert abs(float(et)) > 1e-5


@pytest.mark.parametrize("v_fac", [1.0, 2.0])
def test_e_t_dense_df_branch_matches_jax(ref, v_fac):
    er, t1, t2 = _inputs(ref, df=True)
    assert er.ovvv is None
    et = float(ccsd_t_rdm.e_t_dense(t1, t2, er, v_fac=v_fac))
    assert abs(et - ref["et_df", v_fac]) < 1e-12
    # exact Cholesky factors: the DF functional equals the incore one
    assert abs(et - ref["et", v_fac]) < 1e-10


def test_lambda_t_matches_jax(ref):
    er, t1, t2 = _inputs(ref)
    c, l1, l2 = ccsd_t_rdm.lambda_kernel(t1, t2, er, conv_tol=1e-10)
    assert c
    np.testing.assert_allclose(l1.numpy(), ref["l1"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(l2.numpy(), ref["l2"], rtol=0, atol=1e-10)


def test_rdm12_matches_jax_and_energy_identity(ref):
    _, t1, t2 = _inputs(ref)
    l1, l2, h, g = (torch.tensor(ref[k]) for k in ("l1", "l2", "h_mo",
                                                   "eri_mo"))
    d1, d2 = ccsd_t_rdm.make_rdm12(h, g, t1, t2, l1, l2, NOCC)
    np.testing.assert_allclose(d1.numpy(), ref["rdm1"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(d2.numpy(), ref["rdm2"], rtol=0, atol=1e-9)
    assert abs(float(torch.trace(d1)) - 2 * NOCC) < 1e-8
    e_rdm = float((d1 * h).sum() + 0.5 * (g * d2).sum())
    e_tot = ref["e_hf"] + ref["e_ccsd"] + ref["et", 1.0]
    assert abs(e_rdm - e_tot) < 1e-9
