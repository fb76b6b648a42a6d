"""The port's CCSD (pyscf_mpcc_tpu_torch.cc.rccsd) against the JAX package.

Both packages get the same numpy inputs; the port runs in fp64 on the CPU,
the JAX side in x64 on the CPU (tests/conftest.py).  Tolerances: identical
fp64 arithmetic up to summation order, rtol 1e-10 / atol 1e-13.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu.cc import rccsd as jrccsd
from pyscf_mpcc_tpu.cc.eris import RERIs as JRERIs
from pyscf_mpcc_tpu_torch import convert, testing
from pyscf_mpcc_tpu_torch.cc import eris as teris_mod
from pyscf_mpcc_tpu_torch.cc import rccsd as trccsd
from pyscf_mpcc_tpu_torch.scf import RHF

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-10, 1e-13
NOCC, NVIR, NAUX = 4, 11, 30

# pyscf/cc/test/test_h2o.py:53-77 pinned values (as tests/test_rccsd.py)
E_MP2 = -0.2040199672883385
E_IT1 = -0.208967840546667
E_IT2 = -0.212173678670510
E_CCSD = -0.2133432312951


def _fields(form):
    """numpy DF-synthetic MO blocks (the __graft_entry__ recipe) in one of
    three forms: 'df' (Lvv + ovvv), 'df_direct' (Lvv, no ovvv) and
    'vvvv' (materialized (ab|cd), no DF factors)."""
    rng = np.random.default_rng(2024)
    Loo = rng.random((NAUX, NOCC, NOCC)) * 0.05
    Loo = 0.5 * (Loo + Loo.transpose(0, 2, 1))
    Lov = rng.random((NAUX, NOCC, NVIR)) * 0.05
    Lvv = rng.random((NAUX, NVIR, NVIR)) * 0.05
    Lvv = 0.5 * (Lvv + Lvv.transpose(0, 2, 1))
    mo_e = np.sort(rng.random(NOCC + NVIR)) * 2.0
    mo_e[:NOCC] -= 1.5
    fock = np.diag(mo_e)
    fock += 0.005 * (lambda x: x + x.T)(rng.standard_normal(fock.shape))
    f = dict(fock=fock, mo_energy=np.diag(fock).copy(),
             oooo=np.einsum("Lij,Lkl->ijkl", Loo, Loo),
             ovoo=np.einsum("Lia,Ljk->iajk", Lov, Loo),
             ovov=np.einsum("Lia,Ljb->iajb", Lov, Lov),
             oovv=np.einsum("Lij,Lab->ijab", Loo, Lvv),
             ovvo=None,
             ovvv=np.einsum("Lia,Lbc->iabc", Lov, Lvv),
             vvvv=None, Lvv=Lvv, Lov=Lov, Loo=Loo, Lvv_stream=None)
    if form == "df_direct":
        f["ovvv"] = None
    elif form == "vvvv":
        f["vvvv"] = np.einsum("Lab,Lcd->abcd", Lvv, Lvv)
        f["ovvo"] = f["ovov"].transpose(0, 1, 3, 2).copy()
        f.update(Lvv=None, Lov=None, Loo=None)
    return f


def _amps():
    rng = np.random.default_rng(7)
    t1 = rng.standard_normal((NOCC, NVIR)) * 0.02
    t2 = rng.standard_normal((NOCC, NOCC, NVIR, NVIR)) * 0.02
    return t1, t2 + t2.transpose(1, 0, 3, 2)


CASES = [("df", 1), ("df", 3), ("df_direct", 1), ("df_direct", 3),
         ("vvvv", 1)]


@pytest.fixture(scope="module")
def jax_ref():
    """JAX init_amps / energy / update_amps for every case, once."""
    t1, t2 = _amps()
    out = {}
    for form, ntile in CASES:
        f = _fields(form)
        je = JRERIs(**{k: None if v is None else jnp.asarray(v)
                       for k, v in f.items()})
        emp2, m1, m2 = jrccsd.init_amps(je)
        e = jrccsd.energy(jnp.asarray(t1), jnp.asarray(t2), je)
        u1, u2 = jrccsd.update_amps(jnp.asarray(t1), jnp.asarray(t2), je,
                                    ntile=ntile)
        out[(form, ntile)] = dict(
            fields=f, emp2=float(emp2), m1=np.asarray(m1), m2=np.asarray(m2),
            e=float(e), u1=np.asarray(u1), u2=np.asarray(u2))
    return out


def _close(a, b):
    np.testing.assert_allclose(convert.to_numpy(a) if torch.is_tensor(a)
                               else a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("form,ntile", CASES)
def test_init_energy_update_match_jax(jax_ref, form, ntile):
    ref = jax_ref[(form, ntile)]
    te = convert.eris_from_numpy(ref["fields"], CPU)
    t1, t2 = convert.amps_from_numpy(*_amps(), CPU)
    emp2, m1, m2 = trccsd.init_amps(te)
    _close(float(emp2), ref["emp2"])
    _close(m1, ref["m1"])
    _close(m2, ref["m2"])
    _close(float(trccsd.energy(t1, t2, te)), ref["e"])
    u1, u2 = trccsd.update_amps(t1, t2, te, ntile=ntile)
    assert u1.dtype == torch.float64
    _close(u1, ref["u1"])
    _close(u2, ref["u2"])


@pytest.mark.parametrize("ntile", [1, 3, 4])
def test_pair_ladder_sym_matches_jax(ntile):
    rng = np.random.default_rng(ntile)
    tau = rng.standard_normal((3, 3, NVIR, NVIR))   # not symmetric
    Ld = rng.standard_normal((NAUX, NVIR, NVIR))
    ref = np.asarray(jrccsd.pair_ladder_sym(jnp.asarray(tau),
                                            jnp.asarray(Ld), ntile))
    out = trccsd.pair_ladder_sym(torch.tensor(tau), torch.tensor(Ld), ntile)
    _close(out, ref)


@pytest.fixture(scope="module")
def h2o_sym_eris():
    """The port's own RHF (sym geometry, incore integrals) -> MO blocks."""
    from pyscf_mpcc_tpu_torch import gto
    mf = RHF(testing.mol_of("sym"))
    mf.conv_tol = 1e-13
    mf.conv_tol_grad = 1e-10
    mf.run()
    eri = gto.intor_eri(mf.mol)
    fock = mf.get_fock(mf.make_rdm1())
    return teris_mod.make_eris_incore(eri, mf.mo_coeff, fock, 5,
                                      device=CPU)


def test_pinned_iterations(h2o_sym_eris):
    er = h2o_sym_eris
    emp2, t1, t2 = trccsd.init_amps(er)
    assert abs(float(emp2) - E_MP2) < 1e-9
    t1, t2 = trccsd.update_amps(t1, t2, er)
    assert abs(float(trccsd.energy(t1, t2, er)) - E_IT1) < 1e-9
    t1, t2 = trccsd.update_amps(t1, t2, er)
    assert abs(float(trccsd.energy(t1, t2, er)) - E_IT2) < 1e-9


def test_pinned_converged_energy(h2o_sym_eris):
    conv, e, t1, t2 = trccsd.kernel(h2o_sym_eris, conv_tol=1e-10,
                                    conv_tol_normt=1e-8, max_cycle=100)
    assert conv
    assert abs(e - E_CCSD) < 1e-7
    assert float((t2 - t2.permute(1, 0, 3, 2)).abs().max()) < 1e-10


def test_device_diis_not_ported(h2o_sym_eris):
    # the device ring is ported (lib/device_diis): it reaches the pinned
    # energy; an unknown backend raises
    conv, e, t1, t2 = trccsd.kernel(h2o_sym_eris, conv_tol=1e-10,
                                    conv_tol_normt=1e-8, max_cycle=100,
                                    diis_backend="device")
    assert conv
    assert abs(e - E_CCSD) < 1e-7
    with pytest.raises(ValueError):
        trccsd.kernel(h2o_sym_eris, diis_backend="tpu")
