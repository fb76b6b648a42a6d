"""The port's umpccsd.kernel_pert_triples (the spin-orbital coupled
active-space T3 over the host copies cc/gccsd_slow, cc/eom_slow and
cc/gccsdt_slow, with the port's frozen_masks_u) against the JAX package,
in fp64 on the CPU.

Input: linear H4/sto-3g RHF (the JAX package's test_gccsdt.py system),
the JAX mean field's orbitals in the port's.  The three limits of
tests/test_gccsdt.py: empty triples and nothing frozen is CCSD, the full
active space and nothing frozen is full CCSDT, and active triples with a
frozen bath converge between them.  Tolerances: energies 1e-10 Ha
against the JAX package (the same NumPy engines), amplitudes 1e-8, the
limits 1e-9 Ha (the JAX test's bounds).
"""

import numpy as np
import pytest

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu.mpcc import umpccsd as jum
from pyscf_mpcc_tpu_torch import gto, scf
from pyscf_mpcc_tpu_torch.cc import eom_slow, gccsd_slow, gccsdt_slow
from pyscf_mpcc_tpu_torch.mpcc import umpccsd

H4 = "H 0 0 0; H 0 0 0.9; H 0 0 1.8; H 0 0 2.7"
# (act_hole, act_particle, idx_s, idx_d, model, conv_tol, conv_tol_normt)
LIMITS = {"ccsd": (([], []), ([], []), [], [], "ccsdt", 1e-11, 1e-9),
          "ccsdt": (([0, 1], [0, 1]), ([0, 1], [0, 1]), [], [], "ccsdt",
                    1e-11, 1e-9),
          "frozen_bath": (([1], [1]), ([0], [0]), [], list(range(15)),
                          "ccsdt-3", 1e-10, 1e-8)}


def _rhf(pkg_gto, pkg_scf):
    mf = pkg_scf.RHF(pkg_gto.M(atom=H4, basis="sto-3g"))
    mf.conv_tol = 1e-13
    mf.conv_tol_grad = 1e-11
    mf.kernel()
    return mf


def _run(mod, mf, name):
    ah, ap, s, d, model, tol, tol_t = LIMITS[name]
    return mod.kernel_pert_triples(mf, act_hole=ah, act_particle=ap,
                                   idx_s=s, idx_d=d, model=model,
                                   conv_tol=tol, conv_tol_normt=tol_t)


@pytest.fixture(scope="module")
def ref():
    jmf = _rhf(jgto, jscf)
    mf = _rhf(gto, scf)
    assert abs(mf.e_tot - jmf.e_tot) < 1e-10
    mf.mo_coeff = np.asarray(jmf.mo_coeff)
    so = gccsd_slow.eris_from_scf(mf)
    e_cc = gccsd_slow.kernel(so, conv_tol=1e-12, conv_tol_normt=1e-11,
                             max_cycle=300)[0]
    e_t = gccsdt_slow.kernel(so, eom_slow.h_so_from_eris(so), model="ccsdt",
                             conv_tol=1e-11, conv_tol_normt=1e-9,
                             max_cycle=200)[0]
    return dict(mf=mf, e_cc=e_cc, e_t=e_t,
                jax={k: _run(jum, jmf, k) for k in LIMITS})


@pytest.mark.parametrize("name", list(LIMITS))
def test_pert_triples_limit_matches_jax(ref, name):
    e, t1, t2, t3, conv = _run(umpccsd, ref["mf"], name)
    je, jt1, jt2, jt3, jconv = ref["jax"][name]
    assert conv and jconv
    assert abs(e - je) < 1e-10
    for g, w in ((t1, jt1), (t2, jt2), (t3, jt3)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=1e-8)
    if name == "ccsd":
        assert abs(e - ref["e_cc"]) < 1e-9
    elif name == "ccsdt":
        assert abs(e - ref["e_t"]) < 1e-9
    else:
        assert abs(e - ref["e_cc"]) < 0.05
