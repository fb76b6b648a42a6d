"""The port's moment-conserving GF-CCSD (cc/momgfccsd) against the JAX
package, in fp64 on the CPU.

Inputs: H2O/sto-3g (tests/test_momgfccsd.py's system): the JAX RHF, its
integrals, CCSD amplitudes and Lambda multipliers, made once (a module
fixture) and handed to the port as numpy arrays; the port's driver holds
them (its RHF is given the JAX orbitals).  Tolerances: moments 1e-10 of
each moment's scale (the same kets, bras and IP/EA sigmas, the sigma
batched by torch.func.vmap here and jax.vmap there); the poles and
weights from those moments 1e-8 (an SVD and an eigensolve of the
ill-conditioned Hankel pair); the 1-RDM 1e-12 (host NumPy on the same
arrays); the chk round trip exact.
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.cc import momgfccsd as jgf
from pyscf_mpcc_tpu.cc.driver import RCCSDDriver as JDriver
from pyscf_mpcc_tpu.scf import RHF as JRHF
from pyscf_mpcc_tpu_torch import convert, gto
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.cc import momgfccsd as gf
from pyscf_mpcc_tpu_torch.cc.driver import CCSD
from pyscf_mpcc_tpu_torch.scf import RHF

torch.set_num_threads(1)

CPU = torch.device("cpu")
H2O = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
NITER = 2


@pytest.fixture(scope="module")
def ref():
    mol = jgto.M(atom=H2O, basis="sto-3g", unit="angstrom")
    mf = JRHF(mol)
    mf.conv_tol = 1e-12
    mf.kernel()
    cc = JDriver(mf).set(conv_tol=1e-10, conv_tol_normt=1e-8)
    cc.run()
    cc.solve_lambda()
    amps = [np.asarray(x) for x in (cc.t1, cc.t2, cc.l1, cc.l2)]
    mh = jgf.build_hole_moments(cc.t1, cc.t2, cc.l1, cc.l2, cc.eris, NITER)
    mp = jgf.build_part_moments(cc.t1, cc.t2, cc.l1, cc.l2, cc.eris, NITER)
    g = jgf.MomGFCCSD(cc, niter=(NITER, NITER))
    g.kernel(hole_moments=mh, part_moments=mp)
    gh = jgf.MomGFCCSD(cc, niter=(1, 1))
    gh.hermi_moments = gh.hermi_solver = True
    gh.kernel()
    return dict(
        mo=np.asarray(mf.mo_coeff), amps=amps, mh=mh, mp=mp,
        args=(np.asarray(jgto.intor_eri(mol)), np.asarray(mf.mo_coeff),
              np.asarray(mf.get_fock(mf.make_rdm1())), 5),
        ip=g.ipgfccsd(nroots=3), ea=g.eagfccsd(nroots=3),
        ip_hermi=gh.ipgfccsd(nroots=2), rdm1=g.make_rdm1())


@pytest.fixture(scope="module")
def port(ref):
    """The port's driver holding the JAX state."""
    mf = RHF(gto.M(atom=H2O, basis="sto-3g", unit="angstrom"))
    mf.conv_tol = 1e-12
    mf.kernel()
    mf.mo_coeff = ref["mo"]
    cc = CCSD(mf, device=CPU)
    cc.eris = eris_mod.make_eris_incore(*ref["args"], device=CPU)
    cc.t1, cc.t2, cc.l1, cc.l2 = convert.tensors_from_numpy(*ref["amps"],
                                                            device=CPU)
    return cc


def _moments(port, which):
    build = gf.build_hole_moments if which == "hole" else \
        gf.build_part_moments
    return build(port.t1, port.t2, port.l1, port.l2, port.eris, NITER,
                 chunk_size=4)


@pytest.mark.parametrize("which", ["hole", "part"])
def test_moments_match_jax(ref, port, which):
    m = _moments(port, which)
    want = ref["mh" if which == "hole" else "mp"]
    assert m.shape == want.shape == (2 * NITER + 2, 7, 7)
    for a, b in zip(m, want):
        assert np.abs(a - b).max() < 1e-10 * np.abs(b).max()


def test_poles_and_weights_match_jax(ref, port):
    g = gf.MomGFCCSD(port, niter=(NITER, NITER))
    g.kernel(hole_moments=ref["mh"], part_moments=ref["mp"])
    for got, want in ((g.ipgfccsd(nroots=3), ref["ip"]),
                      (g.eagfccsd(nroots=3), ref["ea"])):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
    assert max(g.moment_errors(ref["mh"], g.eh, g.vh)) < 1e-6


def test_hermitian_solver_and_rdm1_match_jax(ref, port):
    g = gf.MomGFCCSD(port, niter=(1, 1))
    g.hermi_moments = g.hermi_solver = True
    g.kernel()
    for a, b in zip(g.ipgfccsd(nroots=2), ref["ip_hermi"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
    np.testing.assert_allclose(g.make_rdm1(), ref["rdm1"], rtol=0,
                               atol=1e-12)


def test_chk_roundtrip(port, tmp_path):
    g = gf.MomGFCCSD(port, niter=(1, 1))
    g.kernel()
    p = str(tmp_path / "gf.h5")
    g.dump_chk(p)
    g2 = gf.MomGFCCSD(port, niter=(1, 1)).update_from_chk_(p)
    for a, b in ((g2.eh, g.eh), (g2.ep, g.ep), (g2.vh[0], g.vh[0]),
                 (g2.vp[1], g.vp[1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert g2.ipgfccsd(nroots=1)[0][0] == g.ipgfccsd(nroots=1)[0][0]
