"""The port's host copy of scf/ghf.py (GHF, convert_to_ghf) against the
JAX package's and against the port's RHF/UHF, in fp64 on the CPU.

Inputs: H2O/sto-3g and 6-31g, O2 triplet/sto-3g and OH/sto-3g (the JAX
package's test_ghf.py and test_gccsd_t_rdm.py molecules).  Tolerances:
GHF energies 1e-10 against the JAX package's GHF (the same NumPy code),
1e-9 against RHF/UHF (the JAX test's bound), convert_to_ghf 1e-10.
"""

import numpy as np
import pytest

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu_torch import gto, scf

H2O = [[8, (0, 0, 0)], [1, (0, -0.757, 0.587)], [1, (0, 0.757, 0.587)]]
O2 = "O 0 0 0; O 0 0 1.21"
OH = "O 0 0 0; H 0 0 0.97"
# (atom, basis, spin, density_fit)
SYSTEMS = {"h2o": (H2O, "6-31g", 0, False), "o2": (O2, "sto-3g", 2, False),
           "oh": (OH, "sto-3g", 1, False), "h2o_df": (H2O, "sto-3g", 0, True)}


def _run(pkg_gto, pkg_scf, name, cls="GHF"):
    atom, basis, spin, df = SYSTEMS[name]
    mf = getattr(pkg_scf, cls)(pkg_gto.M(atom=atom, basis=basis, spin=spin))
    if df:
        mf = mf.density_fit()
    mf.conv_tol = 1e-12
    mf.kernel()
    assert mf.converged
    return mf


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_ghf_matches_jax_and_collinear_reference(name):
    mf = _run(gto, scf, name)
    jmf = _run(jgto, jscf, name)
    assert isinstance(mf, scf.GHF)
    assert abs(mf.e_tot - jmf.e_tot) < 1e-10
    np.testing.assert_allclose(mf.mo_energy, jmf.mo_energy, rtol=0,
                               atol=1e-8)
    # collinear anchor: RHF for closed shells, UHF otherwise (GHF may only
    # go lower, and these systems have nothing lower)
    ref = _run(gto, scf, name, "RHF" if SYSTEMS[name][2] == 0 else "UHF")
    assert mf.e_tot < ref.e_tot + 1e-9
    assert abs(mf.e_tot - ref.e_tot) < 1e-9


@pytest.mark.parametrize("name,cls", [("h2o", "RHF"), ("o2", "UHF")])
def test_convert_to_ghf_preserves_energy(name, cls):
    mf = _run(gto, scf, name, cls)
    mg = scf.convert_to_ghf(mf)
    jmg = jscf.convert_to_ghf(_run(jgto, jscf, name, cls))
    assert isinstance(mg, scf.GHF)
    assert abs(mg.e_tot - mf.e_tot) < 1e-10
    assert abs(mg.e_tot - jmg.e_tot) < 1e-10
    np.testing.assert_array_equal(mg.mo_occ, jmg.mo_occ)
