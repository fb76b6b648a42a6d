"""The port's open-shell SCF (UHF, ROHF, convert_to_uhf, the energy-DIIS
schemes; copies of the JAX package's host NumPy code) against the JAX
package.

Molecules: O2 triplet/sto-3g (UHF, ROHF, DF-UHF) and H2O/sto-3g (closed
shell through UHF, and the DIIS schemes), the JAX package's
tests/test_scf.py ones.  Both packages run the same host fp64 NumPy code
on the same integrals, so energies agree to 1e-10 and orbital energies to
1e-8 (the JAX references are computed once, in a module fixture).
"""

import numpy as np
import pytest

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu_torch import gto, scf

O2 = "O 0 0 0; O 0 0 1.21"
H2O = [[8, (0, 0, 0)], [1, (0, -0.757, 0.587)], [1, (0, 0.757, 0.587)]]
# the JAX package's ROHF pin, tests/test_scf.py:37
E_ROHF_O2 = -147.63227466131738
SCHEMES = ("ediis", "adiis", "ediis+cdiis", "adiis+cdiis")


def _run(g, s, cls, atom, spin=0, df=False, scheme="cdiis", conv=1e-11):
    mol = g.M(atom=atom, basis="sto-3g", spin=spin)
    mf = getattr(s, cls)(mol)
    if df:
        mf.density_fit()
    mf.conv_tol = conv
    mf.diis_scheme = scheme
    mf.max_cycle = 200
    mf.kernel()
    return mf


CASES = {
    "uhf_o2": ("UHF", O2, 2, False, "cdiis"),
    "rohf_o2": ("ROHF", O2, 2, False, "cdiis"),
    "uhf_o2_df": ("UHF", O2, 2, True, "cdiis"),
    "uhf_h2o": ("UHF", H2O, 0, False, "cdiis"),
    "rhf_h2o": ("RHF", H2O, 0, False, "cdiis"),
    "uhf_o2_adiis+cdiis": ("UHF", O2, 2, False, "adiis+cdiis"),
    **{f"rhf_h2o_{s}": ("RHF", H2O, 0, False, s) for s in SCHEMES},
}


@pytest.fixture(scope="module")
def ref():
    return {k: _run(jgto, jscf, *v) for k, v in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_scf_matches_jax(ref, case):
    mf = _run(gto, scf, *CASES[case])
    jmf = ref[case]
    assert mf.converged and jmf.converged
    assert type(mf).__name__ == CASES[case][0]
    assert abs(mf.e_tot - jmf.e_tot) < 1e-10
    np.testing.assert_allclose(mf.mo_energy, jmf.mo_energy, atol=1e-8)
    np.testing.assert_allclose(mf.mo_occ, jmf.mo_occ, atol=0)


def test_closed_shell_uhf_is_rhf_and_rohf_pin(ref):
    assert abs(ref["uhf_h2o"].e_tot - ref["rhf_h2o"].e_tot) < 1e-10
    for s in SCHEMES:
        assert abs(ref[f"rhf_h2o_{s}"].e_tot - ref["rhf_h2o"].e_tot) < 1e-8
    rohf = _run(gto, scf, *CASES["rohf_o2"])
    assert abs(rohf.e_tot - E_ROHF_O2) < 1e-8
    assert ref["uhf_o2"].e_tot <= rohf.e_tot + 1e-9


@pytest.mark.parametrize("case", ["rhf_h2o", "rohf_o2"])
def test_convert_to_uhf_matches_jax(ref, case):
    mf = _run(gto, scf, *CASES[case])
    u, ju = scf.convert_to_uhf(mf), jscf.convert_to_uhf(ref[case])
    assert isinstance(u, scf.UHF) and u.e_tot == mf.e_tot
    for k in ("mo_coeff", "mo_energy", "mo_occ"):
        a, b = getattr(u, k), getattr(ju, k)
        assert a.shape == b.shape and a.ndim >= 2
    np.testing.assert_allclose(u.mo_occ, ju.mo_occ, atol=0)
    np.testing.assert_allclose(u.mo_energy, ju.mo_energy, atol=1e-8)
    np.testing.assert_allclose(u.make_rdm1(), ju.make_rdm1(), atol=1e-8)


def test_uhf_scanner_warm_start_matches_cold():
    mf = _run(gto, scf, *CASES["uhf_o2"])
    scan = mf.as_scanner()
    e = scan("O 0 0 0; O 0 0 1.25")
    cold = _run(gto, scf, "UHF", "O 0 0 0; O 0 0 1.25", 2)
    assert scan.converged and isinstance(scan.mf, scf.UHF)
    assert abs(e - cold.e_tot) < 1e-9
