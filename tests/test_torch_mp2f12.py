"""The port's host copy of mp/mp2f12.py (the STG-nG fit, CABS, the
MP2-F12/SP correction over the port's native integral engine) against the
JAX package's, in fp64 on the CPU.

Inputs: He/cc-pVDZ with a small even-tempered CABS, and H2/cc-pVDZ with
the cc-pVDZ-F12-OptRI auxiliary basis (the JAX package's test_mp2f12.py
systems), the port's own RHF against the JAX package's.  Tolerances: the
fit 1e-14 (the same NumPy code), CABS orthonormality 1e-10, the F12
energies 1e-10 Ha (the same code; the native engine's thread order may
move the last bits) and the H2 total within the JAX test's CBS window.
"""

import numpy as np
import pytest

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu.mp import mp2f12 as jf12
from pyscf_mpcc_tpu_torch import gto, scf
from pyscf_mpcc_tpu_torch.mp import mp2f12

HE_AUX = {"He": [[0, [0.5, 1.0]], [1, [1.2, 1.0]], [2, [1.5, 1.0]]]}
H2 = "H 0 0 0; H 0 0 0.7414"
# (atom, basis, aux basis, zeta)
SYSTEMS = {"he": ("He 0 0 0", "cc-pvdz", HE_AUX, 1.0),
           "h2": (H2, "cc-pvdz", "cc-pvdz-f12-optri", 1.1)}


def test_stg_fit_matches_jax():
    np.testing.assert_allclose(np.asarray(mp2f12.stg_fit()),
                               np.asarray(jf12.stg_fit()), rtol=0,
                               atol=1e-14)


def _f12(pkg_gto, pkg_scf, pkg, name):
    atom, basis, aux, zeta = SYSTEMS[name]
    mol = pkg_gto.M(atom=atom, basis=basis, unit="angstrom")
    mf = pkg_scf.RHF(mol)
    mf.conv_tol = 1e-12
    mf.kernel()
    auxmol = pkg_gto.M(atom=atom, basis=aux, unit="angstrom")
    return mf, auxmol, pkg.energy_f12(mf, auxmol, zeta=zeta)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_energy_f12_matches_jax(name):
    mf, auxmol, e = _f12(gto, scf, mp2f12, name)
    _, _, je = _f12(jgto, jscf, jf12, name)
    assert e < 0
    assert abs(e - je) < 1e-10
    big, perm, cabs = mp2f12.find_cabs(mf.mol, auxmol)
    s_big = gto.intor_ovlp(big)[np.ix_(perm, perm)]
    assert cabs.shape[1] > 0
    np.testing.assert_allclose(cabs.T @ s_big @ cabs, np.eye(cabs.shape[1]),
                               atol=1e-10)
