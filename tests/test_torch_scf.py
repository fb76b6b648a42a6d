"""The port's RHF (a copy of the JAX package's host RHF) against the JAX
package's RHF on H2O/cc-pVDZ, incore and density-fitted.  Both are host
NumPy fp64, so E_tot agrees to 1e-10.  UHF, ROHF and the energy-DIIS
schemes are held to the JAX package in tests/test_torch_uhf.py."""

import numpy as np
import pytest

from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu.testutil import mol_of
from pyscf_mpcc_tpu_torch import scf as tscf
from pyscf_mpcc_tpu_torch import testing

E_RHF_H2O_CCPVDZ = -76.026765673119627   # pyscf/scf/test/test_rhf.py:372


@pytest.mark.parametrize("df", [False, True])
def test_rhf_matches_jax_rhf(df):
    mfs = []
    for cls, mol in ((jscf.RHF, mol_of("sym")),
                     (tscf.RHF, testing.mol_of("sym"))):
        mf = cls(mol)
        if df:
            mf.density_fit()
        mf.conv_tol = 1e-12
        mfs.append(mf.run())
    jmf, tmf = mfs
    assert tmf.converged
    assert abs(tmf.e_tot - jmf.e_tot) < 1e-10
    np.testing.assert_allclose(tmf.mo_energy, jmf.mo_energy, atol=1e-8)
    if not df:
        assert abs(tmf.e_tot - E_RHF_H2O_CCPVDZ) < 1e-9
