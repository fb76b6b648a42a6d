"""Shared inputs of the open-shell parity tests (tests/test_torch_u*.py,
tests/test_torch_lambda_u.py, tests/test_torch_ump2.py).

Mean fields come from the JAX package's host SCF (the port's is the same
code, held to it in tests/test_torch_uhf.py); the numpy arrays they hold
(mo_coeff, AO Focks, AO integrals, DF factors) are what both packages
receive.  Molecules are the JAX package's test molecules: O2 triplet and
H2O in sto-3g, OH in cc-pVDZ.
"""

import numpy as np

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu import scf as jscf

O2 = "O 0 0 0; O 0 0 1.21"
H2O = [[8, (0, 0, 0)], [1, (0, -0.757, 0.587)], [1, (0, 0.757, 0.587)]]
OH = "O 0 0 0; H 0 0 0.97"


def mean_field(name):
    """A converged JAX-package mean field: 'o2' (UHF), 'o2_rohf', 'h2o'
    (RHF), 'h2o_uhf', 'o2_df' (DF-UHF) or 'oh' (UHF, cc-pVDZ)."""
    atom, basis, spin, cls, df = {
        "o2": (O2, "sto-3g", 2, "UHF", False),
        "o2_rohf": (O2, "sto-3g", 2, "ROHF", False),
        "o2_df": (O2, "sto-3g", 2, "UHF", True),
        "h2o": (H2O, "sto-3g", 0, "RHF", False),
        "h2o_uhf": (H2O, "sto-3g", 0, "UHF", False),
        "oh": (OH, "cc-pvdz", 1, "UHF", False),
    }[name]
    mol = jgto.M(atom=atom, basis=basis, spin=spin)
    mf = getattr(jscf, cls)(mol)
    if df:
        mf.density_fit()
    mf.conv_tol = 1e-12
    mf.conv_tol_grad = 1e-9
    mf.kernel()
    assert mf.converged
    return mf


def uhf_arrays(mf):
    """(mo_a, mo_b, focka_ao, fockb_ao, nocca, noccb) of a mean field (an
    RHF one twice)."""
    dm = mf.make_rdm1()
    na, nb = mf.mol.nelec
    if np.asarray(dm).ndim == 2:
        f = mf.get_fock(dm)
        return mf.mo_coeff, mf.mo_coeff, f, f, na, nb
    j, k = mf.get_jk(dm)
    h = mf.get_hcore()
    return (mf.mo_coeff[0], mf.mo_coeff[1], h + j[0] + j[1] - k[0],
            h + j[0] + j[1] - k[1], na, nb)


def cholesky(eri):
    """Exact Cholesky-like factors B[L,p,q] of the AO integrals."""
    nao = eri.shape[0]
    w, v = np.linalg.eigh(eri.reshape(nao * nao, nao * nao))
    keep = w > 1e-12
    return (v[:, keep] * np.sqrt(w[keep])).T.reshape(-1, nao, nao)


def fields(eris):
    """A JAX UERIs as {name: numpy | int | None}."""
    return {k: (None if v is None else
                (v if isinstance(v, int) else np.asarray(v)))
            for k, v in eris._asdict().items()}


def np_tuple(xs):
    return tuple(np.asarray(x) for x in xs)
