"""lib/device_davidson (the Davidson with its subspace on the device,
which cc/eom.kernel_ee runs) against lib/linalg.davidson (the host copy of
the JAX package's) and the dense eigensolver, in fp64 on the CPU.

Operators: seeded diagonally dominant matrices of size 300, symmetric
and not (a small non-symmetric part, so a real spectrum, as EOM's), as
matvec closures over tensors; a small max_space forces the restarts.
Tolerances: eigenvalues within 1e-9 of the host copy's and of numpy's
(the lowest for pick='lowest', the nearest for 'follow', which tracks
its roots from the guesses), with the Davidson to 1e-8 in the residual;
eigenvectors the same up to sign within 1e-7; and the matvecs within
nroots of the host copy's.
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu_torch.lib import device_davidson
from pyscf_mpcc_tpu_torch.lib.linalg import davidson as host_davidson

N = 300


def _operator(hermitian, seed=3):
    rng = np.random.default_rng(seed)
    a = 1e-2 * rng.standard_normal((N, N))
    a = a + a.T
    if not hermitian:
        a += 1e-3 * rng.standard_normal((N, N))
    a[np.diag_indices(N)] = np.linspace(0.1, 3.0, N) \
        + 1e-3 * rng.standard_normal(N)
    return a


def _guesses(diag, k):
    out = []
    for i in np.argsort(diag)[:k]:
        v = np.zeros(N)
        v[i] = 1.0
        out.append(v)
    return out


def _run_both(a, nroots, **kw):
    diag = np.diag(a).copy()
    x0 = _guesses(diag, nroots)
    host_log, dev_log = [], []

    def host_mv(v):
        host_log.append(1)
        return a @ v

    at = torch.as_tensor(a)

    def dev_mv(v):
        dev_log.append(1)
        return at @ v

    host = host_davidson(host_mv, x0, diag, nroots=nroots, **kw)
    dev = device_davidson.davidson(dev_mv, x0, torch.as_tensor(diag),
                                   nroots=nroots, **kw)
    return host, dev, len(host_log), len(dev_log)


@pytest.mark.parametrize("hermitian", [True, False])
@pytest.mark.parametrize("pick", ["lowest", "follow"])
@pytest.mark.parametrize("max_space", [None, 8])
def test_matches_the_host_copy(hermitian, pick, max_space):
    a = _operator(hermitian)
    nroots = 3
    (hc, he, hv), (dc, de, dv), nh, nd = _run_both(
        a, nroots, tol=1e-8, hermitian=hermitian, pick=pick,
        max_space=max_space, max_cycle=200)
    assert all(hc) and all(dc)
    np.testing.assert_allclose(de, he, rtol=0, atol=1e-9)
    spectrum = np.sort(np.linalg.eigvals(a).real)
    if pick == "lowest":
        np.testing.assert_allclose(de, spectrum[:nroots], rtol=0, atol=1e-9)
    else:
        assert all(np.abs(spectrum - x).min() < 1e-9 for x in de)
    for h, d in zip(hv, dv):
        d = d.numpy()
        h, d = h / np.linalg.norm(h), d / np.linalg.norm(d)
        assert min(np.abs(h - d).max(), np.abs(h + d).max()) < 1e-7
    assert abs(nd - nh) <= nroots


def test_vectors_stay_on_the_diag_device_and_dtype():
    a = _operator(True)
    diag = torch.as_tensor(np.diag(a).copy())
    at = torch.as_tensor(a)
    conv, e, vecs = device_davidson.davidson(
        lambda v: at @ v, _guesses(diag.numpy(), 2), diag, nroots=2,
        tol=1e-8, hermitian=True)
    assert all(conv) and len(e) == 2
    assert all(v.dtype == torch.float64 and v.device == diag.device
               and v.shape == (N,) for v in vecs)


def test_verbose_prints_one_line_a_cycle(capsys):
    a = _operator(False)
    diag = np.diag(a).copy()
    at = torch.as_tensor(a)
    device_davidson.davidson(lambda v: at @ v, _guesses(diag, 2),
                             torch.as_tensor(diag), nroots=2, tol=1e-8,
                             verbose=1)
    lines = capsys.readouterr().out.splitlines()
    assert lines and all(ln.startswith("davidson cycle ") for ln in lines)
