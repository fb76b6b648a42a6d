"""The port's device DF J/K (scf/hf._JKDF(b3c, device=...)) against its
host path and the JAX package's, and utils/profiling's trace, on the CPU.

Input: H2O/cc-pVDZ with the port's DF factors, RHF and UHF densities.
The device branch runs its four contractions with torch on the given
device (here the CPU, in fp64) and must equal the host NumPy path to
1e-12 (the same contractions in another order); a DF-RHF and a DF-UHF
run on it converge to the host run's energy within 1e-10 Ha.  Without a
card, device=True raises.
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu.scf.hf import _JKDF as JJKDF
from pyscf_mpcc_tpu_torch import df, gto, scf, utils
from pyscf_mpcc_tpu_torch.scf.hf import _JKDF

CPU = torch.device("cpu")
ATOM = [[8, (0., 0., 0.)], [1, (0., -0.757, 0.587)], [1, (0., 0.757, 0.587)]]


@pytest.fixture(scope="module")
def mol():
    return gto.M(atom=ATOM, basis="cc-pvdz")


def test_device_jk_matches_host_and_jax(mol):
    B = df.DF(mol).B_ao()
    rng = np.random.default_rng(3)
    c = rng.standard_normal((mol.nao, 5))
    dm = c @ c.T
    dms = np.stack([dm, 0.5 * dm])
    host = _JKDF(B)
    dev = _JKDF(B, device=CPU)
    jax_host = JJKDF(B)
    assert dev._Bd.dtype == torch.float64
    for d in (dm, dms):
        j0, k0 = host.get_jk(d)
        j1, k1 = dev.get_jk(d)
        j2, k2 = jax_host.get_jk(d)
        assert j1.dtype == np.float64 and j1.shape == j0.shape
        for got, want in ((j1, j0), (k1, k0), (j0, j2), (k0, k2)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _JKDF(B, device=True)


@pytest.mark.parametrize("cls", ["RHF", "UHF"])
def test_scf_on_device_jk_matches_host(mol, cls):
    ref = getattr(scf, cls)(mol).density_fit()
    ref.conv_tol = 1e-12
    ref.kernel()
    mf = getattr(scf, cls)(mol).density_fit()
    mf.conv_tol = 1e-12
    mf.with_df.build()
    mf._jk = _JKDF(mf.with_df.B_ao(), device=CPU)
    mf.kernel()
    assert mf.converged
    assert abs(mf.e_tot - ref.e_tot) < 1e-10


def test_profiling_trace_and_utilization(tmp_path):
    """trace() writes the profiler's rows and the program's spans and
    counters (the "program" process: host and device rows, a counter's
    total) into trace.json."""
    import json
    a = torch.randn(64, 64, dtype=torch.float64)
    with utils.trace(str(tmp_path)) as prof:
        with utils.span("outer"):
            utils.count("mm", 2)
            with utils.span("mm", device=True):
                (a @ a).sum()
    assert any("mm" in e.key for e in prof.key_averages())
    spans, counts = utils.session()
    assert [s.name for s in spans] == ["outer", "mm"]
    assert counts == {"mm": 2}
    doc = json.load(open(tmp_path / "trace.json"))
    rows = {(e["name"], e["tid"]) for e in doc["traceEvents"]
            if e.get("pid") == utils.profiling.PROGRAM_PID
            and e["ph"] == "X"}
    assert rows == {("outer", 0), ("mm", 0), ("mm", 1)}
    assert [(e["name"], e["args"]) for e in doc["traceEvents"]
            if e.get("pid") == utils.profiling.PROGRAM_PID
            and e["ph"] == "C"] == [("mm", {"mm": 2})]
    assert not hasattr(utils, "report_utilization")
