"""The port's device DIIS ring (pyscf_mpcc_tpu_torch.lib.device_diis) and
rccsd.kernel(diis_backend='device') against the JAX package.

The ring runs for more cycles than its space, so it wraps, and for fewer,
so some of its slots stay empty.  fp64 on both
sides: the stored ring, the Gram matrix and the extrapolated vectors agree
to 1e-12 (the same products in another summation order; push's float32 G
is the fp64 Gram rounded once on both sides).  With a bf16 error ring both
sum the Gram matrix in fp32, and the extrapolations agree to 1e-6.  The
CCSD solve with the device ring reaches the JAX energy within 1e-10 in
the same number of sweeps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu.cc import rccsd as jrccsd
from pyscf_mpcc_tpu.cc.eris import RERIs as JRERIs
from pyscf_mpcc_tpu.lib import device_diis as jdd
from pyscf_mpcc_tpu_torch import convert
from pyscf_mpcc_tpu_torch.cc import rccsd as trccsd
from pyscf_mpcc_tpu_torch.lib import device_diis as tdd
from test_torch_rccsd import _fields

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-12
N, SPACE, CYCLES = 37, 4, 7


def _stream():
    """CYCLES (x, err) pairs of a contracting iteration, seeded."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(N)
    out = []
    for _ in range(CYCLES):
        x = 0.7 * x + 0.05 * rng.standard_normal(N)
        out.append((x.copy(), rng.standard_normal(N) * 10.0 ** -rng.integers(
            1, 4)))
    return out


def _t(x):
    return torch.tensor(x, dtype=torch.float64)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(convert.to_numpy(a), np.asarray(b), rtol=tol,
                               atol=tol * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("space", [SPACE, CYCLES + 2])
@pytest.mark.parametrize("step", ["push", "update_hostsolve"])
def test_ring_matches_jax(step, space):
    # space SPACE < CYCLES wraps the ring; CYCLES + 2 leaves slots empty
    js = jdd.init(N, space, jnp.float64)
    ts = tdd.init(N, space, torch.float64, device=CPU)
    for x, e in _stream():
        js, jout = getattr(jdd, step)(js, jnp.asarray(x), jnp.asarray(e))
        ts, tout = getattr(tdd, step)(ts, _t(x), _t(e))
        assert tout.dtype == (torch.float32 if step == "push"
                              else torch.float64)
        _close(tout, jout)
        if step == "push":
            coef = np.linspace(0.5, -0.25, space)
            _close(tdd.extrapolate(ts, _t(coef)),
                   jdd.extrapolate(js, jnp.asarray(coef)))
    assert int(ts.count) == int(js.count) == CYCLES
    _close(ts.xs, js.xs)
    _close(ts.errs, js.errs)


def test_bf16_error_ring_matches_jax():
    js = jdd.init(N, SPACE, jnp.float64, err_dtype=jnp.bfloat16)
    ts = tdd.init(N, SPACE, torch.float64, torch.bfloat16, device=CPU)
    assert ts.errs.dtype == torch.bfloat16 and ts.xs.dtype == torch.float64
    for x, e in _stream():
        js, jout = jdd.update_hostsolve(js, jnp.asarray(x), jnp.asarray(e))
        ts, tout = tdd.update_hostsolve(ts, _t(x), _t(e))
        # both round the errors to bf16 once and sum the Gram matrix in
        # fp32, in different orders: G agrees to a few fp32 roundoffs
        # (6e-8 each), and the small B solve passes that on; 1e-6
        _close(tout, jout, 1e-6)
    np.testing.assert_array_equal(
        ts.errs.double().numpy(), np.asarray(js.errs.astype(jnp.float64)))


def test_gram_chunks_match_one_product(monkeypatch):
    # the Gram matrix summed over chunks of the vector equals one product
    ts = tdd.init(N, SPACE, torch.float64, device=CPU)
    for x, e in _stream()[:SPACE]:
        ts, _ = tdd.push(ts, _t(x), _t(e))
    whole = tdd._gram(ts.errs, torch.ones(SPACE, dtype=torch.float64),
                      torch.float64)
    monkeypatch.setattr(tdd, "_CHUNK", 5)
    chunked = tdd._gram(ts.errs, torch.ones(SPACE, dtype=torch.float64),
                        torch.float64)
    _close(chunked, convert.to_numpy(whole))


def _counting(monkeypatch, mod):
    calls = []
    orig = mod.update_amps

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(mod, "update_amps", counted)
    return calls


def test_ccsd_device_diis_matches_jax(monkeypatch):
    f = _fields("df_direct")
    je = JRERIs(**{k: None if v is None else jnp.asarray(v)
                   for k, v in f.items()})
    kw = dict(conv_tol=1e-11, conv_tol_normt=1e-9, max_cycle=60, ntile=3,
              diis_backend="device")
    jcalls = _counting(monkeypatch, jrccsd)
    jconv, je_corr, *_ = jrccsd.kernel(je, **kw)
    tcalls = _counting(monkeypatch, trccsd)
    tconv, te_corr, t1, t2 = trccsd.kernel(convert.eris_from_numpy(f, CPU),
                                           **kw)
    assert jconv and tconv
    assert abs(te_corr - float(je_corr)) < 1e-10
    assert len(tcalls) == len(jcalls) > 2
    assert t1.dtype == torch.float64
