"""The port's (T) design probes (pyscf_mpcc_tpu_torch.tools) against the
JAX package's probe scripts, on the CPU.

- The JAX probes run unchanged at o, T, F, OO = 4, 2, 16, 128 with their
  module patched: ``pl.pallas_call`` runs in interpret mode without
  compiler params, ``fence`` records each value and ``timeit`` makes one
  call.  p1, p3 and p4 then give the values of their Pallas kernels on
  ones, and the port's probes (plain versions, fp64) must give the same
  values exactly.  p2 is not run in interpret mode (its bisect allocates
  up to 512 MiB); the port's p2 is held to its closed form, x[0, 0].
- The slab kernel of ``tools/slab_loop_probe.py`` runs in interpret mode at
  its full size on the script's input; the port's relayout must give the
  same scalar exactly.
- Beyond the JAX values, seeded numpy inputs hold the plain versions to
  numpy: p3's modes 'f32', 'bf16' (operands rounded to bf16) and 'split'
  (bf16 hi/lo, three products) with the per-tile checksum, p4's sums and
  the slab relayout (np.transpose, bitwise).  fp64 on both sides; the bf16
  products are exact in fp64, so rtol 1e-12 covers the summation order.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl
from jax.experimental.pallas import tpu as pltpu

import tools.slab_loop_probe as jslab
import tools.triples_probe_v6 as jprobe
from pyscf_mpcc_tpu_torch import convert
from pyscf_mpcc_tpu_torch.tools import slab_loop_probe as slab
from pyscf_mpcc_tpu_torch.tools import triples_probe_v6 as probe

torch.set_num_threads(1)

CPU = torch.device("cpu")
SMALL = dict(o=4, T=2, F=16, OO=128)
MODES = ("bf16", "split", "f32")
RTOL = 1e-12


def _interpret_pl():
    """A stand-in for the pallas module: pallas_call in interpret mode,
    without the TPU's compiler params."""
    def pallas_call(kern, **kw):
        kw.pop("compiler_params", None)
        return jpl.pallas_call(kern, interpret=True, **kw)
    return SimpleNamespace(pallas_call=pallas_call, BlockSpec=jpl.BlockSpec,
                           when=jpl.when, program_id=jpl.program_id)


@pytest.fixture(scope="module")
def jax_values():
    """{probe: [values fenced by the JAX probe]} at the SMALL constants."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SMALL.items():
            mp.setattr(jprobe, k, v)
        mp.setattr(jprobe, "pl", _interpret_pl())
        vals = []

        def fence(x):
            vals.append(float(np.asarray(x).ravel()[0]))
            return vals[-1]

        def timeit(fn, *args, n=20):
            jprobe.fence(fn(*args))
            return 1.0

        mp.setattr(jprobe, "fence", fence)
        mp.setattr(jprobe, "timeit", timeit)
        for name, fn in (("p1", jprobe.p1_dispatch), ("p3", jprobe.p3_dots),
                         ("p4", jprobe.p4_stream)):
            vals.clear()
            fn()
            out[name] = list(vals)
    return out


@pytest.fixture
def small(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(probe, k, v)


@pytest.fixture(scope="module")
def port_p3():
    """The port's p3 result at the SMALL constants (plain versions)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SMALL.items():
            mp.setattr(probe, k, v)
        return probe.p3_dots(CPU)


def test_p1_matches_jax_probe(jax_values, small):
    res = probe.p1_dispatch(CPU)
    assert jax_values["p1"] == [1.0, 1.0]
    assert [r["value"] for r in res.values()] == jax_values["p1"]
    assert all(r["ms"] is None and r["rate"] is None for r in res.values())


@pytest.mark.parametrize("mode", MODES)
def test_p3_matches_jax_probe(jax_values, port_p3, mode):
    o, T, F = SMALL["o"], SMALL["T"], SMALL["F"]
    assert jax_values["p3"] == [float(6 * T * F)] * 3
    OO = SMALL["OO"]
    shapes = {"A": (T * o, F, T * OO), "B": (T * T * o, F, OO),
              "A1": (T * o, F, OO)}
    assert [port_p3[f"{tag}/{mode}"]["value"] for tag in shapes] == \
        jax_values["p3"]
    for tag, (M, K, N) in shapes.items():
        r = port_p3[f"{tag}/{mode}"]
        assert r["flops"] == 2.0 * M * K * N * 6 * T
        assert r["bytes_unique"] == (M * K + K * N) * 8
        assert r["ms"] is None


def test_p4_matches_jax_probe(jax_values, small):
    res = probe.p4_stream(CPU)["fetch"]
    assert jax_values["p4"] == [float(SMALL["OO"] + SMALL["F"])]
    assert res["value"] == jax_values["p4"][0]
    o, T, F, OO = (SMALL[k] for k in ("o", "T", "F", "OO"))
    assert res["bytes"] == (3 * T * F * OO + 6 * T * T * o * F) * 8


def test_p2_closed_form(small):
    res = probe.p2_smem(CPU)["cap"]
    assert res["value"] == 1.0 and res["cap"] is None
    x = torch.tensor(np.random.default_rng(3).standard_normal((8, 128)))
    for nbytes in (4096, 232448):
        assert probe.smem_copy(x, nbytes).item() == x[0, 0].item()
    assert probe.dispatch(x[:1, :1], (2, 2)).item() == x[0, 0].item()


def test_slab_matches_jax_kernel():
    o, T = jslab.o, jslab.T
    assert (slab.o, slab.T) == (o, T)
    f = jpl.pallas_call(
        jslab.kern,
        in_specs=[jpl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=jpl.BlockSpec(memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        scratch_shapes=[pltpu.VMEM((T, o, T, o * o), jnp.float32),
                        pltpu.VMEM((T, T, o, o, o), jnp.float32)],
        interpret=True)
    w32 = np.asarray(jnp.arange(T * o * T * o * o, dtype=jnp.float32)
                     .reshape(T, o, T, o * o) * 1e-6)
    jval = float(np.asarray(f(jnp.asarray(w32)))[0, 0])
    # the port's probe input is the JAX script's, bit for bit
    pw = slab.probe_input(CPU, torch.float32)
    assert np.array_equal(convert.to_numpy(pw), w32)
    out = slab.relayout(torch.tensor(w32))
    assert slab.probe_value(out).item() == jval
    res = slab.main(CPU)
    assert res["value"] == res["expect"] and res["ms"] is None


def _bf16(x):
    """Round float32 values to bf16 (nearest, ties to even), as float32."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _np_dot(a, b, mode):
    if mode == "f32":
        return a @ b
    ah, bh = _bf16(a), _bf16(b)
    al = _bf16(a.astype(np.float32) - ah)
    bl = _bf16(b.astype(np.float32) - bh)

    def d(x, y):
        return x.astype(np.float64) @ y.astype(np.float64)

    return d(ah, bh) if mode == "bf16" else d(ah, bh) + d(ah, bl) + d(al, bh)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(136, 40, 300), (128, 424, 256)])
def test_p3_plain_matches_numpy(mode, shape):
    M, K, N = shape
    rng = np.random.default_rng(7)
    # float32 values, so that hi/lo are one rounding each on both sides
    a = rng.uniform(-1, 1, (M, K)).astype(np.float32).astype(np.float64)
    b = rng.uniform(-1, 1, (K, N)).astype(np.float32).astype(np.float64)
    reps = 5
    out, cs = probe.dots(torch.tensor(a), torch.tensor(b), mode, reps)
    w = _np_dot(a, b, mode)
    np.testing.assert_allclose(convert.to_numpy(out), reps * w[:, :128],
                               rtol=RTOL, atol=1e-13)
    mt, nt = -(-M // 128), -(-N // 128)
    wp = np.zeros((mt * 128, nt * 128))
    wp[:M, :N] = w
    np.testing.assert_allclose(
        convert.to_numpy(cs),
        reps * wp.reshape(mt, 128, nt, 128).sum(axis=(1, 3)),
        rtol=RTOL, atol=1e-10)
    # the modes differ, so a mixed-up mode would show
    if mode != "f32":
        assert np.abs(w - a @ b).max() > 1e-6


def test_p3_plain_rejects_unknown_mode():
    x = torch.ones(4, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown mode"):
        probe.dots(x, x, "tf32", 1)


def test_stream_plain_matches_numpy():
    rng = np.random.default_rng(11)
    t2 = rng.standard_normal((3, 2, 16, 128))
    ov = rng.standard_normal((6, 2, 2, 4, 16))
    value, partial = probe.stream_sum(torch.tensor(t2), torch.tensor(ov))
    assert partial.dtype == torch.float64
    np.testing.assert_allclose(partial.sum().item(), t2.sum() + ov.sum(),
                               rtol=RTOL)
    np.testing.assert_allclose(value.item(),
                               t2[0, 0, 0].sum() + ov[0, 0, 0, 0].sum(),
                               rtol=RTOL)


@pytest.mark.parametrize("o,T", [(4, 2), (8, 3), (32, 8)])
def test_slab_plain_matches_numpy_transpose(o, T):
    w = np.random.default_rng(o).standard_normal((T, o, T, o * o))
    out = slab.relayout(torch.tensor(w))
    ref = np.transpose(w.reshape(T, o, T, o, o), (0, 2, 3, 1, 4))
    assert np.array_equal(convert.to_numpy(out), ref)


def test_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slab.main()
