"""The port's (T) (pyscf_mpcc_tpu_torch.cc.ccsd_t, ops.triples_combine)
against the JAX package.

- The plain version of the fused epilogue, tile_energy_fused_reference,
  against the JAX Pallas kernel tile_energy_fused(interpret=True) and its
  chunk form, on identical W_PLAN inputs (the port's fused prep, handed to
  both as numpy), at tile=3 with padded virtuals.
- The port's ccsd_t.kernel, engines 'xla' and 'fused', against the JAX
  ccsd_t.kernel(engine='xla') over tiles 3, 5 and 8.
- The pinned E(T) of the distorted H2O/cc-pVDZ geometry, through the
  'xla', 'fused' and 'resident' engines.

fp64 on both sides; tolerance rtol 1e-10 / atol 1e-13 (summation order).
"""

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu.cc import ccsd_t as jccsd_t
from pyscf_mpcc_tpu.ops import triples_combine as jtc
from pyscf_mpcc_tpu_torch import convert, testing
from pyscf_mpcc_tpu_torch.cc import ccsd_t
from pyscf_mpcc_tpu_torch.cc.driver import CCSD
from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
from pyscf_mpcc_tpu_torch.scf import RHF

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-10, 1e-13
E_T_REF = -0.0033300722704016289   # pyscf/cc/ccsd_t.py:255 (tilt geometry)
ACT = dict(act_hole=[0, 2], act_particle=[1, 3, 4])
PROBLEMS = {"ovvv": dict(seed=7), "df": dict(seed=13, naux=11)}
MODES = [None, "exclude_active", "only_active"]


def _problem(name):
    return testing.random_triples_problem(3, 7, **PROBLEMS[name])


def _port(name):
    return testing.triples_tensors(*_problem(name), CPU, torch.float64)


def _jax(name):
    t1, t2, f = _problem(name)
    return (jnp.asarray(t1), jnp.asarray(t2),
            SimpleNamespace(**{k: None if v is None else jnp.asarray(v)
                               for k, v in f.items()}))


def _prep(name, mode, tile=3):
    """The port's fused-prep outputs for every tile triple."""
    t1, t2, er = _port(name)
    act = ACT if mode else dict(act_hole=None, act_particle=None)
    big = ccsd_t._prepare(t1, t2, er, tile, torch.float64, act["act_hole"],
                          act["act_particle"], 1.0, "fused")
    prep = ccsd_t.make_prep_fused(big)
    eijk, actocc = ccsd_t.fused_shared(big)
    trips = ccsd_t._tile_triples(big["nvp"] // tile)
    return [prep(abc) for abc in trips], eijk, actocc


def _np(x):
    return [_np(y) for y in x] if isinstance(x, (list, tuple)) \
        else jnp.asarray(convert.to_numpy(x))


@pytest.fixture(scope="module")
def epilogue_cases():
    """Per (problem, mode): the port's prep and the JAX interpret-mode
    kernel's energies, single-tile for tiles 0-3 and chunked (K=4 over
    tiles 0-3, K=1 over tile 5)."""
    out = {}
    for mode in MODES:
        # one jitted wrapper per entry and mode: the interpret-mode kernel
        # is traced once per shape instead of once per call
        single_fn = jax.jit(partial(jtc.tile_energy_fused, interpret=True,
                                    act_mode=mode))
        chunk_fn = jax.jit(partial(jtc.tile_energy_fused_chunk,
                                   interpret=True, act_mode=mode))
        for name in PROBLEMS:
            outs, eijk, actocc = _prep(name, mode)
            jeijk = _np(eijk)
            jkw = dict(actocc=_np(actocc)) if mode else {}
            single = []
            for o in outs[:4]:
                kw = dict(jkw, actv=_np(o[10])) if mode else {}
                single.append(float(single_fn(*_np(o[:8]), jeijk,
                                              *_np(o[8:10]), **kw)))
            chunks = {}
            for K, sl in ((4, slice(0, 4)), (1, slice(5, 6))):
                st = ccsd_t.stack_prep(outs[sl])
                kw = dict(jkw, actv=_np(st[10])) if mode else {}
                chunks[K] = np.asarray(chunk_fn(*_np(st[:8]), jeijk,
                                                *_np(st[8:10]), **kw))
            out[(name, mode)] = (outs, eijk, actocc, single, chunks)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_epilogue_matches_pallas_interpret(epilogue_cases, name, mode):
    outs, eijk, actocc, single, _ = epilogue_cases[(name, mode)]
    assert max(abs(e) for e in single) > 1e-8     # non-degenerate tiles
    for o, ref in zip(outs, single):
        kw = dict(actv=o[10], actocc=actocc, act_mode=mode) if mode else {}
        e = tc.tile_energy_fused(*o[:8], eijk, *o[8:10], **kw)
        assert e.dtype == torch.float64 and e.dim() == 0
        np.testing.assert_allclose(float(e), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_chunk_matches_pallas_interpret(epilogue_cases, name, mode, K):
    outs, eijk, actocc, _, chunks = epilogue_cases[(name, mode)]
    st = ccsd_t.stack_prep(outs[:4] if K == 4 else outs[5:6])
    kw = dict(actv=st[10], actocc=actocc, act_mode=mode) if mode else {}
    e = tc.tile_energy_fused_chunk(*st[:8], eijk, *st[8:10], **kw)
    assert e.shape == (K,)
    np.testing.assert_allclose(convert.to_numpy(e), chunks[K], rtol=RTOL,
                               atol=ATOL)


def test_emit_w_dot_matches_jax():
    rng = np.random.default_rng(3)
    T, o, nvp = 3, 4, 6
    ovb = rng.standard_normal((T, T, o, nvp))
    t2op = rng.standard_normal((T, nvp, o * o))
    for p in tc.PERMS:
        ref = np.asarray(jtc.emit_w_dot(p, jnp.asarray(ovb),
                                        jnp.asarray(t2op), jnp.float64,
                                        T, o))
        out = tc.emit_w_dot(p, torch.tensor(ovb), torch.tensor(t2op),
                            torch.float64, T, o)
        assert out.is_contiguous()
        np.testing.assert_allclose(convert.to_numpy(out), ref, rtol=RTOL,
                                   atol=ATOL)


@pytest.fixture(scope="module")
def jax_energies():
    """JAX ccsd_t.kernel(engine='xla') per (problem, tile, mode)."""
    out = {}
    for name in PROBLEMS:
        for tile in (3, 5, 8):
            out[(name, tile, None)] = jccsd_t.kernel(*_jax(name), tile=tile,
                                                     engine="xla")
        for mode in MODES[1:]:
            out[(name, 3, mode)] = jccsd_t.kernel(*_jax(name), tile=3,
                                                  engine="xla", mode=mode,
                                                  **ACT)
    return out


@pytest.mark.parametrize("engine", ["xla", "fused"])
@pytest.mark.parametrize("tile", [3, 5, 8])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_kernel_matches_jax_xla(jax_energies, name, tile, engine):
    ref = jax_energies[(name, tile, None)]
    assert abs(ref) > 1e-8
    e = ccsd_t.kernel(*_port(name), tile=tile, engine=engine)
    np.testing.assert_allclose(e, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("mode", MODES[1:])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_kernel_active_mask_matches_jax_xla(jax_energies, name, mode,
                                            chunk):
    ref = jax_energies[(name, 3, mode)]
    e = ccsd_t.kernel(*_port(name), tile=3, engine="fused", mode=mode,
                      chunk=chunk, **ACT)
    np.testing.assert_allclose(e, ref, rtol=RTOL, atol=ATOL)
    e = ccsd_t.kernel(*_port(name), tile=3, engine="xla", mode=mode, **ACT)
    np.testing.assert_allclose(e, ref, rtol=RTOL, atol=ATOL)


def test_unported_engines_raise():
    args = _port("df")
    for kw in (dict(engine="flat"), dict(mesh=object()),
               dict(dot_precision="high")):
        with pytest.raises(NotImplementedError):
            ccsd_t.kernel(*args, tile=3, **kw)
    with pytest.raises(ValueError):
        ccsd_t.kernel(*args, tile=3, engine="fused4")


def test_pinned_e_t():
    mf = RHF(testing.mol_of("tilt"))
    mf.conv_tol = 1e-13
    mf.conv_tol_grad = 1e-10
    mf.run()
    cc = CCSD(mf, device=CPU)
    cc.set(conv_tol=1e-12, conv_tol_normt=1e-10, max_cycle=200).run()
    assert cc.converged
    for engine in ("xla", "fused", "resident"):
        et = ccsd_t.kernel(cc.t1, cc.t2, cc.eris, tile=8, engine=engine)
        assert abs(et - E_T_REF) < 1e-10
