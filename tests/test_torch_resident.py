"""The port's resident (T) engine (ops.triples_resident, cc.ccsd_t
engine='resident') against the JAX package.

- The plain version tile_energy_resident_reference against the JAX Pallas
  kernel tile_energy_resident(interpret=True), on identical inputs (the
  port's resident prep, handed to both as numpy; JAX gets the bf16
  (hi, lo) split of the operands in mode 'split' and the hi part in mode
  'bf16', the port the operands unsplit), for the three modes and the
  three act modes.
- The port's ccsd_t.kernel(engine='resident') against the JAX
  ccsd_t.kernel(engine='resident', dot_precision=...) on incore and DF
  problems, the tile=4/nvir=7 padding case, vfac=2 and the act masks;
  and against the port's own 'xla' engine.

fp64 on both sides; rtol 1e-10 / atol 1e-13 (summation order only: the
bf16 products are exact in fp64 on both sides, so the tolerance holds in
modes 'split' and 'bf16' too).
"""

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu.cc import ccsd_t as jccsd_t
from pyscf_mpcc_tpu.ops import triples_resident as jtr
from pyscf_mpcc_tpu_torch import convert, testing
from pyscf_mpcc_tpu_torch.cc import ccsd_t
from pyscf_mpcc_tpu_torch.ops import triples_resident as tr

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-10, 1e-13
ACT = dict(act_hole=[0, 2], act_particle=[1, 3, 4])
ACT_MODES = [None, "exclude_active", "only_active"]
PRECISIONS = {"highest": "f32", "high": "split", "default": "bf16"}
# name -> (nocc, nvir, seed, naux)
PROBLEMS = {"ovvv": (3, 7, 7, None), "df": (3, 7, 13, 11),
            "pad": (3, 7, 9, None)}


def _port(name):
    nocc, nvir, seed, naux = PROBLEMS[name]
    return testing.triples_tensors(*testing.random_triples_problem(
        nocc, nvir, seed, naux=naux), CPU, torch.float64)


def _jax(name):
    nocc, nvir, seed, naux = PROBLEMS[name]
    t1, t2, f = testing.random_triples_problem(nocc, nvir, seed, naux=naux)
    return (jnp.asarray(t1), jnp.asarray(t2),
            SimpleNamespace(**{k: None if v is None else jnp.asarray(v)
                               for k, v in f.items()}))


def _np(x):
    return jnp.asarray(convert.to_numpy(x))


def _jax_operand(x, mode):
    """The JAX kernel's form of an unsplit port operand."""
    x = _np(x)
    if mode == "split":
        return jtr.hilo(x)
    return x.astype(jnp.bfloat16) if mode == "bf16" else x


@pytest.fixture(scope="module")
def op_cases():
    """Per (mode, act): the port's resident prep of tiles 0-2 of the DF
    problem at tile=3 and the JAX interpret-mode kernel's energies."""
    t1, t2, er = _port("df")
    out = {}
    for act in ACT_MODES:
        kw = ACT if act else dict(act_hole=None, act_particle=None)
        big = ccsd_t._prepare(t1, t2, er, 3, torch.float64, kw["act_hole"],
                              kw["act_particle"], 1.0, "resident")
        prep = ccsd_t.make_prep_resident(big)
        eijk, actocc = ccsd_t.fused_shared(big)
        outs = [prep(abc) for abc in ccsd_t._tile_triples(big["nvp"] // 3)
                [:3]]
        for mode in PRECISIONS.values():
            # one jitted wrapper per mode and act mode: the interpret-mode
            # kernel is traced once per shape instead of once per call
            fn = jax.jit(partial(jtr.tile_energy_resident, interpret=True,
                                 act_mode=act, mode=mode))
            refs = []
            for o in outs:
                akw = dict(act3=_np(o[9]), actocc=_np(actocc)) if act else {}
                refs.append(float(fn(
                    [_jax_operand(x, mode) for x in o[0]],
                    [_jax_operand(x, mode) for x in o[1]],
                    *[_np(x) for x in o[2:7]], _np(eijk), _np(o[7]),
                    _np(o[8]), **akw)))
            out[(mode, act)] = (outs, eijk, actocc, refs)
    return out


@pytest.mark.parametrize("act", ACT_MODES)
@pytest.mark.parametrize("mode", list(PRECISIONS.values()))
def test_reference_matches_pallas_interpret(op_cases, mode, act):
    outs, eijk, actocc, refs = op_cases[(mode, act)]
    assert max(abs(e) for e in refs) > 1e-8        # non-degenerate tiles
    for o, ref in zip(outs, refs):
        kw = dict(act3=o[9], actocc=actocc, act_mode=act) if act else {}
        e = tr.tile_energy_resident(*o[:7], eijk, *o[7:9], mode=mode, **kw)
        assert e.dtype == torch.float64 and e.dim() == 0
        np.testing.assert_allclose(float(e), ref, rtol=RTOL, atol=ATOL)


def test_chunk_matches_per_tile(op_cases):
    outs, eijk, actocc, refs = op_cases[("split", "only_active")]
    st = ccsd_t.stack_prep_resident(outs)
    e = tr.tile_energy_resident_chunk(*st[:7], eijk, *st[7:9], act3=st[9],
                                      actocc=actocc, act_mode="only_active",
                                      mode="split")
    assert e.shape == (len(outs),)
    np.testing.assert_allclose(convert.to_numpy(e), refs, rtol=RTOL,
                               atol=ATOL)


def test_hilo_matches_jax():
    x = np.random.default_rng(5).standard_normal(4096) * 0.05
    hi, lo = tr.hilo(torch.tensor(x))
    jhi, jlo = jtr.hilo(jnp.asarray(x))
    for a, b in ((hi, jhi), (lo, jlo)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.double().numpy(),
                                      np.asarray(b.astype(jnp.float64)))


# (problem, tile, precision, act mode, vfac)
ENGINE_CASES = (
    [(name, 3, prec, None, 1.0) for name in ("ovvv", "df")
     for prec in PRECISIONS]
    + [("pad", 4, "highest", None, 1.0), ("pad", 4, "high", None, 1.0),
       ("ovvv", 3, "highest", None, 2.0),
       ("ovvv", 3, "highest", "exclude_active", 1.0),
       ("df", 3, "high", "only_active", 1.0)])


def _case_kw(act, vfac):
    kw = dict(vfac=vfac)
    if act:
        kw.update(mode=act, **ACT)
    return kw


@pytest.fixture(scope="module")
def jax_energies():
    """JAX ccsd_t.kernel(engine='resident') per ENGINE_CASES entry."""
    return {case: float(jccsd_t.kernel(
        *_jax(case[0]), tile=case[1], engine="resident",
        dot_precision=case[2], **_case_kw(*case[3:])))
        for case in ENGINE_CASES}


@pytest.mark.parametrize("case", ENGINE_CASES,
                         ids=["-".join(map(str, c)) for c in ENGINE_CASES])
def test_kernel_matches_jax_resident(jax_energies, case):
    name, tile, prec, act, vfac = case
    ref = jax_energies[case]
    assert abs(ref) > 1e-8
    e = ccsd_t.kernel(*_port(name), tile=tile, engine="resident",
                      dot_precision=prec, **_case_kw(act, vfac))
    np.testing.assert_allclose(e, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_resident_matches_xla_engine(name, chunk):
    tile = 4 if name == "pad" else 3
    e_x = ccsd_t.kernel(*_port(name), tile=tile, engine="xla")
    e_r = ccsd_t.kernel(*_port(name), tile=tile, engine="resident",
                        chunk=chunk)
    np.testing.assert_allclose(e_r, e_x, rtol=RTOL, atol=ATOL)


def test_precision_mapping():
    assert ccsd_t.RESIDENT_MODES == {None: "f32", "highest": "f32",
                                     "high": "split", "default": "bf16"}
    args = _port("df")
    e_none = ccsd_t.kernel(*args, tile=3, engine="resident")
    e_hi = ccsd_t.kernel(*args, tile=3, engine="resident",
                         dot_precision="HIGHEST")
    assert e_none == e_hi
    with pytest.raises(ValueError):
        ccsd_t.kernel(*args, tile=3, engine="resident",
                      dot_precision="tf32")
    with pytest.raises(ValueError):
        tr.tile_energy_resident_chunk([], [], *[None] * 8, mode="3xtf32")
