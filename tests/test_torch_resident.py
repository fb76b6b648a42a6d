"""The port's resident (T) engine (ops.triples_resident, cc.ccsd_t
engine='resident') against the JAX package.

- The plain version tile_energy_resident_reference against the JAX Pallas
  kernel tile_energy_resident(interpret=True), on identical inputs: the
  port's resident prep in each W1 mode, handed to both (as numpy to JAX),
  with the W1 operands split once into bf16 (hi, lo) pairs in mode
  'split' and hi parts in mode 'bf16', their f axis zero-padded to the
  kernel's k-chunk; for the three modes and the three act modes, one tile
  a call and four tiles a call.
- The prep's bf16 split against the JAX package's hilo (bitwise), and the
  zero padding of the f axis against no padding.
- The port's ccsd_t.kernel(engine='resident') against the JAX
  ccsd_t.kernel(engine='resident', dot_precision=...) on incore and DF
  problems, the tile=4/nvir=7 padding case, vfac=2 and the act masks;
  and against the port's own 'xla' engine.
- The port's fused engine at the bf16 tiers against the same JAX
  resident energies (mode 'split' for 'high', 'bf16' for 'default').
- engine='auto''s routing (ccsd_t.auto_engine): the resident kernel for
  the bf16 tiers while it holds a cell of nocc in shared memory, by its
  own size function (transliterated here), the fused engine beyond.

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


def _bf16(x):
    """A bf16 tensor as a JAX bf16 array (exact through fp64)."""
    return jnp.asarray(x.double().numpy()).astype(jnp.bfloat16)


def _jax_operand(x, dense):
    """The JAX kernel's form of a port W1 operand: the same values, in the
    dense layout (dense undoes the kernel's tiling)."""
    if isinstance(x, tuple):
        return tuple(_bf16(dense(h)) for h in x)
    return _bf16(dense(x)) if x.dtype == torch.bfloat16 else _np(x)


def _resident_prep(mode, act, tiles=4, name="df"):
    """The port's resident prep of the first tiles of a problem at tile=3
    in W1 mode, eijk and actocc."""
    kw = ACT if act else dict(act_hole=None, act_particle=None)
    big = ccsd_t._prepare(*_port(name), 3, torch.float64, kw["act_hole"],
                          kw["act_particle"], 1.0, "resident", mode)
    prep = ccsd_t.make_prep_resident(big)
    eijk, actocc = ccsd_t.fused_shared(big)
    outs = [prep(abc) for abc in ccsd_t._tile_triples(big["nvp"] // 3)
            [:tiles]]
    return outs, eijk, actocc


@pytest.fixture(scope="module")
def op_cases():
    """Per (mode, act): the port's resident prep of tiles 0-3 of the DF
    problem at tile=3 and the JAX interpret-mode kernel's energies."""
    out = {}
    for act in ACT_MODES:
        for mode in PRECISIONS.values():
            outs, eijk, actocc = _resident_prep(mode, act)
            # one jitted wrapper per mode and act mode: the interpret-mode
            # kernel is traced once per shape instead of once per call
            fn = jax.jit(partial(jtr.tile_energy_resident, interpret=True,
                                 act_mode=act, mode=mode))
            refs = []
            no = eijk.shape[0]
            for o in outs:
                akw = dict(act3=_np(o[9]), actocc=_np(actocc)) if act else {}
                refs.append(float(fn(
                    [_jax_operand(x, lambda h: tr.t2_dense(h, no * no))
                     for x in o[0]],
                    [_jax_operand(x, lambda h: tr.ov_dense(h, no))
                     for x in o[1]],
                    *[_np(x) for x in o[2:7]], _np(eijk), _np(o[7]),
                    _np(o[8]), **akw)))
            out[(mode, act)] = (outs, eijk, actocc, refs)
    return out


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("act", ACT_MODES)
@pytest.mark.parametrize("mode", list(PRECISIONS.values()))
def test_reference_matches_pallas_interpret(op_cases, mode, act, chunk):
    outs, eijk, actocc, refs = op_cases[(mode, act)]
    assert max(abs(e) for e in refs) > 1e-8        # non-degenerate tiles
    if mode == "split":     # tiled bf16 pairs
        assert all(isinstance(x, tuple) and x[0].dtype == torch.bfloat16
                   and x[0].dim() == 7 for x in outs[0][1])
    if chunk == 4:
        st = ccsd_t.stack_prep_resident(outs)
        kw = dict(act3=st[9], actocc=actocc, act_mode=act) if act else {}
        e = tr.tile_energy_resident_chunk(*st[:7], eijk, *st[7:9],
                                          mode=mode, **kw)
        assert e.shape == (4,) and e.dtype == torch.float64
        np.testing.assert_allclose(convert.to_numpy(e), refs, rtol=RTOL,
                                   atol=ATOL)
        return
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


def _assert_bitwise(a, b):
    assert a.dtype == torch.bfloat16
    np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                  np.asarray(b).view(np.int16))


@pytest.mark.parametrize("name", ["ovvv", "df"])
def test_prep_split_matches_jax_hilo(name):
    """The persistent t2 split and each tile's ov-block split of the
    resident prep equal the JAX hilo of the zero-padded fp64 arrays."""
    t1, t2, er = _port(name)
    big = ccsd_t._prepare(t1, t2, er, 3, torch.float64, None, None, 1.0,
                          "resident", "split")
    nvp, o = big["nvp"], big["o"]
    fp = -(-nvp // tr.MMA_KC["split"]) * tr.MMA_KC["split"]
    t2T = np.zeros((nvp, fp, o * o))
    t2T[:, :nvp] = big["t2T"].numpy()
    for a, b in zip(big["t2T_w1"], jtr.hilo(jnp.asarray(t2T))):
        _assert_bitwise(tr.t2_dense(a, o * o), b)
    abc = ccsd_t._tile_triples(nvp // 3)[5]
    ovbl = ccsd_t.make_prep_resident(big)(abc)[1]
    starts = [int(r) * 3 for r in abc]
    for (x, y), pair in zip(tr.PAIRS6, ovbl):
        ov = ccsd_t._ov_block(big, starts[x], starts[y]).numpy()
        ovp = np.zeros(ov.shape[:3] + (fp,))
        ovp[..., :nvp] = ov
        for a, b in zip(pair, jtr.hilo(jnp.asarray(ovp))):
            _assert_bitwise(tr.ov_dense(a, o), b)


@pytest.mark.parametrize("mode", ["split", "bf16"])
def test_zero_padded_f_leaves_energy(mode):
    """The resident plain version on the prep's operands (f zero-padded to
    the k-chunk) gives the tile energy of the xla engine, which splits the
    unpadded operands, to 1e-12."""
    args = _port("df")
    big_r = ccsd_t._prepare(*args, 3, torch.float64, None, None, 1.0,
                            "resident", mode)
    big_x = ccsd_t._prepare(*args, 3, torch.float64, None, None, 1.0, "xla")
    assert big_r["nvp"] % tr.MMA_KC[mode]       # the padding is not empty
    prep = ccsd_t.make_prep_resident(big_r)
    eijk = ccsd_t.fused_shared(big_r)[0]
    tile_x = ccsd_t.make_tile_energy(big_x, w1mode=mode)
    for abc in ccsd_t._tile_triples(big_r["nvp"] // 3)[:4]:
        o = prep(abc)
        e_pad = float(tr.tile_energy_resident_reference(
            *o[:7], eijk, *o[7:9], mode=mode))
        e_x = float(tile_x(abc))
        assert abs(e_x) > 1e-8
        np.testing.assert_allclose(e_pad, e_x, rtol=1e-12, atol=0)


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


BF16_CASES = [c for c in ENGINE_CASES if c[2] in ("high", "default")]


@pytest.mark.parametrize("case", BF16_CASES,
                         ids=["-".join(map(str, c)) for c in BF16_CASES])
def test_fused_bf16_tiers_match_jax_resident(jax_energies, case):
    """ccsd_t.kernel(engine='fused') at 'high'/'default' returns the JAX
    package's bf16x3 / bf16 function (its resident engine in interpret
    mode, mode 'split' / 'bf16')."""
    name, tile, prec, act, vfac = case
    e = ccsd_t.kernel(*_port(name), tile=tile, engine="fused",
                      dot_precision=prec, **_case_kw(act, vfac))
    np.testing.assert_allclose(e, jax_energies[case], rtol=RTOL, atol=ATOL)


# the resident kernel's dynamic shared memory in modes split and bf16
# (smem_bytes of csrc/triples_resident.cu with triples_epilogue.cuh's
# w_bytes and kSmemDynMax): padded W, then max(ring stages, 6 o^2 values)
SMEM_DYN_MAX, STAGE_BYTES, MAX_STAGES = 232448 - 1024, 36864, 2


def _resident_smem_bytes(o, itemsize, mode_code):
    assert mode_code != tr.MODES["f32"]        # the MMA modes' staging
    w = -(-o * (o * (o + 1) + 1) * itemsize // 128) * 128
    stages = min(max((SMEM_DYN_MAX - w) // STAGE_BYTES, 0), MAX_STAGES)
    return w + max(max(stages, 1) * STAGE_BYTES, 6 * o * o * itemsize)


@pytest.mark.parametrize("mode", ["split", "bf16"])
@pytest.mark.parametrize("nocc,engine", [
    (5, "resident"), (32, "resident"), (36, "resident"), (37, "fused"),
    (40, "fused"), (48, "fused"), (64, "fused")])
def test_auto_routes_bf16_tiers_by_the_resident_cap(mode, nocc, engine):
    top = tr.max_nocc(torch.float32, mode, _resident_smem_bytes,
                      SMEM_DYN_MAX)
    assert top == 36
    assert ccsd_t.auto_engine("cuda", nocc, torch.float32, mode,
                              top) == engine
    assert ccsd_t.auto_engine("cuda", nocc, torch.float32, "f32",
                              top) == "fused"
    assert ccsd_t.auto_engine("cpu", nocc, torch.float32, mode,
                              top) == "xla"


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
