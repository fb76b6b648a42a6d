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
- dot_precision 'high' (bf16x3) and 'default' (bf16) off the resident
  engine: the 'xla' engine against the resident engine's plain version,
  and 'high' against the JAX 'xla' engine at full precision.
- The fused engine at the bf16 tiers: emit_w_dot's plain form on the
  split operands (tc.w1_ov, tc.w1_t2, tc.w1_t2_slice) against the JAX
  package's explicit bf16 product (triples_resident.hilo and _dot3 in
  mode 'split' or 'bf16') for every perm, and ccsd_t.kernel(engine=
  'fused') against the port's resident and 'xla' engines at the same
  tier.

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
from pyscf_mpcc_tpu.ops import triples_resident as jtr
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


@pytest.mark.parametrize("p", tc.PERMS)
@pytest.mark.parametrize("prec", ["high", "default"])
def test_emit_w_dot_bf16_tiers_match_jax_dot3(prec, p):
    """emit_w_dot's plain form on the fused prep's split operands equals
    the JAX package's bf16 product (hilo, then _dot3 in mode 'split':
    hi.hi + hi.lo + lo.hi, or 'bf16': hi.hi, each product exact in
    fp64), in emit_w_dot's output layout."""
    mode = tc.w1_mode(prec)
    rng = np.random.default_rng(4)
    T, o, nvp = 3, 4, 6
    ovb = rng.standard_normal((T, T, o, nvp))
    t2T = rng.standard_normal((2 * T, nvp, o * o))
    t2op = t2T[T:]
    jov, jt2 = jtr.hilo(jnp.asarray(ovb)), jtr.hilo(jnp.asarray(t2op))
    if mode == "bf16":
        jov, jt2 = jov[0], jt2[0]
    if tc.W_PLAN[p]["order"] == "ov_first":
        ref = jtr._dot3(jov, jt2, mode, jnp.float64, 3, 1).reshape(
            T, T, o, T, o, o)
    else:
        ref = jnp.transpose(jtr._dot3(jt2, jov, mode, jnp.float64, 1, 3),
                            (0, 2, 3, 1, 4)).reshape(T, T, T, o, o, o)
    a = tc.w1_ov(torch.tensor(ovb), mode)
    b = tc.w1_t2_slice(tc.w1_t2(torch.tensor(t2T), mode), T, T, mode)
    assert a.dtype == b.dtype == torch.bfloat16
    out = tc.emit_w_dot(p, a, b, torch.float64, T, o, prec)
    assert out.dtype == torch.float64 and out.is_contiguous()
    np.testing.assert_allclose(convert.to_numpy(out), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    # and differs from the full-precision dot: the rounding took effect
    full = tc.emit_w_dot(p, torch.tensor(ovb), torch.tensor(t2op),
                         torch.float64, T, o)
    assert not torch.allclose(out, full, rtol=1e-6, atol=0)


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
    with pytest.raises(NotImplementedError):
        ccsd_t.kernel(*args, tile=3, engine="flat")
    with pytest.raises(ValueError):
        ccsd_t.kernel(*args, tile=3, engine="fused4")
    with pytest.raises(ValueError):
        ccsd_t.kernel(*args, tile=3, engine="xla", dot_precision="tf32")
    # the mesh (T) takes replicated integrals, never a sharded container
    t1, t2, er = _port("df")
    er.mesh = object()
    with pytest.raises(ValueError, match="replicated"):
        ccsd_t.kernel(t1, t2, er, tile=3, mesh=object())


@pytest.mark.parametrize("prec", ["high", "default"])
def test_bf16_tiers_off_the_resident_engine(jax_energies, prec):
    """'xla' (the default engine on the CPU) runs the W1 dots of the bf16
    tiers as the resident engine does (bf16 hi/lo products summed in the
    working dtype), so both plain versions agree to summation order.  The
    JAX package cannot give a bf16x3 oracle on the CPU: XLA:CPU ignores
    the dot precision setting and computes its 'high' dots at full
    precision.  So 'high' is held to the JAX 'xla' engine at full
    precision within 5e-4, the JAX package's own bound for the mode
    (tests/test_triples_fused.py:145)."""
    args = _port("df")
    e_x = ccsd_t.kernel(*args, tile=3, dot_precision=prec)
    e_r = ccsd_t.kernel(*args, tile=3, engine="resident", dot_precision=prec)
    e_full = ccsd_t.kernel(*args, tile=3, engine="xla")
    np.testing.assert_allclose(e_x, e_r, rtol=1e-10, atol=0)
    assert e_x != e_full                  # the bf16 rounding took effect
    if prec == "high":
        np.testing.assert_allclose(e_x, jax_energies[("df", 3, None)],
                                   rtol=5e-4, atol=0)


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("tile", [3, 4])
@pytest.mark.parametrize("name", list(PROBLEMS))
@pytest.mark.parametrize("prec", ["high", "default"])
def test_fused_engine_runs_bf16_tiers(prec, name, tile, chunk):
    """The fused engine at a bf16 tier computes the function of the
    resident and 'xla' engines at that tier (fp64: the bf16 products are
    exact, so only the summation order differs)."""
    args = _port(name)
    e_f = ccsd_t.kernel(*args, tile=tile, engine="fused", chunk=chunk,
                        dot_precision=prec)
    e_r = ccsd_t.kernel(*args, tile=tile, engine="resident",
                        dot_precision=prec)
    e_x = ccsd_t.kernel(*args, tile=tile, engine="xla", dot_precision=prec)
    np.testing.assert_allclose(e_f, e_r, rtol=1e-10, atol=0)
    np.testing.assert_allclose(e_f, e_x, rtol=1e-10, atol=0)
    assert e_f != ccsd_t.kernel(*args, tile=tile, engine="fused")


@pytest.mark.parametrize("mode", MODES[1:])
def test_fused_bf16_tier_active_mask(mode):
    args = _port("df")
    e_f = ccsd_t.kernel(*args, tile=3, engine="fused", mode=mode,
                        dot_precision="high", **ACT)
    e_x = ccsd_t.kernel(*args, tile=3, engine="xla", mode=mode,
                        dot_precision="high", **ACT)
    np.testing.assert_allclose(e_f, e_x, rtol=1e-10, atol=ATOL)


def test_fused_bf16_prep_keeps_split_t2_only():
    """At a bf16 tier the fused prep keeps t2T's and t2Ts' bf16 parts
    (f-major, [hi ; lo] in 'high', hi in 'default') and no fp32 t2Ts;
    the parts equal hilo of the fp32 layouts."""
    t1, t2, er = _port("df")
    full = ccsd_t._prepare(t1, t2, er, 3, torch.float64, None, None, 1.0,
                           "fused")
    for prec in ("high", "default"):
        mode = tc.w1_mode(prec)
        big = ccsd_t._prepare(t1, t2, er, 3, torch.float64, None, None, 1.0,
                              "fused", mode)
        assert big["precision"] == prec
        # t2T and oovv_T are the only fp64 tensors of t2's size left
        assert [k for k, x in big.items() if isinstance(x, torch.Tensor)
                and x.dtype == torch.float64
                and x.shape == big["t2T"].shape] == ["t2T", "oovv_T"]
        for key, ref in (("t2T_w1", full["t2T_w1"]),
                         ("t2Ts_w1", full["t2Ts_w1"])):
            hi, lo = tc.hilo(ref.transpose(0, 1))
            want = torch.cat([hi, lo]) if mode == "split" else hi
            assert big[key].dtype == torch.bfloat16
            assert torch.equal(big[key], want)
        # an f axis that the split's chunks do not divide
        x = torch.rand((5, 2 * tc.T2_SPLIT_CHUNKS + 3, 4),
                       dtype=torch.float64) - 0.5
        hi, lo = tc.hilo(x.transpose(0, 1))
        assert torch.equal(tc.w1_t2(x, mode), torch.cat([hi, lo])
                           if mode == "split" else hi)


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


# --------------------------------------------------------------------------
# The combine kernel's index maps (csrc/triples_combine.cu and
# triples_epilogue.cuh), transliterated to numpy: the W build from the
# streams by vectors of k, the w2 GEMM's chunks and fp64 MMA fragments,
# the V-term staging and the orbit table.  A CUDA kernel cannot run here,
# so its arithmetic is held to the plain version through this copy.
# --------------------------------------------------------------------------

EPI_THREADS, SMEM_DYN_MAX = 512, 232448 - 1024


def _perm_of(q):
    return tc.PERMS[q]


def _w_strides(o):
    return o * (o + 1) + 1, o + 1, 1           # w_s0, w_s1, 1


def _slot(s, o):
    return _w_strides(o)[s]


def _round_up(x, m):
    return -(-x // m) * m


def _w2_plan(o, itemsize, sbytes):
    vn = 16 // itemsize
    kd, bn, ncb = _round_up(o, 4 * vn), _round_up(o, 8), -(-o // 32)
    b_bytes = _round_up(kd * (bn + 4 // vn) * 8, 16)
    row = kd * itemsize
    full = min(EPI_THREADS // 32 // ncb * 16, _round_up(o * o, 64))
    rb = min((sbytes - b_bytes) // row // 64 * 64, full)
    return dict(kd=kd, bn=bn, ncb=ncb, rb=rb, b_bytes=b_bytes,
                a_bytes=rb * row)


def _w2_rows(o, itemsize, sbytes):
    """(rows of a chunk, whether the fragments read vooo from device
    memory): one chunk a perm where kd is o, else the buffer's rows."""
    pl = _w2_plan(o, itemsize, sbytes)
    direct = pl["kd"] == o
    return (o * o if direct else pl["rb"]), direct


def _scratch_bytes(o, itemsize):
    chunk = o * o * itemsize
    small = _w2_plan(o, itemsize, 0)
    floor = max(6 * chunk, small["b_bytes"] + 64 * small["kd"] * itemsize)
    big = _w2_plan(o, itemsize, 1 << 40)
    want = max(big["b_bytes"] + big["a_bytes"], _vstage_elems(o) * itemsize)
    w_bytes = _round_up(o * _w_strides(o)[0] * itemsize, 128)
    want = min(want, SMEM_DYN_MAX - w_bytes)
    return _round_up(max(want, floor), 16)


def _vstage_elems(o):
    return 12 * o * (o + 1) + 12 * o


def _build_w_direct(o, itemsize, T):
    """build_w_direct's accesses, thread item by thread item: per stream
    q the offsets it reads from the stream's cell base, and the padded W
    offsets it writes (NV consecutive k a thread item)."""
    nv = 16 // itemsize if o % (16 // itemsize) == 0 else 1
    s0, s1, _ = _w_strides(o)
    reads = {q: [] for q in range(6)}
    writes = []
    for e in range(o * o * (o // nv)):
        ij, k = divmod(e, o // nv)
        k *= nv
        i, j = divmod(ij, o)
        off = (i * T * o * o + j * o + k, j * T * o * o + i * o + k,
               ij * o + k)
        for q in range(6):
            reads[q] += [off[q >> 1] + u for u in range(nv)]
        writes += [i * s0 + j * s1 + k + u for u in range(nv)]
    return reads, writes


def _w2_cover(o, itemsize, sbytes):
    """(perm, row, col) products that subtract_w2's warp fragments
    subtract from W; every A row read checked to lie inside the chunk's
    buffer (or vooo slice) and every B column inside the t2 block."""
    pl = _w2_plan(o, itemsize, sbytes)
    rb, _ = _w2_rows(o, itemsize, sbytes)
    nch = -(-o * o // rb)
    nrw = EPI_THREADS // 32 // pl["ncb"]
    seen = []
    for n in range(6 * nch):
        q, r0 = n // nch, (n % nch) * rb
        rows = min(rb, o * o - r0)
        for warp in range(EPI_THREADS // 32):
            cb, rw = warp % pl["ncb"], warp // pl["ncb"]
            nct = min(4, (o - 32 * cb + 7) // 8)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for rb0 in range(64 * (rw >> 2) + 2 * (rw & 3), rows,
                                 nrw * 16):
                    assert rb0 + 8 * g + 1 < rb
                    assert (32 * cb + 8 * (nct - 1) + g
                            < pl["bn"] + 4 * itemsize // 16)
                    for mi in range(2):
                        r = rb0 + 8 * g + mi
                        seen += [(q, r0 + r, 32 * cb + 8 * j + 2 * t + e)
                                 for j in range(nct) for e in range(2)
                                 if r < rows
                                 and 32 * cb + 8 * j + 2 * t + e < o]
    return seen


def _dmma_banks(o, itemsize):
    """Bank conflicts of the DMMA fragments' shared loads at step s: B
    (doubles at row stride bn + 4 / VN, lane (g, t) at row VN t + s) must
    hit 16 distinct banks pairs a half-warp; A (16-byte vectors of row g
    at column VN t, row stride o or kd) at most two ways a quarter-warp."""
    pl = _w2_plan(o, itemsize, 1 << 40)
    vn = 16 // itemsize
    bsd = pl["bn"] + 4 // vn
    for s in range(vn):
        b = [(((lane & 3) * vn + s) * bsd + (lane >> 2)) * 2 % 32
             for lane in range(16)]
        if len(set(b)) != 16:
            return False
    for stride in {o if o % (4 * vn) == 0 else pl["kd"]}:
        for quarter in range(4):
            groups = [((lane >> 2) * 8 * stride + vn * (lane & 3))
                      * itemsize // 16 % 8 for lane in range(8 * quarter,
                                                             8 * quarter + 8)]
            if max(groups.count(x) for x in groups) > 2:
                return False
    if o == 32:      # the W subtract of a fragment: 32 distinct banks
        s0, s1, _ = _w_strides(o)
        for q in range(6):
            p0, p1, p2 = _perm_of(q)
            si, sj, sk = _slot(p0, o), _slot(p1, o), _slot(p2, o)
            for rw in range(16):
                rb0 = 64 * (rw >> 2) + 2 * (rw & 3)
                for mi, j, e in ((0, 0, 0), (1, 3, 1)):
                    banks = {((rb0 + 8 * (ln >> 2) + mi) // o * si
                              + (rb0 + 8 * (ln >> 2) + mi) % o * sj
                              + (8 * j + 2 * (ln & 3) + e) * sk) * itemsize
                             // 4 % 32 for ln in range(32)}
                    if itemsize == 4 and len(banks) != 32:
                        return False
    return True


@pytest.mark.parametrize("itemsize,o", [(4, 5), (4, 8), (4, 17), (4, 32),
                                        (4, 33), (4, 36), (8, 7), (8, 28)])
def test_combine_kernel_index_maps_cover_once(itemsize, o):
    """At the kernel's real shapes: build_w_direct writes every W element
    once and reads every value of a stream's cell once, and the w2
    fragments cover every product once."""
    sb = _scratch_bytes(o, itemsize)
    w_bytes = _round_up(o * _w_strides(o)[0] * itemsize, 128)
    assert sb >= 6 * o * o * itemsize and w_bytes + sb <= SMEM_DYN_MAX
    s0, s1, _ = _w_strides(o)
    canon = sorted(i * s0 + j * s1 + k for i in range(o) for j in range(o)
                   for k in range(o))
    T = 3
    reads, writes = _build_w_direct(o, itemsize, T)
    assert sorted(writes) == canon
    ov_first = sorted(i * T * o * o + p * o + r for i in range(o)
                      for p in range(o) for r in range(o))
    for q, offs in reads.items():
        assert sorted(offs) == (ov_first if q < 4 else list(range(o ** 3)))
    seen = _w2_cover(o, itemsize, sb)
    assert len(seen) == len(set(seen)) == 6 * o ** 3
    assert _dmma_banks(o, itemsize)


def test_combine_kernel_nocc_forms():
    """The staged range and the V-staging range of the kernel's forms
    (the module comment of triples_combine.cu)."""
    def staged(o, isz):
        w_bytes = _round_up(o * _w_strides(o)[0] * isz, 128)
        return w_bytes + _scratch_bytes(o, isz) <= SMEM_DYN_MAX

    def vstaged(o, isz):
        return _vstage_elems(o) * isz <= _scratch_bytes(o, isz)

    assert [staged(o, 4) for o in (36, 37)] == [True, False]
    assert [staged(o, 8) for o in (28, 29)] == [True, False]
    assert [vstaged(o, 4) for o in (34, 35)] == [True, False]
    assert [vstaged(o, 8) for o in (26, 27)] == [True, False]


def test_orbit_table_matches_enumeration():
    for o in (1, 2, 5, 13, 32, 36):
        t = tc.orbit_table(o, CPU).numpy()
        r = np.stack([t & 255, (t >> 8) & 255, t >> 16], 1)
        brute = [(i, j, k) for i in range(o) for j in range(o)
                 for k in range(o) if i >= j >= k]
        assert len(t) == o * (o + 1) * (o + 2) // 6
        assert sorted(map(tuple, r.tolist())) == sorted(brute)
        assert tc.orbit_table(o, CPU) is tc.orbit_table(o, CPU)   # cached


def _combine_transliteration(args, itemsize=8):
    """The tile energy by the kernel's index maps (staged form), numpy."""
    w_list, vooo_t, t2p, oovv_t, t1_t, fvo_t = args[:6]
    eijk, gabc, evt = args[8:11]
    w_flat = [convert.to_numpy(w).reshape(-1) for w in w_list]
    vooo, t2p, oovv = (convert.to_numpy(x) for x in (vooo_t, t2p, oovv_t))
    t1 = convert.to_numpy(t1_t).reshape(3, -1, vooo.shape[-1])
    fvo = convert.to_numpy(fvo_t).reshape(t1.shape)
    eijk, gabc, evt = (convert.to_numpy(x) for x in (eijk, gabc, evt))
    T, o = t2p.shape[2], t2p.shape[-1]
    oo = o * o
    s0, s1, _ = _w_strides(o)
    sb = _scratch_bytes(o, itemsize)
    pl = _w2_plan(o, itemsize, sb)
    rb, _ = _w2_rows(o, itemsize, sb)
    orbits = tc.orbit_table(o, CPU).numpy()
    total = 0.0
    for A in range(T):
        for B in range(T):
            for C in range(T):
                ga, gb, gc = gabc[0, A], gabc[1, B], gabc[2, C]
                wgt = (1.0 if ga > gb > gc else 1 / 6 if ga == gb == gc
                       else 0.5 if ga >= gb >= gc else 0.0)
                if wgt == 0.0:
                    continue
                v = (A, B, C)
                eabc = evt[0, A] + evt[1, B] + evt[2, C]
                W = np.full(o * s0, np.nan)
                blk = o * (o + 1)
                vs = np.full(_vstage_elems(o), np.nan)
                ii, jj, kk = np.meshgrid(*[np.arange(o)] * 3, indexing="ij")
                Wd = 0.0
                for q in range(6):
                    p0, p1, p2 = _perm_of(q)
                    x, y, z = v[p0], v[p1], v[p2]
                    wbase = ((x * T + y) * o * T * oo + z * oo if q < 4
                             else ((z * T + x) * T + y) * oo * o)
                    # build_w_direct: (i, j, k) of stream q
                    off = (ii * T * oo + jj * o if q < 2 else
                           jj * T * oo + ii * o if q < 4 else
                           (ii * o + jj) * o) + kk
                    Wd = Wd + w_flat[q][wbase + off]
                    for n, blk_q in ((q, oovv[p0, p1, x, y]),
                                     (6 + q, t2p[p1, p0, y, x])):
                        rows_ = vs[n * blk:(n + 1) * blk].reshape(o, o + 1)
                        rows_[:, :o] = blk_q
                    vs[12 * blk + q * o:12 * blk + (q + 1) * o] = t1[p2, z]
                    vs[12 * blk + (6 + q) * o:
                       12 * blk + (7 + q) * o] = fvo[p2, z]
                W[ii * s0 + jj * s1 + kk] = Wd
                for q in range(6):                  # subtract_w2
                    p0, p1, p2 = _perm_of(q)
                    si, sj, sk = _slot(p0, o), _slot(p1, o), _slot(p2, o)
                    Bs = np.zeros((pl["kd"], pl["bn"]))
                    Bs[:o, :o] = t2p[p2, p1, v[p2], v[p1]]
                    va = vooo[p0, v[p0]]
                    for r0 in range(0, oo, rb):
                        rows = np.arange(r0, min(oo, r0 + rb))
                        Ach = np.zeros((len(rows), pl["kd"]))
                        Ach[:, :o] = va[rows]
                        prod = (Ach @ Bs)[:, :o]
                        i1, j1 = rows // o, rows % o
                        off = ((i1 * si + j1 * sj)[:, None]
                               + np.arange(o)[None, :] * sk)
                        W[off] -= prod
                acc = 0.0                            # orbit_energy
                for code in orbits:
                    r = (code & 255, (code >> 8) & 255, code >> 16)
                    Wv, Vv = [], []
                    for s in range(6):
                        s0_, s1_, s2_ = _perm_of(s)
                        oc = (r[s0_], r[s1_], r[s2_])
                        Wc = W[oc[0] * s0 + oc[1] * s1 + oc[2]]
                        vt = 0.0
                        for q in range(6):
                            p0, p1, p2 = _perm_of(q)
                            ij, k1 = oc[p0] * (o + 1) + oc[p1], oc[p2]
                            vt += 0.5 * (vs[q * blk + ij]
                                         * vs[12 * blk + q * o + k1]
                                         + vs[(6 + q) * blk + ij]
                                         * vs[12 * blk + (6 + q) * o + k1])
                        Wv.append(Wc)
                        Vv.append(Wc + vt)
                    den = eijk[r[0], r[1], r[2]] - eabc
                    done = set()
                    for s in range(6):
                        qs = _perm_of(s)
                        e = (r[qs[0]], r[qs[1]], r[qs[2]])
                        if e in done:
                            continue
                        done.add(e)

                        def pid(a, b, c):
                            return 2 * a + (1 if b > c else 0)
                        Z = (4 * Vv[s] + Vv[pid(qs[1], qs[2], qs[0])]
                             + Vv[pid(qs[2], qs[0], qs[1])]
                             - 2 * (Vv[pid(qs[2], qs[1], qs[0])]
                                    + Vv[pid(qs[0], qs[2], qs[1])]
                                    + Vv[pid(qs[1], qs[0], qs[2])]))
                        acc += Wv[s] * (Z / den)
                total += acc * wgt
    return total


@pytest.mark.parametrize("tile", [0, 4])
def test_combine_transliteration_matches_plain(tile):
    outs, eijk, _ = _prep("df", None)
    o = outs[tile]
    args = (*o[:8], eijk, *o[8:10])
    ref = float(tc.tile_energy_fused_reference(*args))
    assert abs(ref) > 1e-8
    np.testing.assert_allclose(_combine_transliteration(args), ref,
                               rtol=RTOL, atol=ATOL)
