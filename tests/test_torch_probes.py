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


# --------------------------------------------------------------------------
# the redesigned kernels' index maps, transliterated into numpy (the CUDA
# kernels run only on the card; these hold their arithmetic to the plain
# versions here)
# --------------------------------------------------------------------------

P3_SHAPES = [(256, 424, 8192), (2048, 424, 1024), (256, 424, 1024),
             (128, 40, 256), (384, 20, 128)]


def _f32(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("mode", ("split", "bf16"))
@pytest.mark.parametrize("shape", P3_SHAPES)
def test_p3_operand_tiling_round_trips(mode, shape):
    # the dots kernel's bf16 operands are the resident engine's layouts:
    # a K-major (ov_operand), b MN-major (t2_operand), K padded to MMA_KC
    from pyscf_mpcc_tpu_torch.ops import triples_resident as tr
    M, K, N = shape
    a, b = torch.tensor(_f32((M, K), 1)), torch.tensor(_f32((K, N), 2))
    opa, opb = probe.dots_operands(a, b, mode)
    kc = tr.MMA_KC[mode]
    kp = -(-K // kc) * kc
    parts = zip(*(x if isinstance(x, tuple) else (x,) for x in (opa, opb)))
    for h, (pa, pb) in enumerate(parts):
        assert pa.dtype == pb.dtype == torch.bfloat16
        assert tuple(pa.shape) == (kp // kc, M // 8, kc // 8, 8, 8)
        assert tuple(pb.shape) == (1, kp // kc, N // 8, kc // 8, 8, 8)
        ha, la = tr.hilo(a)
        hb, lb = tr.hilo(b)
        want_a = (ha, la)[h].float().numpy()
        want_b = (hb, lb)[h].float().numpy()
        da = tr.ov_dense(pa, M).float().numpy()
        db = tr.t2_dense(pb, N)[0].float().numpy()
        assert np.array_equal(da[:, :K], want_a)
        assert np.array_equal(db[:K], want_b)
        assert not da[:, K:].any() and not db[K:].any()
    assert h == (1 if mode == "split" else 0)


def _mma_geometry(mode):
    kc = {"split": 16, "bf16": 32}[mode]
    return dict(KC=kc, H=2 if mode == "split" else 1, SBO=kc // 8 * 128,
                A_HALF=128 * kc * 2, B_HALF=256 * kc * 2)


def _mma_stage(parts_a, parts_b, c, m0, n0, M, N, g):
    """The producer's bulk copies of chunk c: a stage as a byte-addressed
    array of bf16 values (fp64), bytes beyond B's valid columns NaN."""
    st = np.full(g["H"] * (g["A_HALF"] + g["B_HALF"]) // 2, np.nan)
    aoff = (c * M + m0) * g["KC"] * 2
    boff = (c * N + n0) * g["KC"] * 2
    bbytes = min(256, N - n0) * g["KC"] * 2
    for h in range(g["H"]):
        fa = parts_a[h].reshape(-1)
        fb = parts_b[h].reshape(-1)
        s = h * g["A_HALF"] // 2
        st[s:s + g["A_HALF"] // 2] = fa[aoff // 2:(aoff + g["A_HALF"]) // 2]
        s = (g["H"] * g["A_HALF"] + h * g["B_HALF"]) // 2
        st[s:s + bbytes // 2] = fb[boff // 2:(boff + bbytes) // 2]
    return st


def _wgmma(st, adesc, bdesc, g):
    """One m64n256k16 as the descriptors address it (no swizzle): A
    K-major, B MN-major; core matrices 8 x 16 bytes, LBO 128 along k, SBO
    along m or n."""
    m = np.arange(64)[:, None]
    k = np.arange(16)[None, :]
    ia = adesc + (m // 8) * g["SBO"] + (k // 8) * 128 + (m % 8) * 16 \
        + (k % 8) * 2
    kk = np.arange(16)[:, None]
    n = np.arange(256)[None, :]
    ib = bdesc + (n // 8) * g["SBO"] + (kk // 8) * 128 + (kk % 8) * 16 \
        + (n % 8) * 2
    return st[ia // 2] @ st[ib // 2]


def _mma_block_tile(parts_a, parts_b, tm, tn, M, N, mode):
    """The two warpgroups' 64 x 256 products of one block over the whole
    k-loop, as the kernel's mma_stage adds them: {wr: C}; columns of C
    beyond N are NaN (stale stage bytes, never read)."""
    g = _mma_geometry(mode)
    nk = parts_a[0].shape[0]
    m0, n0 = 128 * tm, 256 * tn
    acc = {0: 0, 1: 0}
    for c in range(nk):
        st = _mma_stage(parts_a, parts_b, c, m0, n0, M, N, g)
        for wr in (0, 1):
            a0 = wr * 8 * g["SBO"]
            b0 = g["H"] * g["A_HALF"]
            for s in range(g["KC"] // 16):
                d = _wgmma(st, a0 + 256 * s, b0 + 256 * s, g)
                if mode == "split":
                    d = d + _wgmma(st, a0 + 256 * s,
                                   b0 + g["B_HALF"] + 256 * s, g)
                    d = d + _wgmma(st, a0 + g["A_HALF"] + 256 * s,
                                   b0 + 256 * s, g)
                acc[wr] = acc[wr] + d
    return acc


def _ffma_block_tile(aT, b, tm, tn, K):
    """The f32 kernel's 128 x 128 block tile over the k-loop: every
    thread's 8 x 8 outputs from its fragments of the staged chunks."""
    M, N = aT.shape[1], b.shape[1]
    m0, n0 = 128 * tm, 128 * tn
    tid = np.arange(256)
    ty, tx = tid >> 4, tid & 15
    rows = np.concatenate([4 * ty[:, None] + np.arange(4),
                           64 + 4 * ty[:, None] + np.arange(4)], axis=1)
    cols = np.concatenate([4 * tx[:, None] + np.arange(4),
                           64 + 4 * tx[:, None] + np.arange(4)], axis=1)
    acc = np.zeros((256, 8, 8))
    for k0 in range(0, K, 16):
        st = np.zeros(2 * 16 * 128)
        for u in range(4):                      # ffma_stage's pieces
            e = tid + u * 256
            isb = e >= 512
            p = np.where(isb, e - 512, e)
            r, c = p // 32, (p % 32) * 4
            ok = k0 + r < K
            for x in range(4):
                src = np.where(isb, b.reshape(-1)[np.minimum(
                    (k0 + r) * N + n0 + c + x, b.size - 1)],
                    aT.reshape(-1)[np.minimum(
                        (k0 + r) * M + m0 + c + x, aT.size - 1)])
                st[np.where(isb, 16 * 128, 0) + r * 128 + c + x] = \
                    np.where(ok, src, 0.0)
        for kk in range(16):                    # ffma_frag, ffma_step
            fa = st[kk * 128 + rows]
            fb = st[(16 + kk) * 128 + cols]
            acc += fa[:, :, None] * fb[:, None, :]
    return acc, rows, cols


def _rep_sum(x, n):
    """x summed n times in fp32, as a thread adds its repeats into out."""
    s = np.zeros_like(x)
    for _ in range(n):
        s = s + x
    return s


def _dots_transliterated(a, b, mode, reps, slots):
    """The dots kernel's grid (dots_grid), its blocks' outputs and the
    wrapper's sum of the groups' partials, in numpy."""
    M, K = a.shape
    N = b.shape[1]
    ntile, nsplit = probe.dots_grid(M, N, mode, reps, slots)
    outp = np.full((nsplit, M, 128), np.nan)
    csp = np.full((nsplit, M // 128, N // 128), np.nan)
    tiles = {}
    if mode == "f32":
        aT, bb = (convert.to_numpy(x).astype(np.float64)
                  for x in probe.dots_operands(a, b, mode))
    else:
        opa, opb = probe.dots_operands(a, b, mode)
        parts_a = [x.float().numpy().astype(np.float64) for x in
                   (opa if isinstance(opa, tuple) else (opa,))]
        parts_b = [x.float().numpy().astype(np.float64) for x in
                   (opb if isinstance(opb, tuple) else (opb,))]
    mt = M // probe.DOT_TILES[mode][0]
    for blk in range(ntile * nsplit):           # work_of
        tile, grp = blk % ntile, blk // ntile
        tm, tn = tile % mt, tile // mt
        r0, r1 = grp * reps // nsplit, (grp + 1) * reps // nsplit
        assert r1 > r0
        if tile not in tiles:
            tiles[tile] = (_ffma_block_tile(aT, bb, tm, tn, K)
                           if mode == "f32" else
                           _mma_block_tile(parts_a, parts_b, tm, tn, M, N,
                                           mode))
        if mode == "f32":
            acc, rows, cols = tiles[tile]
            acc32 = acc.astype(np.float32)
            csp[grp, tm, tn] = (r1 - r0) * acc32.astype(np.float64).sum()
            if tn == 0:                         # out: block columns 0..127
                idx = (grp, 128 * tm + rows[:, :, None], cols[:, None, :])
                outp[idx] = _rep_sum(acc32, r1 - r0)
            continue
        acc = tiles[tile]
        lane = np.arange(128)
        wq, g8, q = lane >> 5, (lane & 31) >> 2, lane & 3
        c32 = {wr: acc[wr].astype(np.float32) for wr in (0, 1)}
        for ct in (0, 1):                       # the block's column tiles
            if 2 * tn + ct < N // 128:
                csp[grp, tm, 2 * tn + ct] = sum(
                    (r1 - r0) * c32[wr][:, 128 * ct:128 * (ct + 1)]
                    .astype(np.float64).sum() for wr in (0, 1))
        if tn:
            continue
        for wr in (0, 1):
            for j in range(16):                 # the fragment layout
                for h in range(2):
                    for e in range(2):
                        r = 16 * wq + g8 + 8 * h
                        col = 8 * j + 2 * q + e
                        outp[grp, 128 * tm + 64 * wr + r, col] = \
                            _rep_sum(c32[wr][r, col], r1 - r0)
    assert not np.isnan(outp).any() and not np.isnan(csp).any()
    return outp.sum(0), csp.sum(0), nsplit


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,reps,slots", [
    ((128, 40, 256), 5, 6), ((256, 20, 384), 7, 16),
    ((128, 424, 128), 3, 132)])
def test_p3_kernel_map_matches_plain(mode, shape, reps, slots):
    # repeat groups, uneven ones among them (5 over 3 in f32, 7 over 2 or
    # 4), a ragged K, an N that is an odd multiple of 128 (a last block
    # with 128 columns of B)
    M, K, N = shape
    a = torch.tensor(_f32((M, K), 3))
    b = torch.tensor(_f32((K, N), 4))
    out, cs, nsplit = _dots_transliterated(a, b, mode, reps, slots)
    assert nsplit > 1
    ref, rcs = probe.dots_reference(a.double(), b.double(), mode, reps)
    scale = np.abs(convert.to_numpy(ref)).max()
    np.testing.assert_allclose(out, convert.to_numpy(ref), rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(cs, convert.to_numpy(rcs), rtol=1e-5,
                               atol=1e-5 * np.abs(convert.to_numpy(rcs)).max())


def test_p3_grid_fills_the_card():
    # the grids at the probe's shapes on 132 SMs: f32 two blocks an SM,
    # split/bf16 one
    grids = {(M, N, mode): probe.dots_grid(M, N, mode, 48, per * 132)
             for (M, _, N) in P3_SHAPES[:3]
             for mode, per in (("f32", 2), ("bf16", 1))}
    assert grids == {(256, 8192, "f32"): (128, 2),
                     (2048, 1024, "f32"): (128, 2),
                     (256, 1024, "f32"): (16, 16),
                     (256, 8192, "bf16"): (64, 2),
                     (2048, 1024, "bf16"): (64, 2),
                     (256, 1024, "bf16"): (8, 16)}
    assert probe.dots_grid(128, 128, "bf16", 3, 132) == (1, 3)
    # the bytes the kernel streams at shape A (128 x 256 tiles)
    assert probe.dots_bytes(256, 424, 8192, 48, "bf16") == \
        48 * 64 * 384 * 448 * 2
    assert probe.dots_bytes(256, 424, 8192, 48, "split") == \
        48 * 64 * 384 * 432 * 4


@pytest.mark.parametrize("o,T", [(4, 2), (8, 3), (32, 8)])
def test_slab_kernel_gather_matches_numpy_transpose(o, T):
    # slab_kernel's map, piece e of the output <- piece src_piece(e) of w,
    # over its grid of THREADS * PIECES pieces a block, bitwise
    w = np.random.default_rng(o + T).standard_normal((T, o, T, o * o))
    q4 = o // 4
    n4 = T * T * o ** 3 // 4
    per_block = slab.THREADS * slab.PIECES
    nblock = -(-n4 // per_block)
    blk, tid, u = np.meshgrid(np.arange(nblock), np.arange(slab.THREADS),
                              np.arange(slab.PIECES), indexing="ij")
    e = (blk * per_block + tid + u * slab.THREADS).reshape(-1)
    e = e[e < n4]
    row, q = e // q4, e % q4
    i, r = row % o, row // o
    j, ab = r % o, r // o
    bb, a = ab % T, ab // T
    src = (((a * o + i) * T + bb) * o + j) * q4 + q
    w4 = w.reshape(-1, 4)
    out4 = np.full((n4, 4), np.nan)
    out4[e] = w4[src]
    assert np.array_equal(np.sort(e), np.arange(n4))
    ref = np.transpose(w.reshape(T, o, T, o, o), (0, 2, 3, 1, 4))
    assert np.array_equal(out4.reshape(ref.shape), ref)
