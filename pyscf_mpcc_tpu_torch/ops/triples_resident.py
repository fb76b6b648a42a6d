"""CCSD(T) tile energy with the W1 dots inside the kernel.

Port of ``pyscf_mpcc_tpu/ops/triples_resident.py``.  A (T) tile computes

    W = sum_p P_p (w1_p - w2_p),   w1_p = sum_f (i'x|fy) t2[k',j',z,f],
    V = W + sum_p P_p v_p,  Z = 4V + V(jki) + V(kij) - 2V(kji) - 2V(ikj)
    - 2V(jik),  e = sum W * Z / D * weight

as the fused engine does (``ops/triples_combine``), but the six W1 dots run
inside one kernel, ``csrc/triples_resident.cu`` (built for sm_90a at first
use, see ``_build``), so W never reaches device memory.
``tile_energy_resident_reference`` is the same energy in plain vectorized
torch; the wrappers run it only for CPU tensors.  CUDA tensors launch the
kernel or raise.

Precision modes of the W1 dots (the small w2 dots and the V term always
run in the working dtype):

    'f32'    full dots in the dtype (fp32 on the card, fp64 in the tests)
    'split'  bf16 (hi, lo) operand pairs, hi.hi + hi.lo + lo.hi summed in
             the dtype: the JAX package's bf16x3 mode
    'bf16'   hi.hi only

As in the JAX function, 'split' takes the W1 operands (t2sl, ovbl) as
(hi, lo) bf16 pairs split once outside the kernel, and 'bf16' takes the
hi parts; 'f32' takes them dense in the working dtype.  The (T) prep
splits the persistent t2 once per call (``t2_operand``) and each tile's
ov blocks once (``ov_operand``).  In the bf16 modes the parts are also
laid out in the order in which the kernel stages them (k-chunks of
``MMA_KC`` of 8 x 8 tiles, rows and columns zero-padded to 8, f to the
chunk), so that the kernel fills a stage with a few contiguous bulk
copies; ``t2_dense`` and ``ov_dense`` undo that layout (the JAX
function's).  The zero padding leaves the energy unchanged.
"""

from __future__ import annotations

import ctypes

import torch

from pyscf_mpcc_tpu_torch.ops.triples_combine import (
    _ACT_MODES, PAIRS as PAIRS9, PERMS, hilo, orbit_table)

# ordered (x, y) role pairs consumed by the W1 dots / ov blocks; the
# t2p/oovv stacks are indexed by all ordered role pairs, PAIRS9
PAIRS6 = tuple((p[0], p[1]) for p in PERMS)
_PAIR = {pr: i for i, pr in enumerate(PAIRS9)}

MODES = {"f32": 0, "split": 1, "bf16": 2}
# k depth of one staged chunk of the kernel in the bf16 modes
# (MmaTile::KC in csrc/triples_resident.cu, checked when it is loaded), the
# chunk of their tiled operands, to which f is zero-padded
MMA_KC = {"split": 16, "bf16": 32}

# kernel launches made by the wrappers (CUDA tensors only)
launch_count = 0


def _pad(x, axis, n):
    """x zero-padded along axis to length n."""
    axis %= x.dim()
    if x.shape[axis] == n:
        return x
    return torch.nn.functional.pad(
        x, [0, 0] * (x.dim() - 1 - axis) + [0, n - x.shape[axis]])


def _split(x, mode, tile):
    hi, lo = hilo(x)
    return (tile(hi), tile(lo)) if mode == "split" else tile(hi)


def t2_operand(x, mode):
    """t2 slices (S, F, N) in the form mode takes them: x for 'f32'; else
    split ((hi, lo) for 'split', hi for 'bf16') and tiled,
    (S, F'/kc, N'/8, kc/8, 8, 8) [s, c, ng, kg, kr, nn] =
    x[s, kc c + 8 kg + kr, 8 ng + nn], kc = MMA_KC[mode], F and N
    zero-padded to F' (a multiple of kc) and N' (of 8)."""
    if mode == "f32":
        return x
    S, f, n = x.shape
    kc, np8 = MMA_KC[mode], -(-n // 8)
    fp = -(-f // kc) * kc
    x = _pad(_pad(x, 1, fp), 2, 8 * np8)
    return _split(x, mode, lambda h: h.reshape(
        S, fp // kc, kc // 8, 8, np8, 8).permute(0, 1, 4, 2, 3, 5)
        .contiguous())


def ov_operand(x, mode):
    """ov blocks (..., o, F) in the form mode takes them: x for 'f32';
    else split and tiled, (..., F'/kc, o'/8, kc/8, 8, 8)
    [..., c, mg, kg, r, kk] = x[..., 8 mg + r, kc c + 8 kg + kk], o and F
    zero-padded to o' (a multiple of 8) and F'."""
    if mode == "f32":
        return x
    *lead, o, f = x.shape
    kc, op8, n = MMA_KC[mode], -(-o // 8), len(lead)
    fp = -(-f // kc) * kc
    x = _pad(_pad(x, -1, fp), -2, 8 * op8)
    return _split(x, mode, lambda h: h.reshape(
        *lead, op8, 8, fp // kc, kc // 8, 8).permute(
        *range(n), n + 2, n, n + 3, n + 1, n + 4).contiguous())


def t2_dense(x, n):
    """A tiled t2 operand part as (S, F', n)."""
    S, c, np8, kg = x.shape[:4]
    return x.permute(0, 1, 3, 4, 2, 5).reshape(S, c * kg * 8, 8 * np8)[
        ..., :n]


def ov_dense(x, o):
    """A tiled ov operand part as (..., o, F')."""
    n = x.dim() - 5
    c, op8, kg = x.shape[n:n + 3]
    return x.permute(*range(n), n + 1, n + 3, n, n + 2, n + 4).reshape(
        *x.shape[:n], 8 * op8, c * kg * 8)[..., :o, :]


def _check(mode, act_mode, act3, actocc):
    if mode not in MODES:
        raise ValueError(f"unknown resident mode {mode!r}; use 'f32', "
                         "'split' or 'bf16'")
    if act_mode not in _ACT_MODES:
        raise ValueError(f"unknown act_mode {act_mode!r}")
    if act_mode is not None and (act3 is None or actocc is None):
        raise ValueError("act_mode needs act3 and actocc")


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def _w1(ov, t2, mode, dtype, o):
    """(Tx,Ty,o,F) . (Tz,F,oo) -> (Tx,Ty,o,Tz,oo) in dtype, from the W1
    operands in the form of mode (ov_operand, t2_operand)."""
    def dot(a, b):
        return torch.tensordot(a.to(dtype), b.to(dtype), dims=([3], [1]))

    if mode == "f32":
        return dot(ov, t2)
    if mode == "bf16":
        return dot(ov_dense(ov, o), t2_dense(t2, o * o))
    oh, ol = (ov_dense(x, o) for x in ov)
    th, tl = (t2_dense(x, o * o) for x in t2)
    return dot(oh, th) + dot(oh, tl) + dot(ol, th)


def tile_energy_resident_reference(t2sl, ovbl, vooo_t, t2p, oovv_t, t1_t,
                                   fvo_t, eijk, eabc3, wgt3, act3=None,
                                   actocc=None, act_mode=None, mode="split"):
    """Plain-torch tile energy (0-dim fp64) from the inputs of
    tile_energy_resident; runs on any device."""
    _check(mode, act_mode, act3, actocc)
    T, o = vooo_t.shape[1], t2p.shape[-1]
    vooo = vooo_t.reshape(3, T, o, o, o)               # [r, x, i, j, m]
    W = V = None
    for q, p in enumerate(PERMS):
        xi, yi, zi = p
        # (x, y, i, z, j, k) -> (x, y, z, i, j, k)
        w1 = _w1(ovbl[q], t2sl[zi], mode, vooo_t.dtype, o).reshape(
            T, T, o, T, o, o)
        w1 = w1.permute(0, 1, 3, 2, 4, 5)
        # w2[x,y,z,i,j,k] = sum_m (ix|jm) t2[k,m,z,y]
        w2 = torch.einsum("xijm,zymk->xyzijk", vooo[xi], t2p[_PAIR[zi, yi]])
        # v = ((ix|jy) t1[k,z] + t2[j,i,y,x] fvo[z,k]) / 2
        v = 0.5 * (torch.einsum("xyij,zk->xyzijk", oovv_t[_PAIR[xi, yi]],
                                t1_t[zi])
                   + torch.einsum("yxij,zk->xyzijk", t2p[_PAIR[yi, xi]],
                                  fvo_t[zi]))
        # joint inverse permutation back to (a,b,c)/(i,j,k) roles
        inv = [p.index(0), p.index(1), p.index(2)]
        axes = inv + [3 + r for r in inv]
        dw = (w1 - w2).permute(axes)
        dv = v.permute(axes)
        W = dw if W is None else W + dw
        V = dv if V is None else V + dv
    V = V + W
    Z = (4.0 * V
         + V.permute(0, 1, 2, 4, 5, 3)
         + V.permute(0, 1, 2, 5, 3, 4)
         - 2.0 * V.permute(0, 1, 2, 5, 4, 3)
         - 2.0 * V.permute(0, 1, 2, 3, 5, 4)
         - 2.0 * V.permute(0, 1, 2, 4, 3, 5))
    del V
    zd = Z / (eijk[None, None, None] - eabc3[..., None, None, None])
    del Z
    if act_mode is not None:
        act6 = act3[..., None, None, None] * actocc
        zd = zd * ((1.0 - act6) if act_mode == "exclude_active" else act6)
    e = (W * zd) * wgt3[..., None, None, None]
    return e.to(torch.float64).sum()


def tile_energy_resident_reference_chunk(t2sl, ovbl, vooo_t, t2p, oovv_t,
                                         t1_t, fvo_t, eijk, eabc3, wgt3,
                                         act3=None, actocc=None,
                                         act_mode=None, mode="split"):
    """Plain-torch per-tile energies (K,) fp64 for the arguments of
    tile_energy_resident_chunk; runs on any device."""
    return torch.stack([tile_energy_resident_reference(
        t2sl[k], ovbl[k], vooo_t[k], t2p[k], oovv_t[k], t1_t[k], fvo_t[k],
        eijk, eabc3[k], wgt3[k], None if act3 is None else act3[k], actocc,
        act_mode, mode) for k in range(len(t2sl))])


# --------------------------------------------------------------------------
# CUDA kernel
# --------------------------------------------------------------------------

def _lib():
    from pyscf_mpcc_tpu_torch.ops import _build
    lib = _build.load("triples_resident")
    ptr = ctypes.c_void_p
    for fn in (lib.triples_resident_f32, lib.triples_resident_f64):
        fn.argtypes = ([ctypes.c_int] * 5 + [ptr] * 12
                       + [ctypes.c_int, ptr, ptr])
        fn.restype = ctypes.c_int
    lib.triples_resident_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.triples_resident_smem_bytes.restype = ctypes.c_longlong
    lib.triples_resident_smem_max.argtypes = []
    lib.triples_resident_smem_max.restype = ctypes.c_longlong
    lib.triples_resident_stages.argtypes = [ctypes.c_int] * 3
    lib.triples_resident_stages.restype = ctypes.c_int
    lib.triples_resident_k_chunk.argtypes = [ctypes.c_int]
    lib.triples_resident_k_chunk.restype = ctypes.c_int
    for mode, kc in MMA_KC.items():
        if lib.triples_resident_k_chunk(MODES[mode]) != kc:
            raise RuntimeError(f"triples_resident.cu stages k-chunks of "
                               f"{lib.triples_resident_k_chunk(MODES[mode])}"
                               f" in mode {mode!r}; MMA_KC says {kc}")
    return lib


def max_nocc(dtype, mode, smem_bytes=None, smem_max=None):
    """The largest nocc whose cell (W and the GEMM staging) the kernel
    holds in a block's shared memory in dtype and W1 mode, by the
    kernel's own size function smem_bytes(o, itemsize, MODES[mode]) and
    limit smem_max, both the built library's unless given."""
    if smem_bytes is None:
        lib = _lib()
        smem_bytes = lib.triples_resident_smem_bytes
        smem_max = lib.triples_resident_smem_max()
    o = 1
    while smem_bytes(o + 1, dtype.itemsize, MODES[mode]) <= smem_max:
        o += 1
    return o


def _launch(t2sl, ovbl, vooo_t, t2p, oovv_t, t1_t, fvo_t, eijk, eabc3, wgt3,
            act3, actocc, act_mode, mode):
    """Check the K-stacked inputs and launch the kernel; (K,) fp64."""
    global launch_count
    if vooo_t.dim() != 5:
        raise ValueError(f"vooo_t must be (K,3,T,o*o,o), got "
                         f"{tuple(vooo_t.shape)}")
    K, T, o = vooo_t.shape[0], vooo_t.shape[2], vooo_t.shape[-1]
    dtype, dev = vooo_t.dtype, vooo_t.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, not {dtype}")
    if dtype == torch.float64 and mode != "f32":
        raise NotImplementedError(
            f"mode {mode!r} takes float32 operands on the card (bf16 "
            "products with fp32 accumulation); use mode 'f32' for float64")
    if len(t2sl) != K or len(ovbl) != K:
        raise ValueError(f"t2sl and ovbl need one entry per tile ({K})")
    # the W1 operands: (hi, lo) bf16 pairs in mode split, bf16 in mode
    # bf16, the working dtype in mode f32
    nhalf = 2 if mode == "split" else 1
    opdt = dtype if mode == "f32" else torch.bfloat16

    def halves(x):
        if mode != "split":
            return (x,)
        if not (isinstance(x, (tuple, list)) and len(x) == 2):
            raise ValueError("mode 'split' takes the W1 operands as "
                             "(hi, lo) pairs")
        return tuple(x)

    for k in range(K):
        if len(t2sl[k]) != 3 or len(ovbl[k]) != 6:
            raise ValueError("each tile needs 3 t2 slices and 6 ov blocks")
    ops = [[halves(x) for x in list(t2sl[k]) + list(ovbl[k])]
           for k in range(K)]
    if mode == "f32":
        F = ops[0][3][0].shape[-1]
        shapes = ((T, F, o * o), (T, T, o, F))
    else:     # the tiled layouts of t2_operand and ov_operand
        kc = MMA_KC[mode]
        F = ops[0][3][0].shape[2] * kc
        shapes = ((T, F // kc, -(-o * o // 8), kc // 8, 8, 8),
                  (T, T, F // kc, -(-o // 8), kc // 8, 8, 8))
    expect = []
    for k in range(K):
        for n, hl in enumerate(ops[k]):
            expect += [(x, shapes[n >= 3], opdt) for x in hl]
    expect += [(x, shape, dtype) for x, shape in (
        (vooo_t, (K, 3, T, o * o, o)), (t2p, (K, 6, T, T, o, o)),
        (oovv_t, (K, 6, T, T, o, o)), (t1_t, (K, 3, T, o)),
        (fvo_t, (K, 3, T, o)), (eijk, (o, o, o)),
        (eabc3, (K, T, T, T)), (wgt3, (K, T, T, T)))]
    if act_mode is not None:
        expect += [(act3, (K, T, T, T), dtype), (actocc, (o, o, o), dtype)]
    for x, shape, dt in expect:
        if tuple(x.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(x.shape)}")
        if x.dtype != dt:
            raise TypeError(f"expected {dt} in mode {mode!r}, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"tensors on {x.device} and {dev}")
        if not x.is_contiguous():
            raise ValueError(f"non-contiguous input of shape {shape}")
    lib = _lib()
    need = lib.triples_resident_smem_bytes(o, dtype.itemsize, MODES[mode])
    smem_max = lib.triples_resident_smem_max()
    if need > smem_max:
        top = max_nocc(dtype, mode)
        raise NotImplementedError(
            f"nocc={o} in {dtype}, mode {mode!r}: the cell's W and the "
            f"GEMM staging need {need} bytes of shared memory, over the "
            f"{smem_max} a block may use ({dtype} in mode {mode!r} runs "
            f"up to nocc {top}); ccsd_t.kernel(engine='fused') runs every "
            "mode at this nocc, and engine='auto' picks it here")
    # device addresses of each tile's W1 operands, (K, 18): the hi (or
    # only) parts of the 3 t2 slices and 6 ov blocks, then the lo parts
    # (0 unless split).  The slices are read in place (views of the
    # persistent t2 array), not copied.
    ptrs = torch.tensor([[hl[h].data_ptr() if h < nhalf else 0
                          for h in range(2) for hl in ops[k]]
                         for k in range(K)], dtype=torch.int64, device=dev)
    out = torch.empty((K, T, T, T), dtype=torch.float64, device=dev)
    fn = (lib.triples_resident_f32 if dtype == torch.float32
          else lib.triples_resident_f64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(K, T, o, F, MODES[mode], ptrs.data_ptr(), vooo_t.data_ptr(),
                 t2p.data_ptr(), oovv_t.data_ptr(), t1_t.data_ptr(),
                 fvo_t.data_ptr(), eijk.data_ptr(),
                 orbit_table(o, dev).data_ptr(), eabc3.data_ptr(),
                 wgt3.data_ptr(),
                 act3.data_ptr() if act_mode is not None else None,
                 actocc.data_ptr() if act_mode is not None else None,
                 _ACT_MODES[act_mode], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"triples_resident kernel launch failed: CUDA "
                           f"error {err}")
    launch_count += 1
    return out.reshape(K, -1).sum(1)


def tile_energy_resident_chunk(t2sl, ovbl, vooo_t, t2p, oovv_t, t1_t, fvo_t,
                               eijk, eabc3, wgt3, act3=None, actocc=None,
                               act_mode=None, interpret=False, mode="split"):
    """Per-tile energies (K,) fp64 for K tiles in one launch.

    t2sl/ovbl hold one entry per tile (the per-tile t2sl and ovbl of
    tile_energy_resident); every other per-tile array has a leading K
    axis; eijk/actocc are shared."""
    if interpret:
        raise ValueError("no interpret mode: CPU tensors run the plain "
                         "version, CUDA tensors the kernel")
    _check(mode, act_mode, act3, actocc)
    args = (t2sl, ovbl, vooo_t, t2p, oovv_t, t1_t, fvo_t, eijk, eabc3, wgt3,
            act3, actocc, act_mode, mode)
    if vooo_t.device.type == "cpu":
        return tile_energy_resident_reference_chunk(*args)
    return _launch(*args)


def tile_energy_resident(t2sl, ovbl, vooo_t, t2p, oovv_t, t1_t, fvo_t,
                         eijk, eabc3, wgt3, act3=None, actocc=None,
                         act_mode=None, interpret=False, mode="split"):
    """Tile energy (0-dim fp64) with the W dots inside the kernel.

    t2sl:   3 per-role t2 slices (T, F, o*o), [z, f, (j,k)] = t2[k,j,z,f]
            (views of the persistent t2T or its split: the kernel reads
            them in place)
    ovbl:   the 6 ordered-pair (ix|fy) blocks (PAIRS6 order), (T, T, o, F)
            t2sl and ovbl in the form of mode (t2_operand, ov_operand):
            tiled (hi, lo) bf16 pairs for 'split', tiled bf16 for 'bf16',
            dense in the dtype for 'f32'; F may be zero-padded
    vooo_t: (3, T, o*o, o) [(i,j), m] blocks
    t2p/oovv_t: (6, T, T, o, o) stacks in PAIRS9 order
    t1_t/fvo_t: (3, T, o) role-major rows
    eijk: (o, o, o); eabc3: (T, T, T) orbital-energy sums;
    wgt3: (T, T, T) degeneracy weights (zero on the padded/invalid
          region); act3: (T, T, T) virtual-active product, actocc:
          (o, o, o) occupied-active product.
    mode: 'f32', 'split' or 'bf16' (module docstring).
    """
    return tile_energy_resident_chunk(
        [t2sl], [ovbl], vooo_t[None], t2p[None], oovv_t[None], t1_t[None],
        fvo_t[None], eijk, eabc3[None], wgt3[None],
        None if act3 is None else act3[None], actocc, act_mode,
        interpret=interpret, mode=mode)[0]
