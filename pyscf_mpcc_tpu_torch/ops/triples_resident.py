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

Unlike the JAX function, 'split' and 'bf16' take the operands unsplit, in
the working dtype: the split happens inside (the kernel forms hi and lo
while it stages an operand), which saves two copies of each operand.
"""

from __future__ import annotations

import ctypes

import torch

from pyscf_mpcc_tpu_torch.ops.triples_combine import (
    _ACT_MODES, _SMEM_MAX as _SMEM_BLOCK, PAIRS as PAIRS9, PERMS)

# ordered (x, y) role pairs consumed by the W1 dots / ov blocks; the
# t2p/oovv stacks are indexed by all ordered role pairs, PAIRS9
PAIRS6 = tuple((p[0], p[1]) for p in PERMS)
_PAIR = {pr: i for i, pr in enumerate(PAIRS9)}

MODES = {"f32": 0, "split": 1, "bf16": 2}
# dynamic shared memory a block may use, less 1 KB for the kernel's
# static shared memory
_SMEM_MAX = _SMEM_BLOCK - 1024

# kernel launches made by the wrappers (CUDA tensors only)
launch_count = 0


def hilo(x):
    """bf16 (hi, lo) split such that hi + lo ~ x to ~16 mantissa bits —
    the operand decomposition of XLA's HIGH (bf16x3) matmul precision."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(x.dtype)).to(torch.bfloat16)
    return hi, lo


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

def _w1(ov, t2, mode):
    """(Tx,Ty,o,F) . (Tz,F,oo) -> (Tx,Ty,o,Tz,oo) in the precision mode."""
    def dot(a, b):
        return torch.tensordot(a, b, dims=([3], [1]))

    if mode == "f32":
        return dot(ov, t2)
    dt = ov.dtype
    oh, ol = (x.to(dt) for x in hilo(ov))
    th, tl = (x.to(dt) for x in hilo(t2))
    if mode == "bf16":
        return dot(oh, th)
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
        w1 = _w1(ovbl[q], t2sl[zi], mode).reshape(T, T, o, T, o, o)
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
        fn.argtypes = ([ctypes.c_int] * 5 + [ptr] * 11
                       + [ctypes.c_int, ptr, ptr])
        fn.restype = ctypes.c_int
    lib.triples_resident_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.triples_resident_smem_bytes.restype = ctypes.c_longlong
    return lib


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
    F = ovbl[0][0].shape[-1]
    expect = []
    for k in range(K):
        if len(t2sl[k]) != 3 or len(ovbl[k]) != 6:
            raise ValueError("each tile needs 3 t2 slices and 6 ov blocks")
        expect += [(x, (T, F, o * o)) for x in t2sl[k]]
        expect += [(x, (T, T, o, F)) for x in ovbl[k]]
    expect += [(vooo_t, (K, 3, T, o * o, o)), (t2p, (K, 6, T, T, o, o)),
               (oovv_t, (K, 6, T, T, o, o)), (t1_t, (K, 3, T, o)),
               (fvo_t, (K, 3, T, o)), (eijk, (o, o, o)),
               (eabc3, (K, T, T, T)), (wgt3, (K, T, T, T))]
    if act_mode is not None:
        expect += [(act3, (K, T, T, T)), (actocc, (o, o, o))]
    for x, shape in expect:
        if tuple(x.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"mixed dtypes {x.dtype} and {dtype}")
        if x.device != dev:
            raise ValueError(f"tensors on {x.device} and {dev}")
        if not x.is_contiguous():
            raise ValueError(f"non-contiguous input of shape {shape}")
    lib = _lib()
    need = lib.triples_resident_smem_bytes(o, dtype.itemsize, MODES[mode])
    if need > _SMEM_MAX:
        raise NotImplementedError(
            f"nocc={o} in {dtype}, mode {mode!r}: the cell's W and the "
            f"GEMM staging need {need} bytes of shared memory, over the "
            f"{_SMEM_MAX} a block may use (float64 runs up to nocc 28, "
            "float32 up to 36); use the fused engine")
    # device addresses of each tile's t2 slices and ov blocks: the slices
    # are read in place (views of the persistent t2 array), not copied
    ptrs = torch.tensor([[x.data_ptr() for x in t2sl[k]]
                         + [x.data_ptr() for x in ovbl[k]]
                         for k in range(K)], dtype=torch.int64, device=dev)
    out = torch.empty((K, T, T, T), dtype=torch.float64, device=dev)
    fn = (lib.triples_resident_f32 if dtype == torch.float32
          else lib.triples_resident_f64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(K, T, o, F, MODES[mode], ptrs.data_ptr(), vooo_t.data_ptr(),
                 t2p.data_ptr(), oovv_t.data_ptr(), t1_t.data_ptr(),
                 fvo_t.data_ptr(), eijk.data_ptr(), eabc3.data_ptr(),
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
            (views of the persistent t2T: the kernel reads them in place)
    ovbl:   the 6 ordered-pair (ix|fy) blocks (PAIRS6 order), (T, T, o, F)
    vooo_t: (3, T, o*o, o) [(i,j), m] blocks
    t2p/oovv_t: (6, T, T, o, o) stacks in PAIRS9 order
    t1_t/fvo_t: (3, T, o) role-major rows
    eijk: (o, o, o); eabc3: (T, T, T) orbital-energy sums;
    wgt3: (T, T, T) degeneracy weights (zero on the padded/invalid
          region); act3: (T, T, T) virtual-active product, actocc:
          (o, o, o) occupied-active product.
    mode: 'f32', 'split' or 'bf16' (module docstring); operands unsplit.
    """
    return tile_energy_resident_chunk(
        [t2sl], [ovbl], vooo_t[None], t2p[None], oovv_t[None], t1_t[None],
        fvo_t[None], eijk, eabc3[None], wgt3[None],
        None if act3 is None else act3[None], actocc, act_mode,
        interpret=interpret, mode=mode)[0]
