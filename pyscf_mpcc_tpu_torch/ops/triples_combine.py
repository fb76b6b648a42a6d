"""CCSD(T) per-tile permutation epilogue: CUDA kernel and plain version.

Port of ``pyscf_mpcc_tpu/ops/triples_combine.py``.  A (T) tile is

    (a) six W1 contractions  w1_p = sum_f (ix|fy) t2[k,j,z,f]  (GEMMs, in
        emit_w_dot, outside the kernel), and
    (b) the joint-permutation epilogue  W = sum_p P_p (w1_p - w2_p),
        V = W + sum_p P_p v_p, Z = 4V + V(jki) + V(kij) - 2V(kji)
        - 2V(ikj) - 2V(jik), e = sum W * Z / D * weight.

(b) is the hand-written CUDA kernel ``csrc/triples_combine.cu`` (built for
sm_90a at first use, see ``_build``), which reads the six W1 outputs in
the JAX package's W_PLAN canonical-emission layouts, so both packages take
identical inputs.  ``tile_energy_fused_reference`` is the same energy in
plain vectorized torch; the wrappers run it only for CPU tensors.  CUDA
tensors launch the kernel or raise.

The kernel's tile index is a grid dimension, so the per-tile entry
(``tile_energy_fused``) and the K-tile chunk entry
(``tile_energy_fused_chunk``) are one launch with K = 1 or K > 1.
"""

from __future__ import annotations

import ctypes

import torch

# the six joint (abc)/(ijk) permutations, as (x, y, z) role assignments
PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
# ordered role pairs, for the t2/oovv blocks
PAIRS = tuple((r1, r2) for r1 in range(3) for r2 in range(3) if r1 != r2)

# per-perm W-dot emission plan: which t2 pair layout ('jk' fused as
# (j,k), 'kj' as (k,j)) and dot operand order; with it every emitted
# block has the canonical k index minor ('swap' is the TPU kernel's
# in-register fix-up of the two non-minor occupied dims)
W_PLAN = {
    (0, 1, 2): dict(t2="jk", order="ov_first", swap=False),
    (0, 2, 1): dict(t2="kj", order="ov_first", swap=False),
    (1, 0, 2): dict(t2="jk", order="ov_first", swap=True),
    (1, 2, 0): dict(t2="kj", order="ov_first", swap=True),
    (2, 0, 1): dict(t2="jk", order="t2_first", swap=False),
    (2, 1, 0): dict(t2="kj", order="t2_first", swap=False),
}

# kernel launches made by the wrappers (CUDA tensors only)
launch_count = 0

_ACT_MODES = {None: 0, "exclude_active": 1, "only_active": 2}
# dynamic shared memory one block may use on Hopper (227 KB)
_SMEM_MAX = 232448


def _check_precision(precision):
    if precision not in (None, "highest"):
        raise NotImplementedError(
            f"precision={precision!r}: the port runs full fp32/fp64 dots "
            "only; TF32 tiers are ROADMAP work")


def emit_w_dot(p, ovb, t2op, dtype, T, o, precision=None):
    """The perm-p W1 dot in its canonical-emission form (see W_PLAN).

    ovb: (x, y, i', f) block; t2op: (z, f, pair) slice in the layout
    W_PLAN[p]['t2'].  Returns a contiguous (x, y, i, z, P1, P2) array
    (ov_first) or (z, x, y, P1, P2, i) array (t2_first)."""
    _check_precision(precision)
    if W_PLAN[p]["order"] == "ov_first":
        w = torch.tensordot(ovb.to(dtype), t2op.to(dtype), dims=([3], [1]))
        return w.reshape(T, T, o, T, o, o)
    w = torch.tensordot(t2op.to(dtype), ovb.to(dtype), dims=([1], [3]))
    # (z, (P1 P2), x, y, i) -> (z, x, y, (P1 P2), i)
    return w.permute(0, 2, 3, 1, 4).contiguous().view(T, T, T, o, o, o)


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def _canonical(x, targets):
    """Permute the trailing six dims of x (leading K kept) so that dim d
    of the result is the stored dim whose canonical target is d
    (targets: canonical slot of each stored dim; 0-2 virtual roles a,b,c,
    3-5 occupied i,j,k)."""
    return x.permute(0, *[1 + targets.index(d) for d in range(6)])


def _w1_targets(p):
    pair = ((3 + p[1], 3 + p[2]) if W_PLAN[p]["t2"] == "jk"
            else (3 + p[2], 3 + p[1]))
    if W_PLAN[p]["order"] == "ov_first":
        return (p[0], p[1], 3 + p[0], p[2]) + pair      # (x,y,i,z,P1,P2)
    return (p[2], p[0], p[1]) + pair + (3 + p[0],)      # (z,x,y,P1,P2,i)


def tile_energy_fused_reference_chunk(w_list, vooo_t, t2p, oovv_t, t1_t,
                                      fvo_t, t1c_t, fvoc_t, eijk, gabc, evt,
                                      actv=None, actocc=None, act_mode=None):
    """Plain-torch per-tile energies (K,) fp64 for a K-tile chunk (the
    arguments of tile_energy_fused_chunk); runs on any device."""
    _check_act(act_mode, actv, actocc)
    K, T, o = t2p.shape[0], t2p.shape[3], t2p.shape[-1]
    dtype = w_list[0].dtype
    W = None
    V = None
    vooo = vooo_t.reshape(K, 3, T, o, o, o)          # [x, i, j, m]
    t1 = t1_t.reshape(K, 3, T, o)
    fvo = fvo_t.reshape(K, 3, T, o)
    for p, w in zip(PERMS, w_list):
        xi, yi, zi = p
        occ = (xi, yi, zi, 3 + xi, 3 + yi, 3 + zi)     # (x,y,z,i',j',k')
        w1 = _canonical(w, _w1_targets(p))
        # w2[x,y,z,i,j,k] = sum_m (ix|jm) t2[k,m,z,y]
        w2 = torch.einsum("kxijm,kzymn->kxyzijn", vooo[:, xi],
                          t2p[:, zi, yi])
        # v = ((ix|jy) t1[k,z] + t2[j,i,y,x] fvo[z,k]) / 2
        v = 0.5 * (torch.einsum("kxyij,kzn->kxyzijn", oovv_t[:, xi, yi],
                                t1[:, zi])
                   + torch.einsum("kyxij,kzn->kxyzijn", t2p[:, yi, xi],
                                  fvo[:, zi]))
        dw = w1 - _canonical(w2, occ)
        W = dw if W is None else W + dw
        dv = _canonical(v, occ)
        V = dv if V is None else V + dv
    V = V + W
    # Z = 4V + V(jki) + V(kij) - 2V(kji) - 2V(ikj) - 2V(jik)  [ijk axes]
    Z = (4.0 * V
         + V.permute(0, 1, 2, 3, 5, 6, 4)
         + V.permute(0, 1, 2, 3, 6, 4, 5)
         - 2.0 * V.permute(0, 1, 2, 3, 6, 5, 4)
         - 2.0 * V.permute(0, 1, 2, 3, 4, 6, 5)
         - 2.0 * V.permute(0, 1, 2, 3, 5, 4, 6))
    del V
    eabc = (evt[:, 0, :, None, None] + evt[:, 1, None, :, None]
            + evt[:, 2, None, None, :])
    zd = Z / (eijk[None, None, None, None] - eabc[..., None, None, None])
    del Z
    A = gabc[:, 0, :, None, None]
    B = gabc[:, 1, None, :, None]
    C = gabc[:, 2, None, None, :]
    wgt = torch.zeros((K, T, T, T), dtype=torch.float64, device=eijk.device)
    wgt[((A >= B) & (B >= C)).expand(K, T, T, T)] = 0.5
    wgt[((A == B) & (B == C)).expand(K, T, T, T)] = 1.0 / 6.0
    wgt[((A > B) & (B > C)).expand(K, T, T, T)] = 1.0
    wgt = wgt.to(dtype)
    if act_mode is not None:
        af = (actv[:, 0, :, None, None] * actv[:, 1, None, :, None]
              * actv[:, 2, None, None, :])
        act6 = af[..., None, None, None] * actocc
        zd = zd * ((1.0 - act6) if act_mode == "exclude_active" else act6)
    e = (W * zd) * wgt[..., None, None, None]
    return e.reshape(K, -1).to(torch.float64).sum(1)


def tile_energy_fused_reference(w_list, vooo_t, t2p, oovv_t, t1_t, fvo_t,
                                t1c_t, fvoc_t, eijk, gabc, evt, actv=None,
                                actocc=None, act_mode=None):
    """Plain-torch tile energy (0-dim fp64) from the inputs of
    tile_energy_fused; runs on any device."""
    return tile_energy_fused_reference_chunk(
        [w[None] for w in w_list], vooo_t[None], t2p[None], oovv_t[None],
        t1_t[None], fvo_t[None], t1c_t[None], fvoc_t[None], eijk, gabc[None],
        evt[None], None if actv is None else actv[None], actocc,
        act_mode)[0]


# --------------------------------------------------------------------------
# CUDA kernel
# --------------------------------------------------------------------------

def _check_act(act_mode, actv, actocc):
    if act_mode not in _ACT_MODES:
        raise ValueError(f"unknown act_mode {act_mode!r}")
    if act_mode is not None and (actv is None or actocc is None):
        raise ValueError("act_mode needs actv and actocc")


def _lib():
    from pyscf_mpcc_tpu_torch.ops import _build
    lib = _build.load("triples_combine")
    ptr = ctypes.c_void_p
    for fn in (lib.triples_combine_f32, lib.triples_combine_f64):
        fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.POINTER(ptr)]
                       + [ptr] * 10 + [ctypes.c_int, ptr, ptr])
        fn.restype = ctypes.c_int
    lib.triples_combine_threads.argtypes = []
    lib.triples_combine_threads.restype = ctypes.c_int
    lib.triples_combine_staged_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.triples_combine_staged_bytes.restype = ctypes.c_longlong
    return lib


def _launch(w_list, vooo_t, t2p, oovv_t, t1_t, fvo_t, t1c_t, fvoc_t, eijk,
            gabc, evt, actv, actocc, act_mode):
    """Check the K-stacked inputs and launch the kernel; (K,) fp64."""
    global launch_count
    _check_act(act_mode, actv, actocc)
    if t2p.dim() != 7:
        raise ValueError(f"t2p must be (K,3,3,T,T,o,o), got "
                         f"{tuple(t2p.shape)}")
    K, T, o = t2p.shape[0], t2p.shape[3], t2p.shape[-1]
    dtype = t2p.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, not {dtype}")
    if len(w_list) != 6:
        raise ValueError("w_list must hold the six W_PLAN streams")
    if 6 * o * o * dtype.itemsize > _SMEM_MAX:
        raise ValueError(f"nocc={o} in {dtype}: the six o x o t2 blocks of "
                         "the w2 dots exceed the 227 KB of shared memory")
    expect = [(w, (K, T, T, o, T, o, o) if W_PLAN[p]["order"] == "ov_first"
               else (K, T, T, T, o, o, o)) for p, w in zip(PERMS, w_list)]
    expect += [(vooo_t, (K, 3, T, o * o, o)), (t2p, (K, 3, 3, T, T, o, o)),
               (oovv_t, (K, 3, 3, T, T, o, o)), (t1_t, (K, 3, T, 1, o)),
               (fvo_t, (K, 3, T, 1, o)), (t1c_t, (K, 3, T, o, 1)),
               (fvoc_t, (K, 3, T, o, 1)), (eijk, (o, o, o)),
               (evt, (K, 3, T))]
    if act_mode is not None:
        expect += [(actv, (K, 3, T)), (actocc, (o, o, o))]
    dev = t2p.device
    for x, shape in expect:
        if tuple(x.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"mixed dtypes {x.dtype} and {dtype}")
        if x.device != dev:
            raise ValueError(f"tensors on {x.device} and {dev}")
        if not x.is_contiguous():
            raise ValueError(f"non-contiguous input of shape {shape}")
    if (tuple(gabc.shape) != (K, 3, T) or gabc.dtype != torch.int32
            or gabc.device != dev or not gabc.is_contiguous()):
        raise ValueError("gabc must be a contiguous (K,3,T) int32 tensor "
                         f"on {dev}")

    lib = _lib()
    # W of one cell in shared memory when it fits (fp32 up to nocc=36,
    # fp64 up to 28); otherwise the unstaged form, whose orbits may be
    # split over several blocks per cell to fill the card
    staged = lib.triples_combine_staged_bytes(o, dtype.itemsize) <= _SMEM_MAX
    nsplit = 1
    if not staged:
        threads = lib.triples_combine_threads()
        norb = o * (o + 1) * (o + 2) // 6
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nsplit = max(1, min(-(-norb // threads),
                            -(-4 * sms // (K * T ** 3))))
    out = torch.empty((K, T, T, T, nsplit), dtype=torch.float64, device=dev)
    wptr = (ctypes.c_void_p * 6)(*[w.data_ptr() for w in w_list])
    fn = (lib.triples_combine_f32 if dtype == torch.float32
          else lib.triples_combine_f64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(K, T, o, nsplit, int(staged), wptr, vooo_t.data_ptr(),
                 t2p.data_ptr(), oovv_t.data_ptr(), t1_t.data_ptr(),
                 fvo_t.data_ptr(),
                 eijk.data_ptr(), gabc.data_ptr(), evt.data_ptr(),
                 actv.data_ptr() if act_mode is not None else None,
                 actocc.data_ptr() if act_mode is not None else None,
                 _ACT_MODES[act_mode], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"triples_combine kernel launch failed: CUDA "
                           f"error {err}")
    launch_count += 1
    return out.reshape(K, -1).sum(1)


def _check_options(interpret, kern_precision, flat):
    if interpret:
        raise ValueError("no interpret mode: CPU tensors run the plain "
                         "version, CUDA tensors the kernel")
    if flat:
        raise NotImplementedError(
            "flat=True is the TPU lane-padding layout; not ported")
    _check_precision(kern_precision)


def tile_energy_fused_chunk(w_list, vooo_t, t2p, oovv_t, t1_t, fvo_t,
                            t1c_t, fvoc_t, eijk, gabc, evt, actv=None,
                            actocc=None, act_mode=None, interpret=False,
                            kern_precision=None, flat=False):
    """Per-tile energies (K,) fp64 for a stacked chunk of K tiles.

    Arguments are those of tile_energy_fused with a leading K axis on
    every per-tile array (w_list entries, vooo_t, t2p, oovv_t, t1*/fvo*,
    gabc, evt, actv); eijk/actocc are shared across the chunk."""
    _check_options(interpret, kern_precision, flat)
    args = (w_list, vooo_t, t2p, oovv_t, t1_t, fvo_t, t1c_t, fvoc_t, eijk,
            gabc, evt, actv, actocc, act_mode)
    if t2p.device.type == "cpu":
        return tile_energy_fused_reference_chunk(*args)
    return _launch(*args)


def tile_energy_fused(w_list, vooo_t, t2p, oovv_t, t1_t, fvo_t, t1c_t,
                      fvoc_t, eijk, gabc, evt, actv=None, actocc=None,
                      act_mode=None, interpret=False, kern_precision=None,
                      flat=False):
    """Tile energy (0-dim fp64) from the six dot outputs + small slices.

    w_list:  6 arrays from emit_w_dot (canonical-emission layouts)
    vooo_t:  (3, T, o*o, o)     [(i,j), m] blocks at the three tile starts
    t2p:     (3, 3, T, T, o, o) t2 pair blocks [m/j, k] for every role pair
    oovv_t:  (3, 3, T, T, o, o) (ix|jy) blocks
    t1_t:    (3, T, 1, o);  t1c_t: (3, T, o, 1)  (column orientation)
    fvo_t:   (3, T, 1, o);  fvoc_t: (3, T, o, 1)
    eijk:    (o, o, o); gabc: (3, T) int32 global virtuals; evt: (3, T)
    """
    return tile_energy_fused_chunk(
        [w[None] for w in w_list], vooo_t[None], t2p[None], oovv_t[None],
        t1_t[None], fvo_t[None], t1c_t[None], fvoc_t[None], eijk, gabc[None],
        evt[None], None if actv is None else actv[None], actocc, act_mode,
        interpret=interpret, kern_precision=kern_precision, flat=flat)[0]
