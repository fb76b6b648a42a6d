"""CCSD(T) per-tile permutation epilogue: CUDA kernel and plain version.

Port of ``pyscf_mpcc_tpu/ops/triples_combine.py``.  A (T) tile is

    (a) six W1 contractions  w1_p = sum_f (ix|fy) t2[k,j,z,f]  (GEMMs, in
        emit_w_dot, outside the kernel, at the W1 precision of
        ``W1_MODES``), and
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

W1 precision.  dot_precision None or 'highest' runs the W1 GEMMs in the
working dtype (fp32 with TF32 off on the card).  The bf16 tiers compute
the JAX package's explicit bf16 functions (``ops/triples_resident.py``
``hilo`` and ``_dot3``): 'high' is hi.hi + hi.lo + lo.hi of bf16
(hi, lo) operand parts, 'default' hi.hi alone, the products summed in the
working dtype.  On the card each W1 product is then one bf16 GEMM with
fp32 output (``torch.mm(..., out_dtype=torch.float32)``), the K axis
tripled for 'high': [oh | oh | ol] . [th ; tl ; th].  The operands are
split once: t2 once a call (``w1_t2``, f-major parts), each ov block once
a tile (``w1_ov``).  The combine kernel reads the same W_PLAN streams at
every tier; its w2, V and energy math stay in the working dtype.
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

# kernel launches made by the wrappers (CUDA tensors only); the profile
# form (tile_energy_fused_profile) counts in its own
launch_count = 0
profile_launch_count = 0
# phases of a cell in the profile form (enum Phase of triples_combine.cu)
PHASES = ("setup", "w_build", "w2_dots", "v_staging", "orbit", "block_sum")

_ACT_MODES = {None: 0, "exclude_active": 1, "only_active": 2}

# dot_precision -> W1 mode: None/'highest' full dots in the working
# dtype, 'high' the bf16x3 split, 'default' one bf16 pass; and back
W1_MODES = {None: "f32", "highest": "f32", "high": "split",
            "default": "bf16"}
PRECISION = {"f32": None, "split": "high", "bf16": "default"}
# f-chunks of the t2 split (w1_t2): its temporaries stay this fraction
# of a t2 copy
T2_SPLIT_CHUNKS = 16


_ORBITS = {}


def orbit_table(o, device):
    """The occupied orbits {sigma(i,j,k)} as one int32 per orbit,
    r0 | r1 << 8 | r2 << 16 with r0 >= r1 >= r2, r0 slowest: the
    (o (o+1) (o+2) / 6,) table of the kernels' orbit phase, built once per
    (nocc, device)."""
    key = (o, str(torch.device(device)))
    if key not in _ORBITS:
        if not 0 < o < 256:
            raise ValueError(f"nocc={o}: the orbit table packs 8 bits a "
                             "slot")
        codes = [r0 | r1 << 8 | r2 << 16 for r0 in range(o)
                 for r1 in range(r0 + 1) for r2 in range(r1 + 1)]
        _ORBITS[key] = torch.tensor(codes, dtype=torch.int32,
                                    device=device)
    return _ORBITS[key]


def w1_mode(precision):
    """The W1 mode ('f32', 'split' or 'bf16') of a dot_precision."""
    if isinstance(precision, str):
        precision = precision.lower()
    if precision not in W1_MODES:
        raise ValueError(f"dot_precision={precision!r}: takes None, "
                         "'highest', 'high' or 'default'")
    return W1_MODES[precision]


def hilo(x):
    """bf16 (hi, lo) split such that hi + lo ~ x to ~16 mantissa bits —
    the operand decomposition of XLA's HIGH (bf16x3) matmul precision."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(x.dtype)).to(torch.bfloat16)
    return hi, lo


def w1_ov(ov, mode):
    """ov blocks (..., F) as emit_w_dot's W1 operand in mode: ov itself
    in 'f32'; else bf16 [oh | oh | ol] along F ('split') or oh ('bf16'),
    the left factor of the tripled-K product."""
    if mode == "f32":
        return ov
    hi, lo = hilo(ov)
    return hi if mode == "bf16" else torch.cat([hi, hi, lo], -1)


def w1_t2(t2T, mode):
    """The persistent t2 layout (S, F, N) as the W1 operand store of
    mode: t2T itself in 'f32'; else its bf16 parts f-major, (P F, S, N)
    with [hi ; lo] (P = 2, 'split') or hi (P = 1, 'bf16'), split in
    T2_SPLIT_CHUNKS f-chunks so that the temporaries stay small."""
    if mode == "f32":
        return t2T
    S, f, n = t2T.shape
    nparts = 2 if mode == "split" else 1
    out = torch.empty((nparts * f, S, n), dtype=torch.bfloat16,
                      device=t2T.device)
    step = -(-f // T2_SPLIT_CHUNKS)
    for f0 in range(0, f, step):
        f1 = min(f0 + step, f)
        x = t2T[:, f0:f1].transpose(0, 1)
        hi = out[f0:f1]
        hi.copy_(x)
        if nparts == 2:
            out[f + f0:f + f1].copy_(x - hi.to(x.dtype))
    return out


def w1_t2_slice(t2w, s, T, mode):
    """The z-slice [s, s + T) of a w1_t2 store as emit_w_dot's W1
    operand: the (T, F, N) slice in 'f32'; else a (K, T N) bf16 matrix,
    [th ; tl ; th] (K = 3F, a copy) in 'split', th (K = F, a view) in
    'bf16'."""
    if mode == "f32":
        return t2w[s:s + T]
    x = t2w[:, s:s + T]
    if mode == "bf16":
        return x.flatten(1)
    f = x.shape[0] // 2
    return torch.cat([x[:f], x[f:], x[:f]]).flatten(1)


def _emitted(p, w, T, o):
    """A W1 product in its canonical-emission layout: ov_first products
    come as (x, y, i, z, (P1 P2)) and only split their axes; t2_first
    products come as (z, (P1 P2), x, y, i) and move the pair before i."""
    if W_PLAN[p]["order"] == "ov_first":
        return w.reshape(T, T, o, T, o, o)
    return w.reshape(T, o * o, T, T, o).permute(0, 2, 3, 1, 4) \
        .contiguous().view(T, T, T, o, o, o)


def emit_w_dot(p, ovb, t2op, dtype, T, o, precision=None):
    """The perm-p W1 dot in its canonical-emission form (see W_PLAN).

    Full precision (None, 'highest'): ovb is the (x, y, i', f) block and
    t2op the (z, f, pair) slice in the layout W_PLAN[p]['t2'], in the
    working dtype.  bf16 tiers ('high', 'default'): ovb is w1_ov of the
    block, (x, y, i', K), and t2op w1_t2_slice of the slice, (K, z pair),
    in bf16.  Returns a contiguous (x, y, i, z, P1, P2) array (ov_first)
    or (z, x, y, P1, P2, i) array (t2_first) in dtype.  CPU tensors take
    the plain version at the bf16 tiers (emit_w_dot_reference); CUDA
    tensors one bf16 GEMM with fp32 output, so dtype must be float32."""
    mode = w1_mode(precision)
    ov_first = W_PLAN[p]["order"] == "ov_first"
    if mode == "f32":
        if ov_first:
            w = torch.tensordot(ovb.to(dtype), t2op.to(dtype),
                                dims=([3], [1]))
        else:
            w = torch.tensordot(t2op.to(dtype), ovb.to(dtype),
                                dims=([1], [3]))
        return _emitted(p, w, T, o)
    if ovb.device.type == "cpu":
        return emit_w_dot_reference(p, ovb, t2op, dtype, T, o, precision)
    if dtype != torch.float32:
        raise ValueError(f"dot_precision={precision!r} on the card: bf16 "
                         f"products with fp32 output, not {dtype}")
    a = ovb.reshape(T * T * o, -1)
    if ov_first:
        w = torch.mm(a, t2op, out_dtype=torch.float32)
    else:
        w = torch.mm(t2op.T, a.T, out_dtype=torch.float32)
    return _emitted(p, w, T, o)


def emit_w_dot_reference(p, ovb, t2op, dtype, T, o, precision):
    """Plain version of emit_w_dot at a bf16 tier, on any device: the
    products of the bf16 parts (oh th, oh tl, ol th for 'high'; oh th for
    'default') in dtype, summed in that order, as the JAX package's
    _dot3."""
    nparts = 3 if w1_mode(precision) == "split" else 1
    f = t2op.shape[0] // nparts
    w = None
    for a, b in zip(ovb.split(f, -1), t2op.split(f, 0)):
        if W_PLAN[p]["order"] == "ov_first":
            d = torch.tensordot(a.to(dtype), b.to(dtype), dims=([3], [0]))
        else:
            d = torch.tensordot(b.to(dtype), a.to(dtype), dims=([0], [3]))
        w = d if w is None else w + d
    return _emitted(p, w, T, o)


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
    # (K, T, o, nsplit, staged, w, vooo, t2p, oovv, t1, fvo, eijk, orbits,
    # gabc, evt, actv, actocc, act_mode, out[, prof], stream)
    args = ([ctypes.c_int] * 5 + [ctypes.POINTER(ptr)] + [ptr] * 11
            + [ctypes.c_int, ptr])
    for tag in ("", "profile_"):
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"triples_combine_{tag}{dt}")
            fn.argtypes = args + ([ptr, ptr] if tag else [ptr])
            fn.restype = ctypes.c_int
    lib.triples_combine_threads.argtypes = []
    lib.triples_combine_threads.restype = ctypes.c_int
    for fn in (lib.triples_combine_staged_bytes, lib.triples_combine_v_staged):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.triples_combine_staged_bytes.restype = ctypes.c_longlong
    lib.triples_combine_v_staged.restype = ctypes.c_int
    lib.triples_combine_smem_max.argtypes = []
    lib.triples_combine_smem_max.restype = ctypes.c_longlong
    return lib


def _launch(w_list, vooo_t, t2p, oovv_t, t1_t, fvo_t, t1c_t, fvoc_t, eijk,
            gabc, evt, actv, actocc, act_mode, profile=False):
    """Check the K-stacked inputs and launch the kernel; (K,) fp64, and
    with profile the (K, T, T, T, 7) int64 phase clocks of every cell."""
    global launch_count, profile_launch_count
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
    smem_max = lib.triples_combine_smem_max()
    if 6 * o * o * dtype.itemsize > smem_max:
        raise ValueError(f"nocc={o} in {dtype}: the six o x o t2 blocks of "
                         f"the w2 dots exceed the {smem_max} bytes of shared "
                         "memory a block may use")
    # W of one cell in shared memory when it fits (fp32 up to nocc=36,
    # fp64 up to 28); otherwise the unstaged form, whose orbits may be
    # split over several blocks per cell to fill the card
    staged = (lib.triples_combine_staged_bytes(o, dtype.itemsize)
              <= smem_max)
    if profile and not staged:
        raise ValueError(f"nocc={o} in {dtype}: the profile form times the "
                         "staged form only (one block a cell)")
    nsplit = 1
    if not staged:
        threads = lib.triples_combine_threads()
        norb = o * (o + 1) * (o + 2) // 6
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nsplit = max(1, min(-(-norb // threads),
                            -(-4 * sms // (K * T ** 3))))
    out = torch.empty((K, T, T, T, nsplit), dtype=torch.float64, device=dev)
    wptr = (ctypes.c_void_p * 6)(*[w.data_ptr() for w in w_list])
    tag = "profile_" if profile else ""
    fn = getattr(lib, f"triples_combine_{tag}"
                 f"{'f32' if dtype == torch.float32 else 'f64'}")
    prof = (torch.zeros((K, T, T, T, len(PHASES) + 1), dtype=torch.int64,
                        device=dev) if profile else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(K, T, o, nsplit, int(staged), wptr, vooo_t.data_ptr(),
                 t2p.data_ptr(), oovv_t.data_ptr(), t1_t.data_ptr(),
                 fvo_t.data_ptr(),
                 eijk.data_ptr(), orbit_table(o, dev).data_ptr(),
                 gabc.data_ptr(), evt.data_ptr(),
                 actv.data_ptr() if act_mode is not None else None,
                 actocc.data_ptr() if act_mode is not None else None,
                 _ACT_MODES[act_mode], out.data_ptr(),
                 *((prof.data_ptr(),) if profile else ()), stream)
    if err != 0:
        raise RuntimeError(f"triples_combine kernel launch failed: CUDA "
                           f"error {err}")
    e = out.reshape(K, -1).sum(1)
    if profile:
        profile_launch_count += 1
        return e, prof
    launch_count += 1
    return e


def _check_options(interpret, kern_precision, flat):
    if interpret:
        raise ValueError("no interpret mode: CPU tensors run the plain "
                         "version, CUDA tensors the kernel")
    if flat:
        raise NotImplementedError(
            "flat=True is the TPU lane-padding layout; not ported")
    if w1_mode(kern_precision) != "f32":
        raise ValueError(f"kern_precision={kern_precision!r}: the kernel's "
                         "w2, V and energy math run in the working dtype; "
                         "pass None or 'highest'")


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


def tile_energy_fused_profile(w_list, vooo_t, t2p, oovv_t, t1_t, fvo_t,
                              t1c_t, fvoc_t, eijk, gabc, evt, actv=None,
                              actocc=None, act_mode=None):
    """The kernel's profile form on one tile (CUDA tensors only): the
    tile energy (0-dim fp64) and a (T, T, T, 7) int64 tensor of each
    cell's SM clocks per phase (PHASES order) and in all (last column);
    cells of weight zero stay 0.  Staged form only (fp32 up to nocc 36,
    fp64 up to 28; beyond, it raises).  A measurement aid; no engine calls
    it."""
    if t2p.device.type != "cuda":
        raise ValueError("the profile form runs on a CUDA device only")
    e, prof = _launch(
        [w[None] for w in w_list], vooo_t[None], t2p[None], oovv_t[None],
        t1_t[None], fvo_t[None], t1c_t[None], fvoc_t[None], eijk, gabc[None],
        evt[None], None if actv is None else actv[None], actocc, act_mode,
        profile=True)
    return e[0], prof[0]


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
