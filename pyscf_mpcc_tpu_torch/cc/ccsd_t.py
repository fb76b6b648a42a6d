"""Closed-shell CCSD(T) — perturbative triples.

Port of ``pyscf_mpcc_tpu/cc/ccsd_t.py``: a loop over tiles of the
lower-triangular (a>=b>=c) virtual-triple space; each tile evaluates the
six jointly-permuted W contributions

    w[x,y,z,i,j,k] = sum_f (ix|fy) t2[k,j,z,f] - sum_m (ix|jm) t2[k,m,z,y]

with (ix|fy) rebuilt on the fly from DF factors (no O(nocc nvir^3) ovvv
storage), the 4/1/1/-2/-2/-2 permutation combine, degeneracy weights from
global virtual indices, and per-tile energies summed once in fp64.
Virtuals are zero-padded to a tile multiple (padded energies 1e6).

E(T) = 2 * sum_{a>=b>=c} weight(abc) sum_ijk W * Z / D.

Engines: 'fused' runs the six W1 GEMMs in torch and the epilogue in the
CUDA kernel of ops/triples_combine (its plain version for CPU tensors);
'resident' runs the whole tile, W1 dots included, in the CUDA kernel of
ops/triples_resident, so W never reaches device memory; 'xla' is the
whole tile in plain torch (the port of the JAX package's XLA engine, the
independent CPU oracle).  Each engine runs every dot_precision and, at
one tier, computes one function.  'auto' picks (auto_engine) 'xla' for
CPU tensors and, for CUDA tensors, 'fused' at full precision; for the
bf16 tiers (dot_precision 'high' or 'default') 'resident' where its
kernel holds a cell of nocc in shared memory (fp32 up to nocc 36) and
'fused' beyond.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
from pyscf_mpcc_tpu_torch.ops import triples_resident as tr
from pyscf_mpcc_tpu_torch.utils.profiling import count, span

PERMS = tc.PERMS

# dot_precision -> W1 mode of every engine.  The port's default (None)
# is full fp32 dots, TF32 off; 'high' is the JAX package's bf16x3
# ('split'); 'default' a single bf16 pass, opt-in.
RESIDENT_MODES = tc.W1_MODES


def _tile_triples(nvt):
    """All (ta >= tb >= tc) tile-index triples as an (n, 3) int array."""
    out = [(a, b, c)
           for a in range(nvt) for b in range(a + 1) for c in range(b + 1)]
    return np.asarray(out, dtype=np.int32)


def mesh_block(trips, mesh):
    """The contiguous block of the tile list that this rank of a mesh
    (parallel/mesh) scans: the whole list without a mesh.  The JAX package
    pads the list to a mesh multiple with weight-zero copies of tile 0 and
    gives each device one contiguous block of the padded list; the pads
    add exactly nothing, so here they are left out and the last ranks'
    blocks are shorter (or empty)."""
    if mesh is None:
        return trips
    per = -(-len(trips) // mesh.size)
    return trips[mesh.rank * per:(mesh.rank + 1) * per]


def mesh_total(e_tiles, mesh):
    """The fp64 sum of the per-tile energies, over the ranks of the mesh
    when there is one (each rank's block sum, then an all_reduce in
    fp64)."""
    e = e_tiles.sum()
    return e if mesh is None else mesh.psum(e.reshape(1))[0]


def _prepare(t1, t2, eris, tile, dtype, act_hole, act_particle, vfac,
             engine, rmode="f32"):
    """Padded, relaid-out tensors shared by every tile (the JAX package's
    ``big_arrays``) plus the static sizes.  rmode is the W1 mode
    (RESIDENT_MODES).  In 'split' and 'bf16' the W1 operands are split
    into bf16 once here, beside the fp32 t2T that the w2 and V terms
    read: for the resident engine t2T_w1, t2T in the kernel's tiled
    layout (tr.t2_operand); for the fused engine t2T_w1 and t2Ts_w1,
    t2T and t2Ts as f-major parts (tc.w1_t2), after which the fp32 t2Ts,
    which only the W1 dots read, is dropped."""
    nocc, nvir = t1.shape
    dev = t2.device
    f = eris.fock
    eo = eris.mo_energy[:nocc].to(dtype)
    ev = eris.mo_energy[nocc:].to(dtype)
    fvo = f[nocc:, :nocc].to(dtype)
    nvp = ((nvir + tile - 1) // tile) * tile
    pad = nvp - nvir

    def padv(x, axes):
        if not pad:
            return x
        cfg = []
        for ax in reversed(range(x.dim())):
            cfg += [0, pad if ax in axes else 0]
        return F.pad(x, cfg)

    ev_p = (torch.cat([ev, torch.full((pad,), 1e6, dtype=dtype, device=dev)])
            if pad else ev)
    t1p = padv(t1.to(dtype), [1])
    fvo_p = padv(fvo, [0])
    if vfac != 1.0:
        # QCISD(T): the disconnected-singles V term enters with weight
        # vfac; t1p/fvo_p feed ONLY the V term in every engine
        t1p = t1p * vfac
        fvo_p = fvo_p * vfac
    o = nocc
    oo = o * o
    t2d = t2.to(dtype)
    big = dict(T=tile, o=o, nvp=nvp, ev_p=ev_p, eo=eo, t1p=t1p,
               fvo_p=fvo_p)
    # t2T[c, f, (j,k)] = t2[k, j, c, f]
    big["t2T"] = padv(t2d.permute(2, 3, 1, 0), [0, 1]).reshape(nvp, nvp, oo)
    # vooo[a, i, (j,m)] = (ia|jm)
    big["vooo"] = padv(eris.ovoo.to(dtype).permute(1, 0, 2, 3),
                       [0]).reshape(nvp, o, oo)
    if engine in ("fused", "resident"):
        # oovv_T[x, y, (i,j)] = (ix|jy); the swapped-pair layout
        # t2Ts[c, f, (k,j)] = t2[j, k, c, f] only feeds the fused engine's
        # canonical-emission dots (the resident kernel derives every perm
        # from t2T alone).  Split before oovv_T is made, so that the
        # split's peak is no higher than the loop's
        if engine == "fused":
            big["precision"] = tc.PRECISION[rmode]
            big["t2T_w1"] = tc.w1_t2(big["t2T"], rmode)
            big["t2Ts_w1"] = tc.w1_t2(padv(t2d.permute(2, 3, 0, 1),
                                           [0, 1]).reshape(nvp, nvp, oo),
                                      rmode)
        big["oovv_T"] = padv(eris.ovov.to(dtype).permute(1, 3, 0, 2),
                             [0, 1]).reshape(nvp, nvp, oo)
        if engine == "resident":
            big["rmode"] = rmode
            big["t2T_w1"] = tr.t2_operand(big["t2T"], rmode)
    else:
        # oovv_r[i, j, x, y] = (ix|jy)
        big["oovv_r"] = padv(eris.ovov.to(dtype).permute(0, 2, 1, 3),
                             [2, 3]).contiguous()
    if eris.Lov is not None:
        big["Lov"] = padv(eris.Lov.to(dtype), [2])
        big["Lvv"] = padv(eris.Lvv.to(dtype), [1, 2])
    else:
        big["ovvv"] = padv(eris.ovvv.to(dtype), [1, 2, 3])
    if act_hole is not None:
        ao_m = np.zeros(nocc, dtype=bool)
        ao_m[np.asarray(act_hole, dtype=int)] = True
        av_m = np.zeros(nvp, dtype=bool)
        av_m[np.asarray(act_particle, dtype=int)] = True
        big["act_occ"] = torch.tensor(ao_m, device=dev).to(dtype)
        big["act_vir"] = torch.tensor(av_m, device=dev).to(dtype)
    return big


def _ov_block(big, x0, y0):
    """(T, T, o, nvp) block ov[x, y, i, f] = (i x | f y)."""
    T = big["T"]
    if "ovvv" in big:
        return big["ovvv"][:, x0:x0 + T, :, y0:y0 + T].permute(1, 3, 0, 2)
    lo = big["Lov"][:, :, x0:x0 + T]
    lv = big["Lvv"][:, :, y0:y0 + T]
    return torch.einsum("Lix,Lfy->xyif", lo, lv)


def _weights(starts, T, dtype, device):
    """Degeneracy weight (T, T, T) on global virtual indices."""
    g = [torch.arange(s, s + T, device=device) for s in starts]
    A = g[0][:, None, None]
    B = g[1][None, :, None]
    C = g[2][None, None, :]
    wgt = torch.zeros((T, T, T), dtype=torch.float64, device=device)
    wgt[((A >= B) & (B >= C)).expand(T, T, T)] = 0.5
    wgt[((A == B) & (B == C)).expand(T, T, T)] = 1.0 / 6.0
    wgt[((A > B) & (B > C)).expand(T, T, T)] = 1.0
    return wgt.to(dtype)


def _w1_einsum(ovb, t2z, w1mode):
    """w1[x,y,z,i,(j,k)] = sum_f ov[x,y,i,f] t2T[z,f,(j,k)] in the W1 mode
    (RESIDENT_MODES): bf16 hi/lo products summed in the working dtype."""
    def dot(a, b):
        return torch.einsum("xyif,zfm->xyzim", a.to(ovb.dtype),
                            b.to(ovb.dtype))

    if w1mode == "f32":
        return dot(ovb, t2z)
    (oh, ol), (th, tl) = tc.hilo(ovb), tc.hilo(t2z)
    if w1mode == "bf16":
        return dot(oh, th)
    return dot(oh, th) + dot(oh, tl) + dot(ol, th)


def make_tile_energy(big, mode="exclude_active", w1mode="f32"):
    """The 'xla' engine: whole tile in plain torch; abc -> 0-dim fp64.
    w1mode: the W1 dots' mode (RESIDENT_MODES), as in the resident
    engine."""
    T, o, nvp = big["T"], big["o"], big["nvp"]
    t2T, vooo, oovv_r = big["t2T"], big["vooo"], big["oovv_r"]
    t1p, fvo_p, ev_p, eo = big["t1p"], big["fvo_p"], big["ev_p"], big["eo"]
    act_occ, act_vir = big.get("act_occ"), big.get("act_vir")
    dtype, dev = t2T.dtype, t2T.device

    def tile_energy(abc):
        starts = tuple(int(r) * T for r in abc)
        t2T_s = [t2T[s:s + T] for s in starts]
        vooo_s = [vooo[s:s + T] for s in starts]
        ovb = {(xi, yi): _ov_block(big, starts[xi], starts[yi])
               for (xi, yi) in set((p[0], p[1]) for p in PERMS)}
        W = torch.zeros((T, T, T, o, o, o), dtype=dtype, device=dev)
        V = torch.zeros_like(W)
        for p in PERMS:
            xi, yi, zi = p
            # w1[x,y,z,i,(j,k)] = sum_f ov[x,y,i,f] t2T[z,f,(j,k)]
            w = _w1_einsum(ovb[(xi, yi)], t2T_s[zi], w1mode)
            w = w.reshape(T, T, T, o, o, o)
            # w2[x,y,z,i,j,k] = sum_m vooo[x,i,(j,m)] t2[k,m,z,y];
            # t2[k,m,z,y] = t2T[z,y,(m,k)]
            t2zy = t2T_s[zi][:, starts[yi]:starts[yi] + T].reshape(T, T, o, o)
            w = w - torch.einsum("xijm,zymk->xyzijk",
                                 vooo_s[xi].reshape(T, o, o, o), t2zy)
            # v[x,y,z,i,j,k] = (ix|jy) t1[k,z]/2 + t2[j,i,y,x] fvo[z,k]/2
            oovv_xy = oovv_r[:, :, starts[xi]:starts[xi] + T,
                             starts[yi]:starts[yi] + T]
            t1z = t1p[:, starts[zi]:starts[zi] + T]
            fvoz = fvo_p[starts[zi]:starts[zi] + T]
            t2yx = t2T_s[yi][:, starts[xi]:starts[xi] + T].reshape(T, T, o, o)
            v = 0.5 * (torch.einsum("ijxy,kz->xyzijk", oovv_xy, t1z)
                       + torch.einsum("yxij,zk->xyzijk", t2yx, fvoz))
            # joint inverse permutation back to (a,b,c)/(i,j,k) roles
            inv = [p.index(0), p.index(1), p.index(2)]
            axes = inv + [3 + q for q in inv]
            W += w.permute(axes)
            V += v.permute(axes)
        V += W
        # Z = 4V + V(jki) + V(kij) - 2V(kji) - 2V(ikj) - 2V(jik)
        Z = (4.0 * V
             + V.permute(0, 1, 2, 4, 5, 3)
             + V.permute(0, 1, 2, 5, 3, 4)
             - 2.0 * V.permute(0, 1, 2, 5, 4, 3)
             - 2.0 * V.permute(0, 1, 2, 3, 5, 4)
             - 2.0 * V.permute(0, 1, 2, 4, 3, 5))
        del V
        ev3 = [ev_p[s:s + T] for s in starts]
        eabc = ev3[0][:, None, None] + ev3[1][None, :, None] \
            + ev3[2][None, None, :]
        eijk = eo[:, None, None] + eo[None, :, None] + eo[None, None, :]
        zd = Z / (eijk[None, None, None] - eabc[:, :, :, None, None, None])
        if act_occ is not None:
            ax, ay, az = (act_vir[s:s + T] for s in starts)
            act6 = (ax[:, None, None, None, None, None]
                    * ay[None, :, None, None, None, None]
                    * az[None, None, :, None, None, None]
                    * act_occ[None, None, None, :, None, None]
                    * act_occ[None, None, None, None, :, None]
                    * act_occ[None, None, None, None, None, :])
            zd = zd * ((1.0 - act6) if mode == "exclude_active" else act6)
        e_tile = torch.einsum("xyzijk,xyzijk->xyz", W, zd)
        return (e_tile * _weights(starts, T, dtype, dev)).to(
            torch.float64).sum()

    return tile_energy


def make_prep_fused(big):
    """Per-tile prep for the fused epilogue: the six canonical-emission W
    GEMMs (ops/triples_combine.W_PLAN) at big['precision'] and the small
    per-tile slices, as the argument tuple of tile_energy_fused (plus
    actv when masked).  At the bf16 tiers the six ov blocks are split
    once a tile (tc.w1_ov) and each t2 slice that the dots read once a
    tile (tc.w1_t2_slice)."""
    T, o = big["T"], big["o"]
    oo = o * o
    t2T, vooo, oovv_T = big["t2T"], big["vooo"], big["oovv_T"]
    prec = big["precision"]
    mode = tc.w1_mode(prec)
    t2w = {"jk": big["t2T_w1"], "kj": big["t2Ts_w1"]}
    t1p, fvo_p, ev_p = big["t1p"], big["fvo_p"], big["ev_p"]
    act_vir = big.get("act_vir")
    dtype, dev = t2T.dtype, t2T.device

    def prep(abc):
        starts = tuple(int(r) * T for r in abc)
        ovb = {(p[0], p[1]): tc.w1_ov(_ov_block(big, starts[p[0]],
                                                 starts[p[1]]), mode)
               for p in PERMS}
        t2sl = {key: tc.w1_t2_slice(t2w[key[0]], starts[key[1]], T, mode)
                for key in {(tc.W_PLAN[p]["t2"], p[2]) for p in PERMS}}
        w_list = [tc.emit_w_dot(p, ovb[(p[0], p[1])],
                                t2sl[(tc.W_PLAN[p]["t2"], p[2])],
                                dtype, T, o, prec)
                  for p in PERMS]
        del ovb, t2sl
        vooo_t = torch.stack([vooo[s:s + T].reshape(T, oo, o)
                              for s in starts])
        t2p = torch.stack([torch.stack([
            t2T[s1:s1 + T, s2:s2 + T].reshape(T, T, o, o) for s2 in starts])
            for s1 in starts])
        oovv_t = torch.stack([torch.stack([
            oovv_T[s1:s1 + T, s2:s2 + T].reshape(T, T, o, o)
            for s2 in starts]) for s1 in starts])
        t1s = [t1p[:, s:s + T].T for s in starts]
        fvos = [fvo_p[s:s + T] for s in starts]
        t1_t = torch.stack([x[:, None, :] for x in t1s])
        fvo_t = torch.stack([x[:, None, :] for x in fvos])
        t1c_t = torch.stack([x[:, :, None] for x in t1s])
        fvoc_t = torch.stack([x[:, :, None] for x in fvos])
        evt = torch.stack([ev_p[s:s + T] for s in starts])
        gabc = torch.stack([torch.arange(s, s + T, dtype=torch.int32,
                                         device=dev) for s in starts])
        out = (w_list, vooo_t, t2p, oovv_t, t1_t, fvo_t, t1c_t, fvoc_t,
               gabc, evt)
        if act_vir is not None:
            out = out + (torch.stack([act_vir[s:s + T] for s in starts]),)
        return out

    return prep


def make_prep_resident(big):
    """Per-tile prep for the resident kernel: operand slices only (the W
    dots run in the kernel), as the argument tuple of
    tile_energy_resident in the W1 mode big['rmode'] (plus act3 when
    masked).  The t2 slices are views of the persistent t2T_w1; the ov
    blocks are DF products (or ovvv slices) made, and in 'split'/'bf16'
    split, here."""
    T, o = big["T"], big["o"]
    oo = o * o
    t2T, vooo, oovv_T = big["t2T"], big["vooo"], big["oovv_T"]
    rmode, t2w, nvp = big["rmode"], big["t2T_w1"], big["nvp"]
    fpad = nvp if rmode == "f32" else -(-nvp // tr.MMA_KC[rmode]) \
        * tr.MMA_KC[rmode]
    t1p, fvo_p, ev_p = big["t1p"], big["fvo_p"], big["ev_p"]
    act_vir = big.get("act_vir")
    dtype, dev = t2T.dtype, t2T.device

    def pair_stack(x, starts):
        return torch.stack([x[starts[r1]:starts[r1] + T,
                              starts[r2]:starts[r2] + T].reshape(T, T, o, o)
                            for (r1, r2) in tr.PAIRS9])

    def prep(abc):
        starts = tuple(int(r) * T for r in abc)
        if rmode == "split":
            t2sl = [(t2w[0][s:s + T], t2w[1][s:s + T]) for s in starts]
        else:
            t2sl = [t2w[s:s + T] for s in starts]
        # the six ov blocks in one stack, f already padded for the split,
        # so that it is split and tiled in a few launches
        ov = torch.empty((6, T, T, o, fpad), dtype=dtype, device=dev)
        ov[..., nvp:] = 0
        for q, (x, y) in enumerate(tr.PAIRS6):
            ov[q, ..., :nvp] = _ov_block(big, starts[x], starts[y])
        ovw = tr.ov_operand(ov, rmode)
        if rmode == "split":
            ovbl = list(zip(ovw[0].unbind(0), ovw[1].unbind(0)))
        else:
            ovbl = list(ovw.unbind(0))
        vooo_t = torch.stack([vooo[s:s + T].reshape(T, oo, o)
                              for s in starts])
        t1_t = torch.stack([t1p[:, s:s + T].T for s in starts])
        fvo_t = torch.stack([fvo_p[s:s + T] for s in starts])
        ev3 = [ev_p[s:s + T] for s in starts]
        eabc3 = (ev3[0][:, None, None] + ev3[1][None, :, None]
                 + ev3[2][None, None, :])
        out = (t2sl, ovbl, vooo_t, pair_stack(t2T, starts),
               pair_stack(oovv_T, starts), t1_t, fvo_t, eabc3,
               _weights(starts, T, dtype, dev))
        if act_vir is not None:
            a3 = [act_vir[s:s + T] for s in starts]
            out = out + (a3[0][:, None, None] * a3[1][None, :, None]
                         * a3[2][None, None, :],)
        return out

    return prep


def stack_prep_resident(outs):
    """K per-tile resident prep tuples as the argument layout of
    tile_energy_resident_chunk: t2sl/ovbl as per-tile lists (never
    copied), the rest stacked along a new leading axis."""
    return ([x[0] for x in outs], [x[1] for x in outs]) + tuple(
        torch.stack([x[f] for x in outs]) for f in range(2, len(outs[0])))


def stack_prep(outs):
    """Stack K per-tile prep tuples along a new leading axis (the
    argument layout of tile_energy_fused_chunk); one tile is only viewed
    with a unit axis, not copied (its W streams are 403 MB in fp32 at
    the (H2O)8 shape)."""
    if len(outs) == 1:
        return ([w[None] for w in outs[0][0]],) + tuple(
            x[None] for x in outs[0][1:])
    w_list = [torch.stack([x[0][q] for x in outs]) for q in range(6)]
    return (w_list,) + tuple(torch.stack([x[f] for x in outs])
                             for f in range(1, len(outs[0])))


def fused_shared(big):
    """eijk (o,o,o) and, when masked, the active-occupied product."""
    eo = big["eo"]
    eijk = eo[:, None, None] + eo[None, :, None] + eo[None, None, :]
    act_occ = big.get("act_occ")
    actocc3 = None
    if act_occ is not None:
        actocc3 = (act_occ[:, None, None] * act_occ[None, :, None]
                   * act_occ[None, None, :])
    return eijk, actocc3


def auto_engine(device_type, nocc, dtype, w1mode, resident_top=None):
    """The engine that engine='auto' runs: 'xla' for CPU tensors; on
    CUDA 'fused' at full precision (w1mode 'f32') and, at the bf16 tiers,
    'resident' while its kernel holds a cell of nocc in shared memory and
    'fused' beyond.  resident_top: the largest such nocc in dtype and
    w1mode, by default the kernel's own (tr.max_nocc, which builds it);
    decided before any launch."""
    if device_type != "cuda":
        return "xla"
    if w1mode == "f32":
        return "fused"
    if resident_top is None:
        resident_top = tr.max_nocc(dtype, w1mode)
    return "resident" if nocc <= resident_top else "fused"


def kernel(t1, t2, eris, tile=8, dtype=None, tiles_per_call=2048,
           act_hole=None, act_particle=None, mode="exclude_active",
           mesh=None, engine="auto", dot_precision=None, chunk=1,
           vfac=1.0):
    """E(T) from converged (t1, t2) and an RERIs container (DF or full).

    Requires Lov/Lvv when ovvv is absent; ovoo/ovov/fock always.
    act_hole/act_particle restrict the energy sum: 'exclude_active' drops
    contributions whose six indices are all active, 'only_active' keeps
    only those.  chunk: tiles per kernel launch in the fused and resident
    engines (the kernels' grids take the tile index as a dimension).
    dot_precision: the W1 mode of every engine (RESIDENT_MODES: None or
    'highest' full dots, 'high' bf16x3, 'default' one bf16 pass; the ov
    GEMMs, w2, V and the energy stay in dtype).  On CUDA the bf16 tiers
    take float32 (bf16 products with fp32 accumulation) in the fused and
    resident engines, and 'auto' runs them on 'resident' where its kernel
    holds the cell and on 'fused' beyond (auto_engine).
    tiles_per_call bounded the length of one compiled TPU program; the
    eager loop here has no such program and ignores it.  tile=0 lets
    lib/memory size the tile edge (CUDA, or with config.MAX_MEMORY set).
    Per-tile energies stay in a device buffer and are summed once, in
    fp64, at the end (no host sync per tile).

    mesh (parallel/mesh): t1, t2 and eris replicated on every rank; each
    rank runs its contiguous block of the tile list (mesh_block) through
    the same engine loop, and the fp64 block sums are summed over the
    ranks (mesh_total), the counterpart of the reference's MPI job
    slicing (lib/cc/ccsd_t.c:856 MPICCsd_t_contract)."""
    if getattr(eris, "mesh", None) is not None:
        raise ValueError("the (T) takes replicated integrals: pass the "
                         "container as it was before shard_eris")
    rmode = tc.w1_mode(dot_precision)
    nocc, nvir = t1.shape
    if dtype is None:
        dtype = t2.dtype
    if (t2.device.type == "cuda" and rmode != "f32" and engine != "xla"
            and dtype != torch.float32):
        raise ValueError(
            f"dot_precision={dot_precision!r}: the kernels take float32 "
            f"for the bf16 tiers (bf16 products, fp32 accumulation), not "
            f"{dtype}; use dot_precision=None or 'highest'")
    if engine == "auto":
        engine = auto_engine(t2.device.type, nocc, dtype, rmode)
    if engine == "flat":
        raise NotImplementedError(
            "engine='flat' is a TPU lane-padding layout and is not ported")
    if engine not in ("fused", "resident", "xla"):
        raise ValueError(f"unknown (T) engine {engine!r}; use 'fused', "
                         "'resident', 'xla' or 'auto'")
    if not tile:
        from pyscf_mpcc_tpu_torch.lib import memory as _mem
        naux = eris.Lov.shape[0] if eris.Lov is not None else 0
        tile = _mem.plan_triples_tile(nocc, nvir, naux, dtype,
                                      device=t2.device, engine=engine,
                                      dot_precision=dot_precision)
    with span("triples.energy"):
        big = _prepare(t1, t2, eris, tile, dtype, act_hole, act_particle,
                       vfac, engine, rmode)
        trips = mesh_block(_tile_triples(big["nvp"] // tile), mesh)
        ntrips = trips.shape[0]
        count("triples.tiles", ntrips)
        e_tiles = torch.empty(ntrips, dtype=torch.float64, device=t2.device)
        if engine == "xla":
            tile_energy = make_tile_energy(big, mode, rmode)
            for n in range(ntrips):
                e_tiles[n] = tile_energy(trips[n])
            return 2.0 * float(mesh_total(e_tiles, mesh))

        # per chunk: the host's prep (triples.prep), then the kernel
        # (triples.launch, on the device)
        eijk, actocc3 = fused_shared(big)
        has_act = "act_occ" in big
        K = max(1, int(chunk))
        if engine == "resident":
            prep = make_prep_resident(big)
            for n0 in range(0, ntrips, K):
                with span("triples.prep"):
                    out = stack_prep_resident(
                        [prep(abc) for abc in trips[n0:n0 + K]])
                kw = {}
                if has_act:
                    kw = dict(act3=out[9], actocc=actocc3, act_mode=mode)
                with span("triples.launch", device=True):
                    e_tiles[n0:n0 + len(out[0])] = \
                        tr.tile_energy_resident_chunk(
                            *out[:7], eijk, *out[7:9], mode=rmode, **kw)
            return 2.0 * float(mesh_total(e_tiles, mesh))

        prep = make_prep_fused(big)
        for n0 in range(0, ntrips, K):
            with span("triples.prep"):
                out = stack_prep([prep(abc) for abc in trips[n0:n0 + K]])
            kw = {}
            if has_act:
                kw = dict(actv=out[10], actocc=actocc3, act_mode=mode)
            with span("triples.launch", device=True):
                e_tiles[n0:n0 + out[2].shape[0]] = tc.tile_energy_fused_chunk(
                    *out[:8], eijk, *out[8:10], **kw)
        return 2.0 * float(mesh_total(e_tiles, mesh))
