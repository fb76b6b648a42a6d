"""Open-shell UCCSD(T): tiled spin-orbital triples.

Port of ``pyscf_mpcc_tpu/cc/uccsd_t.py``.  The kernel works in the
antisymmetrized spin-orbital formulation over the combined
[occ_a, occ_b] x [vir_a, vir_b] index space:

    W_ijk^abc = P(i/jk) P(a/bc) [ sum_e t2_jk^ae <ei||bc>
                                  - sum_m t2_im^bc <ma||jk> ]
    E(T) = (1/6) sum_{a>b>c} sum_{ijk} W (W + V) / D_ijk^abc

as a loop over (ta >= tb >= tc) tiles of the virtual-triple space (the
tile list of cc/ccsd_t).  Spin-forbidden blocks vanish because the
spin-orbital tensors are block-diagonal in spin.  Per tile: three
primitive evaluations (one per P(a/bc) term) with the <ei||bc> blocks
rebuilt on the fly from the per-spin DF factors (no O(o v^3) spin-orbital
ovvv storage); the disconnected V term in the canonical-orbital form
(t1 * <jk||bc>).  Every W-sized term is written in place into one
preallocated product buffer and accumulated into W and V, so a tile
allocates no W-sized temporary per P(a/bc) term.

The spin-orbital assembly (``_so_*``, host NumPy in the JAX package) runs
on the device.  Per-tile energies stay in an fp64 device buffer and are
summed once at the end.  No Pallas kernel lies on this path in the JAX
package (a ``lax.scan`` of einsums); the dense products are cuBLAS GEMMs
here.

Active-space masks (act_hole/act_particle as (alpha, beta) pairs)
restrict the energy sum, 'exclude_active' or 'only_active', as the
closed-shell kernel's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pyscf_mpcc_tpu_torch.cc.ccsd_t import (_tile_triples, mesh_block,
                                            mesh_total)


def _so_dims(eris):
    na, nb = eris.nocca, eris.noccb
    va, vb = eris.ovov.shape[1], eris.OVOV.shape[1]
    return na, nb, va, vb, na + nb, va + vb


def _so_chem_ooov(eris, dtype):
    """Spin-orbital chemists' (oo|ov): soc[j,m,k,x] = (j m|k x)."""
    na, nb, va, vb, O, V = _so_dims(eris)
    out = eris.ovoo.new_zeros((O, O, O, V), dtype=dtype)
    # (oo|ov) is the (2,3,0,1)-permutation of the stored (ov|oo) blocks
    out[:na, :na, :na, :va] = eris.ovoo.permute(2, 3, 0, 1)
    out[:na, :na, na:, va:] = eris.OVoo.permute(2, 3, 0, 1)
    out[na:, na:, :na, :va] = eris.ovOO.permute(2, 3, 0, 1)
    out[na:, na:, na:, va:] = eris.OVOO.permute(2, 3, 0, 1)
    return out


def _so_chem_ovov(eris, dtype):
    """Spin-orbital chemists' (ov|ov): soc[i,y,k,z] = (i y|k z)."""
    na, nb, va, vb, O, V = _so_dims(eris)
    out = eris.ovov.new_zeros((O, V, O, V), dtype=dtype)
    out[:na, :va, :na, :va] = eris.ovov
    out[:na, :va, na:, va:] = eris.ovOV
    out[na:, va:, :na, :va] = eris.ovOV.permute(2, 3, 0, 1)
    out[na:, va:, na:, va:] = eris.OVOV
    return out


def _so_chem_ovvv(eris, dtype):
    """Spin-orbital chemists' (ov|vv): soc[i,z,e,y] = (i z|e y)
    (materialized path; the DF path rebuilds tile blocks instead)."""
    na, nb, va, vb, O, V = _so_dims(eris)
    out = eris.ovvv.new_zeros((O, V, V, V), dtype=dtype)
    out[:na, :va, :va, :va] = eris.ovvv
    out[:na, :va, va:, va:] = eris.ovVV
    out[na:, va:, :va, :va] = eris.OVvv
    out[na:, va:, va:, va:] = eris.OVVV
    return out


def _so_df(eris, dtype):
    """Block-diagonal spin-orbital DF factors (naux, O, V)/(naux, V, V)."""
    na, nb, va, vb, O, V = _so_dims(eris)
    naux = eris.Lov_a.shape[0]
    Lov = eris.Lov_a.new_zeros((naux, O, V), dtype=dtype)
    Lov[:, :na, :va] = eris.Lov_a
    Lov[:, na:, va:] = eris.Lov_b
    Lvv = eris.Lvv_a.new_zeros((naux, V, V), dtype=dtype)
    Lvv[:, :va, :va] = eris.Lvv_a
    Lvv[:, va:, va:] = eris.Lvv_b
    return Lov, Lvv


def _prepare(t1, t2, eris, tile, dtype, act_hole, act_particle):
    """The padded spin-orbital tensors every tile reads (the JAX
    package's ``big``), on the amplitudes' device."""
    from pyscf_mpcc_tpu_torch.cc import uccsd
    na, nb, va, vb, O, V = _so_dims(eris)
    dev = t2[1].device
    T1, T2 = uccsd.to_spin_orbital(t1, t2, (na, nb))
    ea, eb = (x.to(dtype) for x in eris.mo_energy)
    nvp = ((V + tile - 1) // tile) * tile
    pad = nvp - V

    def padv(x, axes):
        if not pad:
            return x
        cfg = []
        for ax in reversed(range(x.dim())):
            cfg += [0, pad if ax in axes else 0]
        return F.pad(x, cfg)

    big = dict(T=tile, O=O, nvp=nvp,
               eo=torch.cat([ea[:na], eb[:nb]]),
               ev_p=torch.cat([ea[na:], eb[nb:],
                               torch.full((pad,), 1e6, dtype=dtype,
                                          device=dev)]))
    big["t1p"] = padv(T1.to(dtype), [1])
    # t2T[a, e, (j,k)] = t2so[j,k,a,e]
    big["t2T"] = padv(T2.to(dtype).permute(2, 3, 0, 1),
                      [0, 1]).reshape(nvp, nvp, O * O)
    del T1, T2
    # <jk||mx> = (jm|kx) - (jx|km), x-major for tile slicing:
    # nooo[x, m, (j,k)]
    soc = _so_chem_ooov(eris, dtype)
    aooov = soc.permute(0, 2, 1, 3) - soc.permute(2, 0, 1, 3)
    big["nooo"] = padv(aooov.permute(3, 2, 0, 1), [0]).reshape(nvp, O, O * O)
    del soc, aooov
    # <jk||yz> = (jy|kz) - (jz|ky), minor (y,z) axes for tile slicing
    socv = _so_chem_ovov(eris, dtype)
    big["aoovv_r"] = padv(socv.permute(0, 2, 1, 3)
                          - socv.permute(0, 2, 3, 1), [2, 3])
    del socv
    if eris.Lov_a is not None:
        Lov, Lvv = _so_df(eris, dtype)
        big["Lov"] = padv(Lov, [2])
        big["Lvv"] = padv(Lvv, [1, 2])
    else:
        big["ovvv"] = padv(_so_chem_ovvv(eris, dtype), [1, 2, 3])
    if act_hole is not None:
        (aha, ahb), (apa, apb) = act_hole, act_particle
        ao_m = np.zeros(O, dtype=bool)
        ao_m[np.asarray(aha, dtype=int)] = True
        ao_m[na + np.asarray(ahb, dtype=int)] = True
        av_m = np.zeros(nvp, dtype=bool)
        av_m[np.asarray(apa, dtype=int)] = True
        av_m[va + np.asarray(apb, dtype=int)] = True
        big["act_occ"] = torch.tensor(ao_m, device=dev).to(dtype)
        big["act_vir"] = torch.tensor(av_m, device=dev).to(dtype)
    return big


# P(a/bc): role maps over the (A, B, C) tile axes with signs
PPERMS = (((0, 1, 2), 1.0), ((1, 0, 2), -1.0), ((2, 1, 0), -1.0))


def make_tile_energy(big, mode="exclude_active"):
    """abc -> 0-dim fp64 tile energy (sum over the tile's a > b > c)."""
    T, O, nvp = big["T"], big["O"], big["nvp"]
    t2T, nooo, aoovv_r = big["t2T"], big["nooo"], big["aoovv_r"]
    t1p, ev_p, eo = big["t1p"], big["ev_p"], big["eo"]
    ovvv, Lov, Lvv = big.get("ovvv"), big.get("Lov"), big.get("Lvv")
    act_occ, act_vir = big.get("act_occ"), big.get("act_vir")
    dtype, dev = t2T.dtype, t2T.device
    oo = O * O
    # the per-tile buffers: W, V and one product buffer
    W = torch.empty((T, T, T, O, O, O), dtype=dtype, device=dev)
    V6 = torch.empty_like(W)
    buf = torch.empty((O * T * T, T * oo), dtype=dtype, device=dev)
    eijk = eo[:, None, None] + eo[None, :, None] + eo[None, None, :]

    def g1_block(z0, y0):
        """G1[i, z, y, e] = <ie||zy> = (iz|ey) - (iy|ez)."""
        if ovvv is not None:
            d = ovvv[:, z0:z0 + T, :, y0:y0 + T]          # [i, z, e, y]
            x = ovvv[:, y0:y0 + T, :, z0:z0 + T]          # [i, y, e, z]
            return d.permute(0, 1, 3, 2) - x.permute(0, 3, 1, 2)
        lz, ly = Lov[:, :, z0:z0 + T], Lov[:, :, y0:y0 + T]
        vy, vz = Lvv[:, :, y0:y0 + T], Lvv[:, :, z0:z0 + T]
        return (torch.einsum("Liz,Ley->izye", lz, vy)
                - torch.einsum("Liy,Lez->izye", ly, vz))

    def tile_energy(abc):
        starts = tuple(int(r) * T for r in abc)
        W.zero_()
        V6.zero_()
        for p, sgn in PPERMS:
            xi, yi, zi = p
            x0, y0, z0 = starts[xi], starts[yi], starts[zi]
            # role axes of the product [x,y,z,...] back to (a,b,c)
            inv = [p.index(0), p.index(1), p.index(2)]
            # u1[i,z,y,x,(j,k)] = sum_e G1[i,z,y,e] t2T[x,e,(j,k)]
            g1 = g1_block(z0, y0).reshape(O * T * T, nvp)
            t2x = t2T[x0:x0 + T].permute(1, 0, 2).reshape(nvp, T * oo)
            torch.matmul(g1, t2x, out=buf)
            del g1, t2x
            u = buf.view(O, T, T, T, O, O).permute(3, 2, 1, 0, 4, 5)
            W.add_(u.permute(*inv, 3, 4, 5), alpha=sgn)
            # u2[x,y,z,i,(j,k)] = sum_m t2so[i,m,y,z] <jk||mx>,
            # t2so[i,m,y,z] = t2T[y,z,(i,m)]
            t2yz = t2T[y0:y0 + T, z0:z0 + T].reshape(T * T * O, O)
            g2x = nooo[x0:x0 + T].permute(1, 0, 2).reshape(O, T * oo)
            torch.matmul(t2yz, g2x, out=buf)
            u = buf.view(T, T, O, T, O, O).permute(3, 0, 1, 2, 4, 5)
            W.add_(u.permute(*inv, 3, 4, 5), alpha=-sgn)
            # v[x,y,z,i,j,k] = t1[i,x] <jk||yz>
            t1x = t1p[:, x0:x0 + T]
            gyz = aoovv_r[:, :, y0:y0 + T, z0:z0 + T]
            v = buf.view(T, O, T, T, O, O)       # [x, i, y, z, j, k]
            torch.mul(t1x.T[:, :, None, None, None, None],
                      gyz.permute(2, 3, 0, 1)[None, None], out=v)
            V6.add_(v.permute(0, 2, 3, 1, 4, 5).permute(*inv, 3, 4, 5),
                    alpha=sgn)

        # P(i/jk) on the whole occupied axes: pure permutations
        def hole_asym(x):
            return (x - x.permute(0, 1, 2, 4, 3, 5)
                    - x.permute(0, 1, 2, 5, 4, 3))

        Wa = hole_asym(W)
        V6.add_(W)
        Za = hole_asym(V6)
        ev3 = [ev_p[s:s + T] for s in starts]
        eabc = ev3[0][:, None, None] + ev3[1][None, :, None] \
            + ev3[2][None, None, :]
        Za.div_(eijk[None, None, None] - eabc[:, :, :, None, None, None])
        if act_occ is not None:
            ax, ay, az = (act_vir[s:s + T] for s in starts)
            act6 = (ax[:, None, None, None, None, None]
                    * ay[None, :, None, None, None, None]
                    * az[None, None, :, None, None, None]
                    * act_occ[None, None, None, :, None, None]
                    * act_occ[None, None, None, None, :, None]
                    * act_occ[None, None, None, None, None, :])
            Za.mul_((1.0 - act6) if mode == "exclude_active" else act6)
        # strict a > b > c on global indices (W vanishes on repeats;
        # masking keeps padded and rounding terms out exactly)
        g = [torch.arange(s, s + T, device=dev) for s in starts]
        wgt = ((g[0][:, None, None] > g[1][None, :, None])
               & (g[1][None, :, None] > g[2][None, None, :])).to(dtype)
        e_tile = torch.einsum("xyzq,xyzq->xyz", Wa.view(T, T, T, -1),
                              Za.view(T, T, T, -1))
        return (e_tile * wgt).to(torch.float64).sum()

    return tile_energy


def kernel(t1, t2, eris, tile=8, dtype=None, tiles_per_call=2048,
           act_hole=None, act_particle=None, mode="exclude_active",
           mesh=None):
    """E(T) from converged unrestricted (t1, t2) and a UERIs container.

    t1 = (t1a, t1b), t2 = (t2aa, t2ab, t2bb).  Uses the per-spin DF
    factors when present (production), else the materialized three-virtual
    blocks.  act_hole/act_particle are (alpha, beta) index-array pairs.
    tiles_per_call bounded the length of one compiled TPU program; the
    eager loop here has no such program and ignores it.

    mesh (parallel/mesh): the amplitudes and integrals replicated on every
    rank; each rank scans its contiguous block of the tile list and the
    fp64 block sums are summed over the ranks (ccsd_t.mesh_block,
    mesh_total).  The JAX package pads the list with copies of tile 0 and
    subtracts their energy again; here no pad tile is computed."""
    if eris.mesh is not None:
        raise ValueError("the (T) takes replicated integrals: pass the "
                         "container as it was before shard_ueris")
    if dtype is None:
        dtype = t2[1].dtype
    big = _prepare(t1, t2, eris, tile, dtype, act_hole, act_particle)
    trips = mesh_block(_tile_triples(big["nvp"] // tile), mesh)
    e_tiles = torch.empty(len(trips), dtype=torch.float64,
                          device=t2[1].device)
    tile_energy = make_tile_energy(big, mode)
    for n in range(len(trips)):
        e_tiles[n] = tile_energy(trips[n])
    return float(mesh_total(e_tiles, mesh)) / 6.0
