"""McMurchie-Davidson Gaussian integral engine (clean-room, NumPy).

Replaces the role of libcint + the reference's C drivers
(pyscf/gto/moleintor.py, pyscf/lib/ao2mo/nr_ao2mo.c) for this standalone
framework.  Provides overlap / kinetic / nuclear-attraction one-electron
integrals and 4-center / 3-center / 2-center electron-repulsion integrals,
vectorized over primitive pairs within each shell pair and over full shell
rows where possible.  Output is float64 NumPy in the AO conventions of
``gto.mole`` (real-spherical by default).

Algorithm: Hermite Gaussian expansion (E coefficients) + Hermite Coulomb
recursion (R tensor) on Boys-function values; see Helgaker, Jorgensen,
Olsen, "Molecular Electronic-Structure Theory", ch. 9.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammainc, gamma as _gamma_fn

from pyscf_mpcc_tpu_torch.gto.mole import cart2sph, cart_components, ncart


# ---------------------------------------------------------------------------
# Boys function
# ---------------------------------------------------------------------------

def boys(nmax, t):
    """F_n(t) for n = 0..nmax.  ``t``: any-shape array.  Returns (nmax+1, *t.shape)."""
    t = np.asarray(t, dtype=float)
    out = np.empty((nmax + 1,) + t.shape)
    tiny = t < 1e-13
    ts = np.where(tiny, 1.0, t)
    # F_nmax via regularized lower incomplete gamma, then downward recursion
    a = nmax + 0.5
    fn = _gamma_fn(a) * gammainc(a, ts) / (2.0 * ts ** a)
    out[nmax] = np.where(tiny, 1.0 / (2 * nmax + 1), fn)
    if nmax > 0:
        et = np.exp(-ts)
        for n in range(nmax - 1, -1, -1):
            fn = (2.0 * ts * out[n + 1] + et) / (2 * n + 1)
            out[n] = np.where(tiny, 1.0 / (2 * n + 1), fn)
    return out


# ---------------------------------------------------------------------------
# Hermite expansion coefficients
# ---------------------------------------------------------------------------

def e_coeffs(la, lb, a, b, ab_dist):
    """Hermite expansion E_t^{ij} for one dimension.

    a, b: (np_,) primitive exponent arrays (already broadcast to pairs).
    ab_dist: scalar A_d - B_d for this dimension.
    Returns E with shape (la+1, lb+1, la+lb+1, np_).
    """
    p = a + b
    mu = a * b / p
    inv2p = 0.5 / p
    pa = -b / p * ab_dist  # P_d - A_d
    pb = a / p * ab_dist   # P_d - B_d
    nt = la + lb + 1
    E = np.zeros((la + 1, lb + 1, nt, len(p)))
    E[0, 0, 0] = np.exp(-mu * ab_dist * ab_dist)
    for i in range(1, la + 1):
        for t in range(i + 1):
            v = pa * E[i - 1, 0, t]
            if t > 0:
                v = v + inv2p * E[i - 1, 0, t - 1]
            if t + 1 <= i - 1:
                v = v + (t + 1) * E[i - 1, 0, t + 1]
            E[i, 0, t] = v
    for j in range(1, lb + 1):
        for i in range(la + 1):
            for t in range(i + j + 1):
                v = pb * E[i, j - 1, t]
                if t > 0:
                    v = v + inv2p * E[i, j - 1, t - 1]
                if t + 1 <= i + j - 1:
                    v = v + (t + 1) * E[i, j - 1, t + 1]
                E[i, j, t] = v
    return E


def hermite_bra(la, lb, a, b, A, B):
    """Full 3D Hermite expansion for a shell pair.

    Returns (E3, P, p): E3 shape (nca, ncb, nt, nu, nv, np_) where nca/ncb are
    cartesian component counts; P the Gaussian product centers (np_, 3); p = a+b.
    """
    np_ = len(a)
    p = a + b
    P = (a[:, None] * A[None, :] + b[:, None] * B[None, :]) / p[:, None]
    Ex = e_coeffs(la, lb, a, b, A[0] - B[0])
    Ey = e_coeffs(la, lb, a, b, A[1] - B[1])
    Ez = e_coeffs(la, lb, a, b, A[2] - B[2])
    ca = cart_components(la)
    cb = cart_components(lb)
    nt = la + lb + 1
    E3 = np.zeros((len(ca), len(cb), nt, nt, nt, np_))
    for ia, (ix, iy, iz) in enumerate(ca):
        for ib, (jx, jy, jz) in enumerate(cb):
            ex = Ex[ix, jx, : ix + jx + 1]            # (tx, np_)
            ey = Ey[iy, jy, : iy + jy + 1]
            ez = Ez[iz, jz, : iz + jz + 1]
            E3[ia, ib, : ix + jx + 1, : iy + jy + 1, : iz + jz + 1] = (
                ex[:, None, None, :] * ey[None, :, None, :] * ez[None, None, :, :])
    return E3, P, p


# ---------------------------------------------------------------------------
# Hermite Coulomb tensor
# ---------------------------------------------------------------------------

def r_tensor(tmax, umax, vmax, alpha, PQ):
    """Hermite Coulomb integrals R_{tuv}(alpha, PQ).

    alpha: (n,) array; PQ: (n, 3).  Returns (tmax+1, umax+1, vmax+1, n).
    """
    nmax = tmax + umax + vmax
    T = alpha * np.einsum("ni,ni->n", PQ, PQ)
    F = boys(nmax, T)
    # R^n_{000} = (-2 alpha)^n F_n
    n = len(alpha)
    Rn = F * (-2.0 * alpha[None, :]) ** np.arange(nmax + 1)[:, None]
    # build up with recursion over t, u, v; keep the n-index explicit
    R = np.zeros((nmax + 1, tmax + 1, umax + 1, vmax + 1, n))
    R[:, 0, 0, 0] = Rn
    X, Y, Z = PQ[:, 0], PQ[:, 1], PQ[:, 2]
    for t in range(1, tmax + 1):
        for m in range(nmax - t + 1):
            v = X * R[m + 1, t - 1, 0, 0]
            if t > 1:
                v = v + (t - 1) * R[m + 1, t - 2, 0, 0]
            R[m, t, 0, 0] = v
    for u in range(1, umax + 1):
        for t in range(tmax + 1):
            for m in range(nmax - t - u + 1):
                v = Y * R[m + 1, t, u - 1, 0]
                if u > 1:
                    v = v + (u - 1) * R[m + 1, t, u - 2, 0]
                R[m, t, u, 0] = v
    for w in range(1, vmax + 1):
        for u in range(umax + 1):
            for t in range(tmax + 1):
                for m in range(nmax - t - u - w + 1):
                    v = Z * R[m + 1, t, u, w - 1]
                    if w > 1:
                        v = v + (w - 1) * R[m + 1, t, u, w - 2]
                    R[m, t, u, w] = v
    return R[0]


# ---------------------------------------------------------------------------
# contraction / transformation helpers
# ---------------------------------------------------------------------------

def _pair_exps(sha, shb):
    a = np.repeat(sha.exps, shb.nprim)
    b = np.tile(shb.exps, sha.nprim)
    return a, b


def _pair_coefs(sha, shb):
    """(np_, nctr_a*nctr_b) contraction coefficient products."""
    ca = sha.coefs  # (npa, nca)
    cb = shb.coefs
    prod = np.einsum("pi,qj->pqij", ca, cb)
    return prod.reshape(sha.nprim * shb.nprim, -1)


def _to_sph(block, la, lb, cart):
    """block: (nca_cart, ncb_cart, ...) -> spherical components on both sides."""
    if cart:
        return block
    Ca = cart2sph(la)
    Cb = cart2sph(lb)
    out = np.tensordot(Ca, block, axes=(1, 0))
    out = np.moveaxis(np.tensordot(Cb, out, axes=(1, 1)), 0, 1)
    return out


def _shell_slices(mol):
    return [(int(mol.ao_loc[i]), int(mol.ao_loc[i + 1])) for i in range(len(mol.shells))]


# ---------------------------------------------------------------------------
# one-electron integrals
# ---------------------------------------------------------------------------

def _ovlp_kin_pair(sha, shb, want_kin):
    la, lb = sha.l, shb.l
    a, b = _pair_exps(sha, shb)
    p = a + b
    AB = sha.center - shb.center
    lb_eff = lb + 2 if want_kin else lb
    Ex = e_coeffs(la, lb_eff, a, b, AB[0])
    Ey = e_coeffs(la, lb_eff, a, b, AB[1])
    Ez = e_coeffs(la, lb_eff, a, b, AB[2])
    pref = (np.pi / p) ** 1.5
    ca = cart_components(la)
    cb = cart_components(lb)
    coefs = _pair_coefs(sha, shb)  # (np_, nctr_prod)

    def s1d(E, i, j):
        if j < 0:
            return np.zeros_like(p)
        return E[i, j, 0]

    S = np.zeros((len(ca), len(cb), len(p)))
    T = np.zeros_like(S) if want_kin else None
    for ia, (ix, iy, iz) in enumerate(ca):
        for ib, (jx, jy, jz) in enumerate(cb):
            sx, sy, sz = Ex[ix, jx, 0], Ey[iy, jy, 0], Ez[iz, jz, 0]
            S[ia, ib] = sx * sy * sz
            if want_kin:
                def k1d(E, i, j):
                    t = -2.0 * b * b * s1d(E, i, j + 2) + b * (2 * j + 1) * s1d(E, i, j)
                    if j >= 2:
                        t = t - 0.5 * j * (j - 1) * s1d(E, i, j - 2)
                    return t
                kx = k1d(Ex, ix, jx)
                ky = k1d(Ey, iy, jy)
                kz = k1d(Ez, iz, jz)
                T[ia, ib] = kx * sy * sz + sx * ky * sz + sx * sy * kz
    Sc = np.einsum("abp,p,pc->abc", S, pref, coefs)
    out = [Sc]
    if want_kin:
        out.append(np.einsum("abp,p,pc->abc", T, pref, coefs))
    return out


def _nuc_pair(sha, shb, coords, charges):
    la, lb = sha.l, shb.l
    a, b = _pair_exps(sha, shb)
    E3, P, p = hermite_bra(la, lb, a, b, sha.center, shb.center)
    nt = la + lb
    coefs = _pair_coefs(sha, shb)
    nca, ncb = ncart(la), ncart(lb)
    out = np.zeros((nca, ncb, len(p)))
    for C, Z in zip(coords, charges):
        if Z == 0:
            continue
        R = r_tensor(nt, nt, nt, p, P - C[None, :])
        out -= Z * np.einsum("abtuvp,tuvp->abp", E3, R)
    out *= (2.0 * np.pi / p)[None, None, :]
    return np.einsum("abp,pc->abc", out, coefs)


def _assemble_1e(mol, pair_fn, n_out=1):
    nao = mol.nao
    mats = [np.zeros((nao, nao)) for _ in range(n_out)]
    slices = _shell_slices(mol)
    shells = mol.shells
    for i, sha in enumerate(shells):
        for j, shb in enumerate(shells):
            if j > i:
                continue
            blocks = pair_fn(sha, shb)
            i0, i1 = slices[i]
            j0, j1 = slices[j]
            for m, blk in zip(mats, blocks):
                # blk: (nca_cart, ncb_cart, nctr_a*nctr_b)
                sb = _to_sph_ctr(blk, sha, shb, mol.cart)
                m[i0:i1, j0:j1] = sb
                if i != j:
                    m[j0:j1, i0:i1] = sb.T
    return mats if n_out > 1 else mats[0]


def _to_sph_ctr(blk, sha, shb, cart):
    """(nca_cart, ncb_cart, nctr_a*nctr_b) -> (nao_a, nao_b) AO block."""
    nca, ncb = blk.shape[0], blk.shape[1]
    blk = blk.reshape(nca, ncb, sha.nctr, shb.nctr)
    blk = _to_sph(blk, sha.l, shb.l, cart)
    na, nb = blk.shape[0], blk.shape[1]
    # AO index order: contraction-major (each contraction contributes a full
    # set of 2l+1 components consecutively)
    blk = blk.transpose(2, 0, 3, 1).reshape(sha.nctr * na, shb.nctr * nb)
    return blk


def intor_ovlp(mol):
    from pyscf_mpcc_tpu_torch.gto import native
    if native.available():
        return native.ovlp_kin(mol)[0]
    return _assemble_1e(mol, lambda a, b: _ovlp_kin_pair(a, b, False), 1)


def intor_kin(mol):
    return _assemble_1e(mol, lambda a, b: _ovlp_kin_pair(a, b, True), 2)[1]


def intor_ovlp_kin(mol):
    from pyscf_mpcc_tpu_torch.gto import native
    if native.available():
        return list(native.ovlp_kin(mol))
    return _assemble_1e(mol, lambda a, b: _ovlp_kin_pair(a, b, True), 2)


def intor_nuc(mol):
    from pyscf_mpcc_tpu_torch.gto import native
    if native.available():
        return native.nuc(mol)
    coords = mol.atom_coords()
    charges = mol.atom_charges()
    return _assemble_1e(mol, lambda a, b: [_nuc_pair(a, b, coords, charges)], 1)


# ---------------------------------------------------------------------------
# two-electron integrals
# ---------------------------------------------------------------------------

class _PairData:
    """Precomputed Hermite data for one shell pair (contracted to AO level).

    The Hermite representation of the contracted AO-pair charge distribution:
    Lambda[ao_a, ao_b, t, u, v, prim] with prim-level Gaussian centers P and
    total exponents p kept per primitive for the Coulomb kernel.
    """

    __slots__ = ("E", "P", "p", "la", "lb", "nt", "i0", "i1", "j0", "j1")

    def __init__(self, sha, shb, cart, slc_a, slc_b):
        la, lb = sha.l, shb.l
        a, b = _pair_exps(sha, shb)
        E3, P, p = hermite_bra(la, lb, a, b, sha.center, shb.center)
        coefs = _pair_coefs(sha, shb).reshape(len(p), sha.nctr, shb.nctr)
        # apply contraction coefficients; keep the primitive axis (the Coulomb
        # kernel needs per-primitive P and p)
        E = np.einsum("abtuvp,pij->iajbtuvp", E3, coefs)
        if not cart:
            Ca, Cb = cart2sph(la), cart2sph(lb)
            E = np.einsum("ma,iajbtuvp->imjbtuvp", Ca, E)
            E = np.einsum("nb,imjbtuvp->imjntuvp", Cb, E)
        na, nb = E.shape[1], E.shape[3]
        self.E = E.reshape(sha.nctr * na, shb.nctr * nb, *E3.shape[2:5], len(p))
        self.P = P
        self.p = p
        self.la, self.lb = la, lb
        self.nt = la + lb
        self.i0, self.i1 = slc_a
        self.j0, self.j1 = slc_b


def _make_pairs(mol, pairs=None):
    slices = _shell_slices(mol)
    shells = mol.shells
    out = []
    n = len(shells)
    for i in range(n):
        for j in range(i + 1):
            out.append(_PairData(shells[i], shells[j], mol.cart,
                                 slices[i], slices[j]))
    return out


def _coulomb_block(pa, pb):
    """(ab|cd) block between two contracted pair distributions."""
    na, nb = pa.E.shape[0], pa.E.shape[1]
    nc, nd = pb.E.shape[0], pb.E.shape[1]
    npa, npb = len(pa.p), len(pb.p)
    # all primitive quartets
    pp = pa.p[:, None]
    qq = pb.p[None, :]
    alpha = (pp * qq / (pp + qq)).ravel()
    PQ = (pa.P[:, None, :] - pb.P[None, :, :]).reshape(-1, 3)
    pref = (2.0 * np.pi ** 2.5 / (pp * qq * np.sqrt(pp + qq))).ravel()
    R = r_tensor(pa.nt + pb.nt, pa.nt + pb.nt, pa.nt + pb.nt, alpha, PQ)
    R = (R * pref).reshape(R.shape[:3] + (npa, npb))
    # contract: bra Hermite x R x ket Hermite with (-1)^{t'+u'+v'} sign on ket
    nt_b = pb.nt + 1
    sign = (-1.0) ** (np.arange(nt_b)[:, None, None]
                      + np.arange(nt_b)[None, :, None]
                      + np.arange(nt_b)[None, None, :])
    Eket = pb.E * sign[None, None, :, :, :, None]
    # mid[t,u,v, c,d, pA] = sum_{t'u'v', pB} R[t+t', u+u', v+v', pA,pB] Eket[c,d,t'u'v',pB]
    nt_a = pa.nt + 1
    mid = np.empty((nt_a, nt_a, nt_a, nc, nd, npa))
    for t in range(nt_a):
        for u in range(nt_a):
            for v in range(nt_a):
                Rblk = R[t:t + nt_b, u:u + nt_b, v:v + nt_b]  # (ntb,ntb,ntb,npa,npb)
                mid[t, u, v] = np.einsum("xyzab,cdxyzb->cda", Rblk, Eket,
                                         optimize=True)
    out = np.einsum("abtuvp,tuvcdp->abcd", pa.E, mid, optimize=True)
    return out


def intor_eri(mol):
    """Full (nao,nao,nao,nao) chemists'-notation ERI tensor (small systems).

    Dispatches to the native C++/OpenMP engine when available."""
    from pyscf_mpcc_tpu_torch.gto import native
    if native.available():
        return native.eri4c(mol)
    nao = mol.nao
    pairs = _make_pairs(mol)
    eri = np.zeros((nao, nao, nao, nao))
    npair = len(pairs)
    for ip in range(npair):
        for jp in range(ip + 1):
            pa, pb = pairs[ip], pairs[jp]
            blk = _coulomb_block(pa, pb)
            _scatter_eri(eri, blk, pa, pb)
            if ip != jp:
                _scatter_eri(eri, blk.transpose(2, 3, 0, 1), pb, pa)
    return eri


def _scatter_eri(eri, blk, pa, pb):
    i0, i1, j0, j1 = pa.i0, pa.i1, pa.j0, pa.j1
    k0, k1, l0, l1 = pb.i0, pb.i1, pb.j0, pb.j1
    eri[i0:i1, j0:j1, k0:k1, l0:l1] = blk
    eri[j0:j1, i0:i1, k0:k1, l0:l1] = blk.transpose(1, 0, 2, 3)
    eri[i0:i1, j0:j1, l0:l1, k0:k1] = blk.transpose(0, 1, 3, 2)
    eri[j0:j1, i0:i1, l0:l1, k0:k1] = blk.transpose(1, 0, 3, 2)


def intor_3c2e(mol, auxmol):
    """(mu nu | P): 3-center 2-electron integrals, shape (nao, nao, naux)."""
    from pyscf_mpcc_tpu_torch.gto import native
    if native.available():
        return native.eri3c(mol, auxmol)
    nao, naux = mol.nao, auxmol.nao
    pairs = _make_pairs(mol)
    aux_pairs = []
    slices = _shell_slices(auxmol)
    for k, sh in enumerate(auxmol.shells):
        # treat an aux shell as a pair with a dummy s function (l=0, exp=0)
        aux_pairs.append(_AuxData(sh, auxmol.cart, slices[k]))
    out = np.zeros((nao, nao, naux))
    for pa in pairs:
        for pc in aux_pairs:
            blk = _coulomb_block_aux(pa, pc)  # (na, nb, naux_sh)
            out[pa.i0:pa.i1, pa.j0:pa.j1, pc.k0:pc.k1] = blk
            if pa.i0 != pa.j0:
                out[pa.j0:pa.j1, pa.i0:pa.i1, pc.k0:pc.k1] = blk.transpose(1, 0, 2)
    return out


class _AuxData:
    """Hermite data for a single (contracted) auxiliary shell."""

    __slots__ = ("E", "P", "p", "nt", "k0", "k1")

    def __init__(self, sh, cart, slc):
        l = sh.l
        a = sh.exps
        np_ = len(a)
        # E coefficients of (shell | dummy-s at same center): AB = 0
        Ex = e_coeffs(l, 0, a, np.zeros(np_), 0.0)
        comps = cart_components(l)
        nt = l + 1
        E3 = np.zeros((len(comps), nt, nt, nt, np_))
        for ic, (ix, iy, iz) in enumerate(comps):
            E3[ic, : ix + 1, : iy + 1, : iz + 1] = (
                Ex[ix, 0, : ix + 1][:, None, None, :]
                * Ex[iy, 0, : iy + 1][None, :, None, :]
                * Ex[iz, 0, : iz + 1][None, None, :, :])
        E = np.einsum("ctuvp,pk->kctuvp", E3, sh.coefs)
        if not cart:
            C = cart2sph(l)
            E = np.einsum("mc,kctuvp->kmtuvp", C, E)
        self.E = E.reshape(-1, nt, nt, nt, np_)
        self.P = np.broadcast_to(sh.center, (np_, 3)).copy()
        self.p = a.astype(float)
        self.nt = l
        self.k0, self.k1 = slc


def _coulomb_block_aux(pa, pc):
    na, nb = pa.E.shape[0], pa.E.shape[1]
    nc = pc.E.shape[0]
    npa, npc = len(pa.p), len(pc.p)
    pp = pa.p[:, None]
    qq = pc.p[None, :]
    alpha = (pp * qq / (pp + qq)).ravel()
    PQ = (pa.P[:, None, :] - pc.P[None, :, :]).reshape(-1, 3)
    pref = (2.0 * np.pi ** 2.5 / (pp * qq * np.sqrt(pp + qq))).ravel()
    R = r_tensor(pa.nt + pc.nt, pa.nt + pc.nt, pa.nt + pc.nt, alpha, PQ)
    R = (R * pref).reshape(R.shape[:3] + (npa, npc))
    nt_c = pc.nt + 1
    sign = (-1.0) ** (np.arange(nt_c)[:, None, None]
                      + np.arange(nt_c)[None, :, None]
                      + np.arange(nt_c)[None, None, :])
    Eket = pc.E * sign[None, :, :, :, None]
    nt_a = pa.nt + 1
    mid = np.empty((nt_a, nt_a, nt_a, nc, npa))
    for t in range(nt_a):
        for u in range(nt_a):
            for v in range(nt_a):
                Rblk = R[t:t + nt_c, u:u + nt_c, v:v + nt_c]
                mid[t, u, v] = np.einsum("xyzab,cxyzb->ca", Rblk, Eket,
                                         optimize=True)
    return np.einsum("abtuvp,tuvcp->abc", pa.E, mid, optimize=True)


def intor_2c2e(auxmol):
    """(P|Q) 2-center 2-electron integrals over the auxiliary basis."""
    from pyscf_mpcc_tpu_torch.gto import native
    if native.available():
        return native.eri2c(auxmol)
    naux = auxmol.nao
    slices = _shell_slices(auxmol)
    aux = [_AuxData(sh, auxmol.cart, slices[k])
           for k, sh in enumerate(auxmol.shells)]
    out = np.zeros((naux, naux))
    for i, pa in enumerate(aux):
        for j in range(i + 1):
            pc = aux[j]
            npa, npc = len(pa.p), len(pc.p)
            pp = pa.p[:, None]
            qq = pc.p[None, :]
            alpha = (pp * qq / (pp + qq)).ravel()
            PQ = (pa.P[:, None, :] - pc.P[None, :, :]).reshape(-1, 3)
            pref = (2.0 * np.pi ** 2.5 / (pp * qq * np.sqrt(pp + qq))).ravel()
            R = r_tensor(pa.nt + pc.nt, pa.nt + pc.nt, pa.nt + pc.nt, alpha, PQ)
            R = (R * pref).reshape(R.shape[:3] + (npa, npc))
            nt_c = pc.nt + 1
            sign = (-1.0) ** (np.arange(nt_c)[:, None, None]
                              + np.arange(nt_c)[None, :, None]
                              + np.arange(nt_c)[None, None, :])
            Eket = pc.E * sign[None, :, :, :, None]
            nt_a = pa.nt + 1
            mid = np.empty((nt_a, nt_a, nt_a, pc.E.shape[0], npa))
            for t in range(nt_a):
                for u in range(nt_a):
                    for v in range(nt_a):
                        Rblk = R[t:t + nt_c, u:u + nt_c, v:v + nt_c]
                        mid[t, u, v] = np.einsum("xyzab,cxyzb->ca", Rblk, Eket,
                                                 optimize=True)
            blk = np.einsum("atuvp,tuvcp->ac", pa.E, mid, optimize=True)
            out[pa.k0:pa.k1, pc.k0:pc.k1] = blk
            if i != j:
                out[pc.k0:pc.k1, pa.k0:pa.k1] = blk.T
    return out
