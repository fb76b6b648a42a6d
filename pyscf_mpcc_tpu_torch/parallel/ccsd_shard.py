"""Tiled RCCSD update: sharded storage and sharded compute.

Port of ``pyscf_mpcc_tpu/parallel/ccsd_shard.py``.  The layout of
parallel.mesh shards the containers but gathers t2 and keeps the o^2 v^2
intermediates whole on every rank.  Here every contraction of
cc/rccsd.update_amps is re-derived so that no rank holds a tensor larger
than O(o^2 v^2 / N), using

  * occupied-ROW shards: t2 / ovov / oovv sharded over their first
    occupied axis (the index symmetries (ij|ab)=(ji|ba) etc. localize
    every occupied contraction to the shard),
  * ring passes (``Mesh.ring_shift``, JAX's ppermute) for the two places
    a full occupied axis must meet a sharded one: building Wvoov/Wvovo/
    Woooo from ovov shards, and contracting them with t2 shards (SUMMA),
  * aux-LOCAL DF factor terms with one all_reduce per o^2 v^2 / N-sized
    output,
  * a column-chunked LADDER: the dressed factor Ld stays aux-sharded at
    rest; column chunks are gathered while they are used (never the whole
    naux * nvir^2 factor) and every rank contracts all virtual tile pairs
    against its own tau rows,
  * all_to_all transpose EXCHANGES for the P(ij|ab) symmetrization
    (K + K^(jiba) needs rows the rank does not own).

JAX writes this as a function under shard_map; here it runs eagerly on
each rank, and each collective is a ``parallel.mesh.Mesh`` call: psum
becomes all_reduce, all_gather(tiled=True) all_gather_into_tensor,
all_to_all all_to_all_single, ppermute a batch of isend/irecv,
dynamic_slice at axis_index * size a narrow.  The eager loops run one
ring step at a time, so the optimization barriers that pin XLA's
schedule have no counterpart.  The reference counterpart is the blocked
out-of-core update of pyscf/cc/ccsd.py:892 with its MPI slicing hooks.

The ladder's W build is NOT divided by N (every rank sweeps all tile
pairs for its own rows): capacity over flops, as in the JAX package.

Constraints (checked): nocc % N == 0; naux is zero-padded to a multiple
of N by shard_eris_tiled (zero aux rows contract to nothing); virtuals
are zero-padded inside the ladder exactly as in rccsd.pair_ladder_sym.
Only variant='ccsd' is implemented.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pyscf_mpcc_tpu_torch.cc.eris import RERIs

einsum = torch.einsum


# --------------------------------------------------------------- placement
def shard_eris_tiled(eris: RERIs, mesh):
    """This rank's part of an RERIs container for the tiled update, on
    ``mesh.device``: ovov/oovv occupied rows, Lvv an aux shard (naux
    zero-padded to a mesh multiple), Lov/Loo zero-padded and replicated,
    the rest replicated.  ovvo, ovvv and vvvv are dropped."""
    pad = (-eris.Lov.shape[0]) % mesh.size

    def put(x):
        return None if x is None else x.to(mesh.device)

    def padaux(x):
        x = put(x)
        if x is None or not pad:
            return x
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])

    return RERIs(
        fock=put(eris.fock), mo_energy=put(eris.mo_energy),
        oooo=put(eris.oooo), ovoo=put(eris.ovoo),
        ovov=mesh.rows(put(eris.ovov)).contiguous(),
        oovv=mesh.rows(put(eris.oovv)).contiguous(),
        ovvo=None, ovvv=None, vvvv=None,
        Lvv=mesh.rows(padaux(eris.Lvv)).contiguous(),
        Lov=padaux(eris.Lov), Loo=padaux(eris.Loo))


def shard_amps_tiled(t1, t2, mesh):
    """t1 replicated; t2's block of occupied rows."""
    return (t1.to(mesh.device),
            mesh.rows(t2.to(mesh.device)).contiguous())


# ------------------------------------------------------------- primitives
def _t_exchange(x, mesh):
    """y[i_loc, j, a, b] = x[j, i_glob(i_loc), b, a] for row-sharded x:
    the cross-rank part of the P(ij|ab) permutation.  Rank d sends its
    j-block e to rank e and receives x[i in e, j in d] (JAX's all_to_all
    with split_axis=1, concat_axis=0: here the j blocks are moved to the
    first axis, which all_to_all_single splits); the transpose is
    local."""
    oL, no = x.shape[0], x.shape[1]
    N = mesh.size
    xs = x.reshape(oL, N, no // N, *x.shape[2:]).transpose(0, 1)
    y = mesh.all_to_all(xs).reshape(no, no // N, *x.shape[2:])
    # y[u, w, a, b] = x[u_glob, j_my(w), a, b], u the full axis
    return y.permute(1, 0, 3, 2)


def _myslice(x, ax, d, size):
    """Block d of the given size along axis ax."""
    return x.narrow(ax, d * size, size)


def _ladder_local(tau_sym, Ldl, mesh, ntile, nchunk):
    """Half-ladder S_loc[i_loc, j, a, b] (A >= B tile blocks, diagonal
    halved) = the sweep of rccsd.pair_ladder_sym applied to the rank's own
    tau rows, with the dressed factor gathered in column chunks (never
    the whole naux * v^2 tensor at once).

    The caller applies S + exchange(S), pair_ladder_sym's final
    symmetrization split across ranks."""
    nvir = Ldl.shape[1]
    nol, no = tau_sym.shape[0], tau_sym.shape[1]
    ntile = max(nchunk, min(int(ntile), nvir))
    ntc = -(-ntile // nchunk)          # tiles per chunk
    ntile = ntc * nchunk
    tsz = -(-nvir // ntile)
    nvp = ntile * tsz
    padv = nvp - nvir
    if padv:
        Ldl = F.pad(Ldl, (0, padv, 0, padv))
        tau_p = F.pad(tau_sym, (0, padv, 0, padv))
    else:
        tau_p = tau_sym
    csz = ntc * tsz                    # columns per chunk

    def gather_chunk(g):
        return mesh.all_gather(_myslice(Ldl, 1, g, csz))  # (naux, csz, nvp)

    S = torch.zeros((nol, no, nvp, nvp), dtype=tau_p.dtype,
                    device=tau_p.device)
    for g1 in range(nchunk):
        for g2 in range(g1 + 1):
            Ld1 = gather_chunk(g1)
            Ld2 = Ld1 if g1 == g2 else gather_chunk(g2)
            for a in range(ntc):
                for b in range(a + 1 if g1 == g2 else ntc):
                    lda = _myslice(Ld1, 1, a, tsz)
                    ldb = _myslice(Ld2, 1, b, tsz)
                    w = einsum("Lac,Lbd->acbd", lda, ldb)
                    blk = einsum("acbd,ijcd->ijab", w, tau_p)
                    if g1 == g2 and a == b:
                        blk = 0.5 * blk
                    r0, c0 = (g1 * ntc + a) * tsz, (g2 * ntc + b) * tsz
                    S[:, :, r0:r0 + tsz, c0:c0 + tsz] = blk
            del Ld1, Ld2
    if padv:
        S = S[:, :, :nvir, :nvir]
    return S


# ---------------------------------------------------------- local update
def _update_local(t1, t2l, ovovl, oovvl, ovoo, oooo, Lov, Lvvl, fock,
                  mo_energy, *, nocc, nvir, mesh, ntile, nchunk,
                  level_shift):
    """One RCCSD Jacobi sweep on the rank's shards.  Index conventions
    follow cc/rccsd.update_amps term by term; every localization is
    justified inline by the integral / amplitude symmetry it uses."""
    d, N = mesh.rank, mesh.size
    oL = nocc // N
    nauxL = Lvvl.shape[0]
    fov = fock[:nocc, nocc:]
    foo = fock[:nocc, :nocc]
    fvv = fock[nocc:, nocc:]
    mo_e_o = mo_energy[:nocc]
    mo_e_v = mo_energy[nocc:] + level_shift

    def rows(x, ax=0, size=oL, who=None):
        return _myslice(x, ax, d if who is None else who, size)

    t1my = rows(t1)                       # (oL, v) rows i in d
    Lov_aux = rows(Lov, 0, nauxL)         # (nauxL, o, v) aux block d
    Lov_occ = rows(Lov, 1)                # (naux, oL, v) occ rows d
    taul = t2l + einsum("ia,jb->ijab", t1my, t1)

    # --- kappa intermediates (all o^2 / ov / v^2: summed over ranks) ----
    # A: sum_{lcd} (kc|ld) t2[ilcd]; localize l via (kc|ld)=(ld|kc) and
    # t2[ilcd]=t2[lidc], both first-axis local.
    kA = einsum("ldkc,lidc->ki", ovovl, t2l)
    kB = einsum("lckd,lidc->ki", ovovl, t2l)
    # x[kc] = (kc|ld) t1[ld]; z[kc] = (kd|lc) t1[ld] (localized forms)
    t1_l = t1my
    x_kc = einsum("ldkc,ld->kc", ovovl, t1_l)
    z_kc = einsum("lckd,ld->kc", ovovl, t1_l)
    # Fvv t2 terms: k local directly on both operands
    fA = einsum("kcld,klad->ac", ovovl, t2l)
    fB = einsum("kdlc,klad->ac", ovovl, t2l)
    kA, kB, x_kc, z_kc, fA, fB = mesh.psum_many(kA, kB, x_kc, z_kc, fA, fB)
    Fov = fov + 2.0 * x_kc - z_kc
    Foo = foo + 2.0 * kA - kB + einsum("kc,ic->ki", 2.0 * x_kc - z_kc, t1)
    Fvv = fvv - 2.0 * fA + fB - einsum("kc,ka->ac", 2.0 * x_kc - z_kc, t1)
    Foo_nd = Foo - torch.diag(mo_e_o)
    Fvv_nd = Fvv - torch.diag(mo_e_v)

    # lvv_t1 (the ovvv.t1 closure, DF-factorized; rccsd._OvvvOps.lvv_t1)
    z1 = einsum("Lkd,kd->L", Lov, t1)              # replicated, tiny
    u_lak = einsum("Lad,kd->Lak", Lvvl, t1)
    lvv_t1 = mesh.psum(
        2.0 * einsum("L,Lac->ac", rows(z1, 0, nauxL), Lvvl)
        - einsum("Lkc,Lak->ac", Lov_aux, u_lak))

    Loo_i = Foo_nd + einsum("kc,ic->ki", fov, t1) \
        + 2.0 * einsum("lcki,lc->ki", ovoo, t1) \
        - einsum("kcli,lc->ki", ovoo, t1)
    Lvv_i = Fvv_nd - einsum("kc,ka->ac", fov, t1) + lvv_t1

    # --- T1 (Eq. 35) ----------------------------------------------------
    t1new = fov.clone()
    t1new -= 2.0 * einsum("kc,ka,ic->ia", fov, t1, t1)
    t1new += einsum("ac,ic->ia", Fvv_nd, t1)
    t1new -= einsum("ki,ka->ia", Foo_nd, t1)
    Fov_l = rows(Fov)
    # t2[kica]: k local directly; t2[ikca] = t2[kiac]
    g1 = 2.0 * einsum("kc,kica->ia", Fov_l, t2l)
    g1 -= einsum("kc,kiac->ia", Fov_l, t2l)
    # 2 (kc|ai) t1[kc]: ovvo[kcai] = (kc|ia) = ovov[k,c,i,a]
    g1 += 2.0 * einsum("kcia,kc->ia", ovovl, t1_l)
    g1 -= einsum("kiac,kc->ia", oovvl, t1_l)
    # ovvv.t2 terms (DF): x[Lic] = Lov[Lkd] t2[ikcd]; t2[ikcd]=t2[kidc]
    x_df = einsum("Lkd,kidc->Lic", Lov_occ, t2l)
    y_df = einsum("Lkc,kidc->Lid", Lov_occ, t2l)
    x_df, y_df = mesh.psum_many(x_df, y_df)
    g1 += 2.0 * einsum("Lic,Lac->ia", rows(x_df, 0, nauxL), Lvvl)
    g1 -= einsum("Lid,Lad->ia", rows(y_df, 0, nauxL), Lvvl)
    # ovoo.t2: (lc|ki) t2[klac]: localize l: t2[klac] = t2[lkca]
    g1 -= 2.0 * einsum("lcki,lkca->ia", rows(ovoo), t2l)
    g1 += einsum("kcli,klac->ia", rows(ovoo), t2l)
    t1new += mesh.psum(g1)
    t1new += einsum("ac,ic->ia", lvv_t1, t1)
    # ovoo.t1.t1 terms (ovoo replicated: computed replicated)
    m1 = einsum("lcki,lc->ki", ovoo, t1)
    m2 = einsum("kcli,lc->ki", ovoo, t1)
    t1new -= 2.0 * einsum("ki,ka->ia", m1, t1)
    t1new += einsum("ki,ka->ia", m2, t1)
    t1new += einsum("kc,ic,ka->ia", Fov, t1, t1)

    # --- ring A over ovov shards: Wvoov / Wvovo / Woooo(tmp) -----------
    # Wvoov[a,k,i_loc,c], Wvovo[a,k,c,i_loc] with the k axis FULL on the
    # rank that owns the i_loc rows; tmp[k,l,i_loc,j] = (kc|ld) tau.
    Wvoov = ovovl.permute(1, 2, 0, 3).clone()         # ovov[i,a,k,c]
    Wvovo = oovvl.permute(2, 1, 3, 0).clone()         # oovv[i,k,a,c]
    # DF pieces.  The aux sum spans ranks while the output keeps only MY
    # i rows, so a bare sum of aux-local x i-local partials would mix
    # other ranks' i blocks into mine.  Instead: build the SMALL
    # aux-local factor over the FULL occupied axis, gather it (it is
    # O(naux o v), never O(naux v^2)), slice my rows, contract against
    # the replicated Lov, all local.
    #   Wvoov += sum_L Q[L,a,i] Lov[L,k,c],
    #   Q = Lvv.t1 (wvoov_t1) - (Lov.t1).t1 (the -(ld|kc)t1_id t1_la term)
    B2 = einsum("Lld,id->Lli", Lov_aux, t1)
    Q = einsum("Lad,id->Lai", Lvvl, t1) - einsum("Lli,la->Lai", B2, t1)
    Qf = mesh.all_gather(Q)
    Wvoov += einsum("Lai,Lkc->akic", rows(Qf, 2), Lov)
    #   Wvovo += sum_L x3[L,k,i] (Lvv - v1)[L,a,c]: the second factor is
    #   O(naux v^2) and stays aux-sharded: ring it instead of gathering.
    x3f = mesh.all_gather(einsum("Lkd,id->Lki", Lov_aux, t1))
    x3me = rows(x3f, 2)                               # (naux, o, oL)
    v1 = einsum("Llc,la->Lac", Lov_aux, t1)
    Rbuf = Lvvl - v1
    wvovo_df = torch.zeros((nvir, nocc, nvir, oL), dtype=t2l.dtype,
                           device=t2l.device)
    for s in range(N):
        blk = (d - s) % N
        wvovo_df += einsum("Lki,Lac->akci", rows(x3me, 0, nauxL, blk), Rbuf)
        if s + 1 < N:
            Rbuf = mesh.ring_shift(Rbuf)
    Wvovo += wvovo_df
    del wvovo_df, Rbuf
    # ovoo.t1 pieces (replicated integrals, my i rows)
    ovoo_i = rows(ovoo, 3)                            # (o, v, o, oL)
    Wvoov -= einsum("kcli,la->akic", ovoo_i, t1)
    Wvovo -= einsum("lcki,la->akci", ovoo_i, t1)

    Woooo = rows(oooo, 1).permute(0, 2, 1, 3).clone()  # oooo[k,i,l,j]
    Woooo += einsum("lcki,jc->klij", ovoo_i, t1)
    Woooo += einsum("kclj,ic->klij", ovoo, t1my)

    tmp = torch.zeros((nocc, nocc, oL, nocc), dtype=t2l.dtype,
                      device=t2l.device)
    buf = ovovl
    for s in range(N):
        blk = (d - s) % N
        # ring terms of the chi intermediates: the shard rows of ovov play
        # the CONTRACTED occupied slot l via (kc|ld)=(ld|kc); the t2 side
        # slices its FULL second occupied axis at the block.
        t2il = rows(t2l, 1, oL, blk)                  # t2[i_loc, l@blk]
        Wvoov += (-0.5 * einsum("ldkc,ilda->akic", buf, t2il)
                  - 0.5 * einsum("lckd,ilad->akic", buf, t2il)
                  + einsum("ldkc,ilad->akic", buf, t2il))
        Wvovo -= 0.5 * einsum("lckd,ilda->akci", buf, t2il)
        # tmp[k@blk, l, i_loc, j] = (kc|ld) tau[ijcd]: the shard rows play
        # k, tau rows are local
        tmp[blk * oL:(blk + 1) * oL] = einsum("kcld,ijcd->klij", buf, taul)
        if s + 1 < N:
            buf = mesh.ring_shift(buf)
    # Woooo = oooo part + ovoo.t1 parts + (kc|ld) tau  (the explicit
    # (kc|ld) t1 t1 term of Eq. 42 and the (kc|ld) t2 term sum exactly to
    # the tau contraction)
    Woooo += tmp

    # --- ring B over t2 shards: the o^2v^2-output contractions ---------
    K = torch.zeros_like(t2l)         # P(ij|ab)-symmetrized accumulator
    r2d = torch.zeros_like(t2l)       # direct (already symmetric) part
    Loo_my = rows(Loo_i, 1)           # Loo[:, i_loc]
    buf = t2l
    for s in range(N):
        blk = (d - s) % N
        tau_s = buf + einsum("ia,jb->ijab", rows(t1, 0, oL, blk), t1)
        Wv_s = rows(Wvoov, 1, oL, blk)
        Wo_s = rows(Wvovo, 1, oL, blk)
        K += 2.0 * einsum("akic,kjcb->ijab", Wv_s, buf)
        K -= einsum("akci,kjcb->ijab", Wo_s, buf)
        K -= einsum("akic,kjbc->ijab", Wv_s, buf)
        K -= einsum("bkci,kjac->ijab", Wo_s, buf)
        K -= einsum("ki,kjab->ijab", rows(Loo_my, 0, oL, blk), buf)
        r2d += einsum("klij,klab->ijab", rows(Woooo, 0, oL, blk), tau_s)
        if s + 1 < N:
            buf = mesh.ring_shift(buf)
    del Wvoov, Wvovo, Woooo, buf

    # --- K light terms (all row-local) -----------------------------------
    K += einsum("ac,ijcb->ijab", Lvv_i, t2l)
    # t2_vvov_t1 (DF): sum_L Lov[L,i,a] (Lvv[L,c,b] t1[j,c]): gather the
    # small aux-local factor, contract locally (see the Wvoov DF note)
    x4 = mesh.all_gather(einsum("Lcb,jc->Ljb", Lvvl, t1))
    K += einsum("Lia,Ljb->ijab", rows(Lov, 1), x4)
    # -(ki|bc) t1[ka] t1[jc]: (ki|bc) = (ik|bc), first axis local
    K -= einsum("ikbc,ka,jc->ijab", oovvl, t1, t1)
    # -tmp2.t1: tmp2 = (ia|jk) + (kc|ai) t1[jc]; (kc|ai)=(ia|kc) local
    K -= einsum("iajk,kb->ijab", rows(ovoo), t1)
    K -= einsum("iakc,jc,kb->ijab", ovovl, t1, t1)

    # --- ladder + quadratic dressing fix --------------------------------
    tau_sym = 0.5 * (taul + _t_exchange(taul, mesh))
    Ldl = Lvvl - einsum("ka,Lkc->Lac", t1, Lov_aux)
    S = _ladder_local(tau_sym, Ldl, mesh, ntile, nchunk)
    del tau_sym, Ldl
    # quadratic dressing artifact: tmp[k,l,i_loc,j] already holds
    # (kc|ld) tau[ijcd]
    r2d -= einsum("klij,ka,lb->ijab", tmp, t1, t1)

    # --- assemble --------------------------------------------------------
    KS = K + S
    del K, S
    t2new = KS + _t_exchange(KS, mesh)
    t2new += ovovl.permute(0, 2, 1, 3)
    t2new += r2d

    eia = mo_e_o[:, None] - mo_e_v[None, :]
    d2l = rows(eia)[:, None, :, None] + eia[None, :, None, :]
    return t1new / eia, t2new / d2l


def update_amps_tiled(t1, t2, eris: RERIs, mesh, ntile=8, nchunk=2,
                      level_shift=0.0):
    """One RCCSD Jacobi sweep with sharded compute (see the module
    docstring).  t1 replicated, t2 this rank's rows (shard_amps_tiled);
    eris from shard_eris_tiled.  Returns (t1new replicated, t2new's
    rows)."""
    N = mesh.size
    nocc, nvir = t1.shape
    if nocc % N:
        raise ValueError(f"nocc={nocc} must divide the mesh size {N}")
    if eris.Lov.shape[0] % N:
        raise ValueError("aux axis not padded to the mesh size; build "
                         "the container with shard_eris_tiled")
    return _update_local(t1, t2, eris.ovov, eris.oovv, eris.ovoo,
                         eris.oooo, eris.Lov, eris.Lvv, eris.fock,
                         eris.mo_energy, nocc=nocc, nvir=nvir, mesh=mesh,
                         ntile=ntile, nchunk=nchunk,
                         level_shift=level_shift)


def energy_tiled(t1, t2, eris: RERIs, mesh):
    """CCSD correlation energy on the sharded containers: each rank's rows
    of the t2 terms, summed over the ranks, plus the replicated t1 term."""
    nocc = t1.shape[0]
    fov = eris.fock[:nocc, nocc:]
    tau = t2 + einsum("ia,jb->ijab", mesh.rows(t1), t1)
    e = 2.0 * einsum("ijab,iajb->", tau, eris.ovov)
    e = e - einsum("ijab,ibja->", tau, eris.ovov)
    return 2.0 * einsum("ia,ia->", fov, t1) + mesh.psum(e.reshape(1))[0]


def kernel_tiled(eris: RERIs, mesh, max_cycle=50, conv_tol=1e-8,
                 conv_tol_normt=1e-6, diis_space=6, ntile=8, nchunk=2,
                 verbose=0):
    """Host-driven CCSD iteration over the tiled update with the host DIIS
    of the JAX package on the whole amplitude vector (lib.diis.DIIS, its
    ring as numpy arrays).  Each cycle gathers t2 on every rank; rank 0
    extrapolates and broadcasts the vector, and each rank keeps its rows,
    so every rank continues from the same amplitudes whatever its host's
    arithmetic.  Returns (converged, e_corr, t1, t2 rows)."""
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    log = lg.Logger(verbose=verbose if mesh.rank == 0 else 0)
    nocc = eris.oooo.shape[0]
    fov = eris.fock[:nocc, nocc:]
    eo = eris.mo_energy[:nocc]
    ev = eris.mo_energy[nocc:]
    eia = eo[:, None] - ev[None, :]
    d2 = mesh.rows(eia)[:, None, :, None] + eia[None, :, None, :]
    t1 = fov / eia
    t2 = eris.ovov.permute(0, 2, 1, 3) / d2
    nvir = t1.shape[1]
    n1 = nocc * nvir
    diis = DIIS(space=diis_space) if mesh.rank == 0 else None
    e_last = float(energy_tiled(t1, t2, eris, mesh))
    converged = False
    e = e_last
    for it in range(max_cycle):
        t1n, t2n = update_amps_tiled(t1, t2, eris, mesh, ntile=ntile,
                                     nchunk=nchunk)
        dt2 = torch.sum((t2n - t2) ** 2).reshape(1)
        normt = float(torch.linalg.norm(t1n - t1)
                      + torch.sqrt(mesh.psum(dt2))[0])
        t2all = mesh.all_gather(t2n)
        if mesh.rank == 0:
            vec = diis.update(np.concatenate(
                [t1n.cpu().numpy().ravel(), t2all.cpu().numpy().ravel()]))
            vec = torch.from_numpy(vec).to(t2n.device, t2n.dtype)
        else:
            vec = torch.empty(n1 + t2all.numel(), dtype=t2n.dtype,
                              device=t2n.device)
        del t2all
        vec = mesh.broadcast(vec, 0)
        t1 = vec[:n1].view(nocc, nvir).clone()
        t2 = mesh.rows(vec[n1:].view(nocc, nocc, nvir, nvir)).clone()
        del vec
        e = float(energy_tiled(t1, t2, eris, mesh))
        log.info("cycle %2d  E_corr(tiled RCCSD) = %.14f  dE = %10.3e  "
                 "|dt| = %9.3e", it, e, e - e_last, normt)
        # the ranks stop together: on the count of ranks that see
        # convergence, which is the same number on every rank
        done = abs(e - e_last) < conv_tol and normt < conv_tol_normt
        if int(mesh.psum(torch.tensor([int(done)], device=t2.device))[0]) \
                == mesh.size:
            converged = True
            break
        e_last = e
    return converged, e, t1, t2
