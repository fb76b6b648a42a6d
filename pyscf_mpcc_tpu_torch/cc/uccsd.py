"""Unrestricted CCSD: spin-orbital equations over spin-traced blocks.

Port of ``pyscf_mpcc_tpu/cc/uccsd.py``: the spin-orbital CCSD equations
of Stanton, Gauss, Watts & Bartlett (J. Chem. Phys. 94, 4334 (1991), Eqs.
(1)-(13)) over (alpha, beta) blocks, with the spin sums traced by
cc/spinsum.seinsum, one dense torch contraction (a cuBLAS GEMM on the
card) per surviving spin case.

The three-virtual integral classes never materialize on the DF path: the
particle-particle ladder runs through t1-dressed DF factors with explicit
quadratic compensation, the same-spin blocks on rccsd.pair_ladder_sym and
the opposite-spin block tiled over its first virtual axis
(``_ladder_tiled``), each tile recomputed in the backward pass rather than
saved when autograd records the call (rccsd._remat): the unrestricted Λ
solver differentiates the whole update.  A materialized path (ovvv/vvvv
blocks present) serves tests and small systems.

The DF transforms run in fp64 on the target device (the JAX package does
them in host NumPy) and the blocks are stored in the working dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.cc.eris import _fp64, _pair
from pyscf_mpcc_tpu_torch.cc.rccsd import _remat, pair_ladder_sym
from pyscf_mpcc_tpu_torch.cc.spinsum import (ST, anti4, asym, seinsum,
                                             st_t2, t1_st, t2_st)
from pyscf_mpcc_tpu_torch.lib import device as _dev

einsum = torch.einsum


class UERIs(NamedTuple):
    """Chemists' MO blocks; lowercase = alpha, uppercase = beta.

    The o^2 v^2-class blocks are always materialized.  The three-virtual
    classes come either materialized (ovvv/OVVV/ovVV/OVvv + vvvv/VVVV/vvVV,
    test path) or as per-spin 3-center DF factors (Lov_*, Lvv_*,
    production path); exactly one of the two groups is set.
    """
    focka: torch.Tensor
    fockb: torch.Tensor
    nocca: int
    noccb: int
    # same-spin alpha
    oooo: torch.Tensor
    ovoo: torch.Tensor
    ovov: torch.Tensor
    oovv: torch.Tensor
    ovvo: torch.Tensor
    # same-spin beta
    OOOO: torch.Tensor
    OVOO: torch.Tensor
    OVOV: torch.Tensor
    OOVV: torch.Tensor
    OVVO: torch.Tensor
    # mixed spin
    ooOO: torch.Tensor
    ovOO: torch.Tensor
    OVoo: torch.Tensor
    ovOV: torch.Tensor
    ooVV: torch.Tensor
    OOvv: torch.Tensor
    ovVO: torch.Tensor
    OVvo: torch.Tensor
    # three-virtual classes, materialized (tests / small systems)
    ovvv: Optional[torch.Tensor] = None
    OVVV: Optional[torch.Tensor] = None
    ovVV: Optional[torch.Tensor] = None
    OVvv: Optional[torch.Tensor] = None
    vvvv: Optional[torch.Tensor] = None
    VVVV: Optional[torch.Tensor] = None
    vvVV: Optional[torch.Tensor] = None
    # or 3-center DF factors (production)
    Lov_a: Optional[torch.Tensor] = None
    Lvv_a: Optional[torch.Tensor] = None
    Lov_b: Optional[torch.Tensor] = None
    Lvv_b: Optional[torch.Tensor] = None
    # sharded mode (parallel/mesh.shard_ueris): the parallel.mesh.Mesh
    # whose ranks each hold an aux shard of the DF factors; the update
    # sums their partial contractions
    mesh: Optional[object] = None

    @property
    def mo_energy(self):
        return (torch.diagonal(self.focka), torch.diagonal(self.fockb))


def _mo_fock(mo, fock_ao, device, dtype):
    mo = _fp64(mo, device)
    return (mo.T @ _fp64(fock_ao, device) @ mo).to(dtype)


def make_eris_incore(eri_ao, mo_a, mo_b, focka_ao, fockb_ao, nocca, noccb,
                     dtype=None, *, device):
    """All spin blocks from AO integrals (testing / moderate sizes),
    transformed in fp64 on the device."""
    from pyscf_mpcc_tpu_torch import ao2mo
    device, dtype = _dev.resolve(device, dtype)
    ja, jb = _fp64(mo_a, device), _fp64(mo_b, device)
    eri = _fp64(eri_ao, device)
    oa, va = ja[:, :nocca], ja[:, nocca:]
    ob, vb = jb[:, :noccb], jb[:, noccb:]

    def g(c1, c2, c3, c4):
        return ao2mo.general(eri, (c1, c2, c3, c4)).to(dtype).contiguous()

    return UERIs(
        focka=_mo_fock(mo_a, focka_ao, device, dtype),
        fockb=_mo_fock(mo_b, fockb_ao, device, dtype),
        nocca=nocca, noccb=noccb,
        oooo=g(oa, oa, oa, oa), ovoo=g(oa, va, oa, oa),
        ovov=g(oa, va, oa, va), oovv=g(oa, oa, va, va),
        ovvo=g(oa, va, va, oa),
        OOOO=g(ob, ob, ob, ob), OVOO=g(ob, vb, ob, ob),
        OVOV=g(ob, vb, ob, vb), OOVV=g(ob, ob, vb, vb),
        OVVO=g(ob, vb, vb, ob),
        ooOO=g(oa, oa, ob, ob), ovOO=g(oa, va, ob, ob),
        OVoo=g(ob, vb, oa, oa), ovOV=g(oa, va, ob, vb),
        ooVV=g(oa, oa, vb, vb), OOvv=g(ob, ob, va, va),
        ovVO=g(oa, va, vb, ob), OVvo=g(ob, vb, va, oa),
        ovvv=g(oa, va, va, va), OVVV=g(ob, vb, vb, vb),
        ovVV=g(oa, va, vb, vb), OVvv=g(ob, vb, va, va),
        vvvv=g(va, va, va, va), VVVV=g(vb, vb, vb, vb),
        vvVV=g(va, va, vb, vb),
    )


def _half(B, c1, c2):
    """L[L,i,j] = sum_pq B[L,p,q] c1[p,i] c2[q,j]."""
    return einsum("Liq,qj->Lij", einsum("Lpq,pi->Liq", B, c1), c2)


def make_eris_df(b_ao, mo_a, mo_b, focka_ao, fockb_ao, nocca, noccb,
                 dtype=None, *, device):
    """DF eris: o^2 v^2 blocks materialized, 3-virtual classes as factors.
    Every transform and block product runs in fp64 on the device; the
    results are stored in the working dtype."""
    device, dtype = _dev.resolve(device, dtype)
    B = _fp64(b_ao, device)
    moa, mob = _fp64(mo_a, device), _fp64(mo_b, device)
    oa, va = moa[:, :nocca], moa[:, nocca:]
    ob, vb = mob[:, :noccb], mob[:, noccb:]
    Loo_a, Lov_a, Lvv_a = _half(B, oa, oa), _half(B, oa, va), _half(B, va, va)
    Loo_b, Lov_b, Lvv_b = _half(B, ob, ob), _half(B, ob, vb), _half(B, vb, vb)
    del B

    def e(a, b):       # (xy|zw)
        return _pair(a, b).to(dtype)

    def ex(a, b):      # (xy|wz) stored [x,y,z,w]
        return _pair(a, b).permute(0, 1, 3, 2).to(dtype).contiguous()

    return UERIs(
        focka=_mo_fock(mo_a, focka_ao, device, dtype),
        fockb=_mo_fock(mo_b, fockb_ao, device, dtype),
        nocca=nocca, noccb=noccb,
        oooo=e(Loo_a, Loo_a), ovoo=e(Lov_a, Loo_a),
        ovov=e(Lov_a, Lov_a), oovv=e(Loo_a, Lvv_a), ovvo=ex(Lov_a, Lov_a),
        OOOO=e(Loo_b, Loo_b), OVOO=e(Lov_b, Loo_b),
        OVOV=e(Lov_b, Lov_b), OOVV=e(Loo_b, Lvv_b), OVVO=ex(Lov_b, Lov_b),
        ooOO=e(Loo_a, Loo_b), ovOO=e(Lov_a, Loo_b), OVoo=e(Lov_b, Loo_a),
        ovOV=e(Lov_a, Lov_b), ooVV=e(Loo_a, Lvv_b), OOvv=e(Loo_b, Lvv_a),
        ovVO=ex(Lov_a, Lov_b), OVvo=ex(Lov_b, Lov_a),
        Lov_a=Lov_a.to(dtype), Lvv_a=Lvv_a.to(dtype),
        Lov_b=Lov_b.to(dtype), Lvv_b=Lvv_b.to(dtype),
    )


def uhf_focks(mf):
    """(focka_ao, fockb_ao) of a UHF/ROHF mean field, or the RHF Fock
    twice."""
    dm = mf.make_rdm1()
    if np.asarray(dm).ndim == 2:
        f = mf.get_fock(dm)
        return f, f
    j, k = mf.get_jk(dm)
    h = mf.get_hcore()
    return h + j[0] + j[1] - k[0], h + j[0] + j[1] - k[1]


def eris_from_scf(mf, dtype=None, *, device):
    """Incore UERIs of a UHF/ROHF mean field."""
    from pyscf_mpcc_tpu_torch import gto
    fa, fb = uhf_focks(mf)
    na, nb = mf.mol.nelec
    return make_eris_incore(gto.intor_eri(mf.mol), mf.mo_coeff[0],
                            mf.mo_coeff[1], fa, fb, na, nb, dtype,
                            device=device)


def _nocc(eris):
    return eris.oooo.shape[0], eris.OOOO.shape[0]


def _eia(eris, level_shift=0.0):
    na, nb = _nocc(eris)
    ea, eb = eris.mo_energy
    return (ea[:na, None] - (ea[None, na:] + level_shift),
            eb[:nb, None] - (eb[None, nb:] + level_shift))


def _d2(eia_a, eia_b):
    """(daa, dab, dbb) doubles denominators."""
    return (eia_a[:, None, :, None] + eia_a[None, :, None, :],
            eia_a[:, None, :, None] + eia_b[None, :, None, :],
            eia_b[:, None, :, None] + eia_b[None, :, None, :])


def init_amps(eris: UERIs):
    """MP2 initial guess; returns (emp2, (t1a, t1b), (t2aa, t2ab, t2bb))."""
    na, nb = _nocc(eris)
    eia_a, eia_b = _eia(eris)
    t1a = eris.focka[:na, na:] / eia_a
    t1b = eris.fockb[:nb, nb:] / eia_b
    daa, dab, dbb = _d2(eia_a, eia_b)
    gaa = eris.ovov.permute(0, 2, 1, 3) - eris.ovov.permute(0, 2, 3, 1)
    gbb = eris.OVOV.permute(0, 2, 1, 3) - eris.OVOV.permute(0, 2, 3, 1)
    gab = eris.ovOV.permute(0, 2, 1, 3)
    t2aa = gaa / daa
    t2ab = gab / dab
    t2bb = gbb / dbb
    emp2 = 0.25 * einsum("ijab,ijab->", t2aa, gaa)
    emp2 = emp2 + 0.25 * einsum("ijab,ijab->", t2bb, gbb)
    emp2 = emp2 + einsum("ijab,ijab->", t2ab, gab)
    return emp2, (t1a, t1b), (t2aa, t2ab, t2bb)


def energy(t1, t2, eris: UERIs):
    t1a, t1b = t1
    t2aa, t2ab, t2bb = t2
    na, nb = _nocc(eris)
    fova = eris.focka[:na, na:]
    fovb = eris.fockb[:nb, nb:]
    e = einsum("ia,ia->", fova, t1a) + einsum("ia,ia->", fovb, t1b)
    e = e + 0.25 * (einsum("ijab,iajb->", t2aa, eris.ovov)
                    - einsum("ijab,ibja->", t2aa, eris.ovov))
    e = e + 0.25 * (einsum("ijab,iajb->", t2bb, eris.OVOV)
                    - einsum("ijab,ibja->", t2bb, eris.OVOV))
    e = e + einsum("iJaB,iaJB->", t2ab, eris.ovOV)
    e = e + 0.5 * (einsum("ia,jb,iajb->", t1a, t1a, eris.ovov)
                   - einsum("ia,jb,ibja->", t1a, t1a, eris.ovov))
    e = e + 0.5 * (einsum("ia,jb,iajb->", t1b, t1b, eris.OVOV)
                   - einsum("ia,jb,ibja->", t1b, t1b, eris.OVOV))
    e = e + einsum("ia,jb,iajb->", t1a, t1b, eris.ovOV)
    return e


# ---------------------------------------------------------------------------
# antisymmetrized physicists' integral blocks <pq||rs> from chemists' UERIs
# ---------------------------------------------------------------------------

def _g_oovv(er):
    """<mn||ef>."""
    return anti4(er.ovov.permute(0, 2, 1, 3),
                 er.OVOV.permute(0, 2, 1, 3),
                 er.ovOV.permute(0, 2, 1, 3))


def _g_oovv_dir(er):
    """Direct (me|nf) in [m,e,n,f] order (ladder quadratic compensation).
    Signatures follow storage order: the mixed block has (m,e) alpha and
    (n,f) beta, i.e. key 'aabb'."""
    return ST({"aaaa": er.ovov, "bbbb": er.OVOV, "aabb": er.ovOV,
               "bbaa": er.ovOV.permute(2, 3, 0, 1)})


def _g_oooo(er):
    """<mn||ij>."""
    return anti4(er.oooo.permute(0, 2, 1, 3),
                 er.OOOO.permute(0, 2, 1, 3),
                 er.ooOO.permute(0, 2, 1, 3))


def _g_ooov(er):
    """<mn||ie>: 3rd index occupied, 4th virtual (mixed blocks by hand)."""
    return ST({
        "aaaa": (er.ovoo.permute(2, 0, 3, 1) - er.ovoo.permute(0, 2, 3, 1)),
        "bbbb": (er.OVOO.permute(2, 0, 3, 1) - er.OVOO.permute(0, 2, 3, 1)),
        "abab": er.OVoo.permute(2, 0, 3, 1),
        "baba": er.ovOO.permute(2, 0, 3, 1),
        "abba": -er.ovOO.permute(0, 2, 3, 1),
        "baab": -er.OVoo.permute(0, 2, 3, 1),
    })


def _g_ovvo(er):
    """<mb||ej>: [occ, vir, vir, occ]."""
    return ST({
        "aaaa": (er.ovvo.permute(0, 2, 1, 3) - er.oovv.permute(0, 2, 3, 1)),
        "bbbb": (er.OVVO.permute(0, 2, 1, 3) - er.OOVV.permute(0, 2, 3, 1)),
        "abab": er.ovVO.permute(0, 2, 1, 3),
        "baba": er.OVvo.permute(0, 2, 1, 3),
        "abba": -er.ooVV.permute(0, 2, 3, 1),
        "baab": -er.OOvv.permute(0, 2, 3, 1),
    })


def _g_ovvv(er):
    """<ma||ef>: [occ, vir, vir, vir] (materialized path only)."""
    return anti4(er.ovvv.permute(0, 2, 1, 3),
                 er.OVVV.permute(0, 2, 1, 3),
                 er.ovVV.permute(0, 2, 1, 3),
                 direct_ba=er.OVvv.permute(0, 2, 1, 3))


def _g_vvvv(er):
    """<ab||ef> (materialized path only)."""
    return anti4(er.vvvv.permute(0, 2, 1, 3),
                 er.VVVV.permute(0, 2, 1, 3),
                 er.vvVV.permute(0, 2, 1, 3))


def _g_vvvo(er):
    """<ab||ej>: [vir, vir, vir, occ] (materialized path only)."""
    return ST({
        "aaaa": (er.ovvv.permute(2, 1, 3, 0) - er.ovvv.permute(1, 2, 3, 0)),
        "bbbb": (er.OVVV.permute(2, 1, 3, 0) - er.OVVV.permute(1, 2, 3, 0)),
        "abab": er.OVvv.permute(2, 1, 3, 0),
        "baba": er.ovVV.permute(2, 1, 3, 0),
        "abba": -er.ovVV.permute(1, 2, 3, 0),
        "baab": -er.OVvv.permute(1, 2, 3, 0),
    })


# ---------------------------------------------------------------------------
# three-virtual term groups: materialized (tests) and DF-factorized paths
# ---------------------------------------------------------------------------

def _high_virtual_materialized(eris, T1, T2, tau, g_oovv):
    """ovvv/vvvv/vvvo contributions with materialized blocks.

    Returns (Fae_hi, Wmbej_hi, t1_hi, t2_hi): the <ma||ef>-class pieces of
    the SG intermediates plus the full particle-particle ladder
    0.5 tau_ijef W_abef and the P(ij) t1_ie <ab||ej> doubles term.
    """
    g_ovvv = _g_ovvv(eris)
    g_vvvv = _g_vvvv(eris)
    g_vvvo = _g_vvvo(eris)
    Fae_hi = seinsum("mf,mafe->ae", T1, g_ovvv)
    Wmbej_hi = seinsum("jf,mbef->mbej", T1, g_ovvv)
    t1_hi = -0.5 * seinsum("imef,maef->ia", T2, g_ovvv)
    Wabef = (g_vvvv
             + asym(seinsum("mb,maef->abef", T1, g_ovvv), 0, 1)
             + 0.25 * seinsum("mnab,mnef->abef", tau, g_oovv))
    t2_hi = 0.5 * seinsum("ijef,abef->ijab", tau, Wabef)
    t2_hi = t2_hi + asym(seinsum("ie,abej->ijab", T1, g_vvvo), 0, 1)
    return Fae_hi, Wmbej_hi, t1_hi, t2_hi


def _lsum(mesh):
    """Blockwise sum of a spin-blocked partial L-sum over the mesh's ranks
    (parallel/mesh), or the identity where the factors are whole."""
    if mesh is None:
        return lambda st: st
    return lambda st: ST({k: mesh.psum(v) for k, v in st.b.items()})


def _ladder_tile(tau, l1, L2):
    w = einsum("Lae,Lbf->abef", l1, L2)
    return einsum("abef,ijef->ijab", w, tau)


def _ladder_tiled(tau, L1, L2, ntile):
    """sum_{L,e,f} L1[L,a,e] L2[L,b,f] tau[i,j,e,f] -> [i,j,a,b], tiled
    over the first virtual axis so (v,v,v,v) never materializes whole (the
    last tile is the remainder; any (nvir, ntile) works).

    Same-spin blocks pass the SAME dressed factor for L1 and L2 and an
    antisymmetric tau, so the pair-mirrored symmetric ladder applies
    (rccsd.pair_ladder_sym halves the two dominant dot costs).  The
    opposite-spin block has no such symmetry and takes the tiles below,
    each recomputed in the backward pass instead of having its 4-index w
    block saved (about 1.5 GiB a tile at OH(H2O)3/cc-pVTZ)."""
    if L1 is L2:
        return pair_ladder_sym(tau, L1, ntile)
    nv1 = L1.shape[1]
    ntile = max(1, min(int(ntile), nv1))
    ta = -(-nv1 // ntile)
    blocks = [_remat(_ladder_tile, tau, L1[:, a0:a0 + ta], L2)
              for a0 in range(0, nv1, ta)]
    return torch.cat(blocks, dim=2)


def _high_virtual_df(eris, t1, T1, T2, tau, g_oovv, g_oovv_dir, ntile):
    """The same term groups factorized through the 3-center DF factors.

    Ladder: 0.5 tau W_abef == tau.(dressed vv|vv) - quadratic compensation
    + 1/8 tau tau <mn||ef> (the W_abef quadratic evaluated in o^4 space),
    the rccsd._ladder_df design, spin-generalized.  Everything else is a
    direct factorization (each <..|vv> contraction runs through L).
    """
    t1a, t1b = t1
    La, Ua = eris.Lov_a, eris.Lvv_a
    Lb, Ub = eris.Lov_b, eris.Lvv_b
    # over a mesh (parallel/mesh.shard_ueris) the factors are this rank's
    # aux shard: each L-sum below is partial and is summed over the ranks
    lsum = _lsum(eris.mesh)

    # ---- Fae += sum_mf t1_mf <ma||fe> -----------------------------------
    ra = einsum("Lmf,mf->L", La, t1a)
    rb = einsum("LMF,MF->L", Lb, t1b)
    xa = einsum("Lme,mf->Lef", La, t1a)
    xb = einsum("LME,MF->LEF", Lb, t1b)
    Fae_hi = lsum(ST({
        "aa": (einsum("L,Lae->ae", ra + rb, Ua)
               - einsum("Lef,Laf->ae", xa, Ua)),
        "bb": (einsum("L,LAE->AE", ra + rb, Ub)
               - einsum("LEF,LAF->AE", xb, Ub)),
    }))

    # ---- Wmbej += sum_f t1_jf <mb||ef> ----------------------------------
    Yaa = einsum("Lbf,jf->Ljb", Ua, t1a)    # (vv|.)t1, alpha
    Ybb = einsum("LBF,JF->LJB", Ub, t1b)
    Zaa = einsum("Lmf,jf->Lmj", La, t1a)    # (ov|.)t1, alpha
    Zbb = einsum("LMF,JF->LMJ", Lb, t1b)
    Wmbej_hi = lsum(ST({
        "aaaa": (einsum("Lme,Ljb->mbej", La, Yaa)
                 - einsum("Lmj,Lbe->mbej", Zaa, Ua)),
        "bbbb": (einsum("LME,LJB->MBEJ", Lb, Ybb)
                 - einsum("LMJ,LBE->MBEJ", Zbb, Ub)),
        "abab": einsum("Lme,LJB->mBeJ", La, Ybb),
        "baba": einsum("LME,Ljb->MbEj", Lb, Yaa),
        "abba": -einsum("Lmj,LBE->mBEj", Zaa, Ub),
        "baab": -einsum("LMJ,Lbe->MbeJ", Zbb, Ua),
    }))

    # ---- t1 += -1/2 sum_mef t2_imef <ma||ef> ----------------------------
    t2aa, t2ab, t2bb = st_t2(T2)
    Xa = einsum("imef,Lme->Lif", t2aa, La)
    Xb = einsum("IMEF,LME->LIF", t2bb, Lb)
    Zab = einsum("iMeF,LMF->Lie", t2ab, Lb)
    Zba = einsum("mIeF,Lme->LIF", t2ab, La)
    t1_hi = lsum(ST({
        "aa": (-einsum("Lif,Laf->ia", Xa, Ua)
               + einsum("Lie,Lae->ia", Zab, Ua)),
        "bb": (-einsum("LIF,LAF->IA", Xb, Ub)
               + einsum("LIF,LAF->IA", Zba, Ub)),
    }))

    # ---- ladder: dressed factors, quadratic compensation ----------------
    Ua_d = Ua - einsum("Lme,ma->Lae", La, t1a)
    Ub_d = Ub - einsum("LME,MA->LAE", Lb, t1b)
    tau_aa, tau_ab, tau_bb = st_t2(tau)
    Daa = _ladder_tiled(tau_aa, Ua_d, Ua_d, ntile)
    Dbb = _ladder_tiled(tau_bb, Ub_d, Ub_d, ntile)
    Dab = _ladder_tiled(tau_ab, Ua_d, Ub_d, ntile)
    del Ua_d, Ub_d
    Xdir = seinsum("ijef,menf->mnij", tau, g_oovv_dir)
    Qcomp = seinsum("ma,nb,mnij->ijab", T1, T1, Xdir)
    Yanti = seinsum("ijef,mnef->mnij", tau, g_oovv)
    Wquad = 0.125 * seinsum("mnab,mnij->ijab", tau, Yanti)
    t2_hi = (lsum(ST({"aaaa": Daa, "abab": Dab, "bbbb": Dbb}))
             - Qcomp + Wquad)

    # ---- t2 += P(ij) sum_e t1_ie <ab||ej> --------------------------------
    Aa = einsum("ie,Lae->Lia", t1a, Ua)     # t1-dressed (a e| rows
    Ab = einsum("IE,LAE->LIA", t1b, Ub)
    Ba = einsum("ie,Lbe->Lib", t1a, Ua)
    Bb = einsum("IE,LBE->LIB", t1b, Ub)
    vvvo = lsum(ST({
        "aaaa": (einsum("Lia,Ljb->ijab", Aa, La)
                 - einsum("Lja,Lib->ijab", La, Ba)),
        "bbbb": (einsum("LIA,LJB->IJAB", Ab, Lb)
                 - einsum("LJA,LIB->IJAB", Lb, Bb)),
        "abab": einsum("Lia,LJB->iJaB", Aa, Lb),
        "baab": -einsum("Lja,LIB->IjaB", La, Bb),
        "abba": -einsum("LJA,Lib->iJAb", Lb, Ba),
        "baba": einsum("LIA,Ljb->IjAb", Ab, La),
    }))
    t2_hi = t2_hi + asym(vvvo, 0, 1)
    return Fae_hi, Wmbej_hi, t1_hi, t2_hi


# ---------------------------------------------------------------------------
# the update: Stanton-Gauss-Watts-Bartlett Eqs. (1)-(13), spin-traced
# ---------------------------------------------------------------------------

def update_amps(t1, t2, eris: UERIs, level_shift=0.0, ntile=4):
    """One Jacobi sweep of the spin-orbital CCSD equations over blocks;
    each seinsum call is that equation's spin-orbital contraction, traced
    over (alpha, beta)."""
    na, nb = _nocc(eris)
    ea, eb = eris.mo_energy
    mo_ea_o, mo_ea_v = ea[:na], ea[na:] + level_shift
    mo_eb_o, mo_eb_v = eb[:nb], eb[nb:] + level_shift

    T1 = t1_st(t1)
    T2 = t2_st(t2)
    fov = ST({"aa": eris.focka[:na, na:], "bb": eris.fockb[:nb, nb:]})
    foo_nd = ST({"aa": eris.focka[:na, :na] - torch.diag(mo_ea_o),
                 "bb": eris.fockb[:nb, :nb] - torch.diag(mo_eb_o)})
    fvv_nd = ST({"aa": eris.focka[na:, na:] - torch.diag(mo_ea_v),
                 "bb": eris.fockb[nb:, nb:] - torch.diag(mo_eb_v)})

    g_oovv = _g_oovv(eris)
    g_ooov = _g_ooov(eris)
    g_oooo = _g_oooo(eris)
    g_ovvo = _g_ovvo(eris)
    g_ovov = -1.0 * g_ovvo.transpose((0, 1, 3, 2))   # <na||if> = -<na||fi>
    g_ovoo = g_ooov.transpose((2, 3, 0, 1))          # <mb||ij> = <ij||mb>
    g_oovo = -1.0 * g_ooov.transpose((0, 1, 3, 2))   # <mn||ej> = -<mn||je>

    x = seinsum("ia,jb->ijab", T1, T1)
    tau1 = x - x.transpose((0, 1, 3, 2))
    tau_t = T2 + 0.5 * tau1
    tau = T2 + tau1

    # high-virtual (ovvv/vvvv/vvvo) term groups, factorized or materialized
    if eris.Lvv_a is not None:
        Fae_hi, Wmbej_hi, t1_hi, t2_hi = _high_virtual_df(
            eris, t1, T1, T2, tau, g_oovv, _g_oovv_dir(eris), ntile)
    else:
        Fae_hi, Wmbej_hi, t1_hi, t2_hi = _high_virtual_materialized(
            eris, T1, T2, tau, g_oovv)

    # SG Eqs. (3)-(5): one-particle intermediates
    Fae = (fvv_nd - 0.5 * seinsum("me,ma->ae", fov, T1)
           + Fae_hi - 0.5 * seinsum("mnaf,mnef->ae", tau_t, g_oovv))
    Fmi = (foo_nd + 0.5 * seinsum("ie,me->mi", T1, fov)
           + seinsum("ne,mnie->mi", T1, g_ooov)
           + 0.5 * seinsum("inef,mnef->mi", tau_t, g_oovv))
    Fme = fov + seinsum("nf,mnef->me", T1, g_oovv)

    # SG Eqs. (6), (8): two-particle intermediates
    Wmnij = (g_oooo + asym(seinsum("je,mnie->mnij", T1, g_ooov), 2, 3)
             + 0.25 * seinsum("ijef,mnef->mnij", tau, g_oovv))
    jnfb = 0.5 * T2 + seinsum("jf,nb->jnfb", T1, T1)
    Wmbej = (g_ovvo + Wmbej_hi
             - seinsum("nb,mnej->mbej", T1, g_oovo)
             - seinsum("jnfb,mnef->mbej", jnfb, g_oovv))

    # SG Eq. (1): T1
    t1new = (fov + t1_hi
             + seinsum("ie,ae->ia", T1, Fae)
             - seinsum("ma,mi->ia", T1, Fmi)
             + seinsum("imae,me->ia", T2, Fme)
             - seinsum("nf,naif->ia", T1, g_ovov)
             - 0.5 * seinsum("mnae,nmei->ia", T2, g_oovo))

    # SG Eq. (2): T2
    FaeT = Fae - 0.5 * seinsum("mb,me->be", T1, Fme)
    FmiT = Fmi + 0.5 * seinsum("je,me->mj", T1, Fme)
    ring = (seinsum("imae,mbej->ijab", T2, Wmbej)
            - seinsum("ie,ma,mbej->ijab", T1, T1, g_ovvo))
    t2new = (g_oovv + t2_hi
             + asym(seinsum("ijae,be->ijab", T2, FaeT), 2, 3)
             - asym(seinsum("imab,mj->ijab", T2, FmiT), 0, 1)
             + 0.5 * seinsum("mnab,mnij->ijab", tau, Wmnij)
             + asym(asym(ring, 2, 3), 0, 1)
             - asym(seinsum("ma,mbij->ijab", T1, g_ovoo), 2, 3))

    # denominators
    eia_a = mo_ea_o[:, None] - mo_ea_v[None, :]
    eia_b = mo_eb_o[:, None] - mo_eb_v[None, :]
    daa, dab, dbb = _d2(eia_a, eia_b)
    return ((t1new["aa"] / eia_a, t1new["bb"] / eia_b),
            (t2new["aaaa"] / daa, t2new["abab"] / dab,
             t2new["bbbb"] / dbb))


def amplitudes_to_vector(t1, t2):
    return torch.cat([x.reshape(-1) for x in (*t1, *t2)])


def vector_to_amplitudes(vec, shapes):
    """((t1a, t1b), (t2aa, t2ab, t2bb)) views of a flat vector."""
    outs = []
    p = 0
    for s in shapes:
        n = int(np.prod(s))
        outs.append(vec[p:p + n].view(s))
        p += n
    return tuple(outs[:2]), tuple(outs[2:])


def kernel(eris: UERIs, max_cycle=50, conv_tol=1e-8, conv_tol_normt=1e-6,
           diis_space=6, verbose=0, t1=None, t2=None, level_shift=0.0,
           ntile=4, diis_backend="host"):
    """DIIS-accelerated UCCSD iteration.  Returns (converged, e, t1, t2).

    diis_backend='host': the host ``lib.diis.DIIS`` ring (the five blocks
    copied to the host and back every cycle); 'device': the ring on the
    device (lib/device_diis.update_hostsolve, only the Gram matrix crosses
    to the host), the error the step vec_new - vec_old."""
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    if diis_backend not in ("host", "device"):
        raise ValueError(f"unknown diis_backend {diis_backend!r}")
    log = lg.Logger(verbose=verbose)
    emp2, t1_0, t2_0 = init_amps(eris)
    t1 = t1_0 if t1 is None else tuple(t1)
    t2 = t2_0 if t2 is None else tuple(t2)
    shapes = [x.shape for x in (*t1, *t2)]
    dev, dt = t2[1].device, t2[1].dtype
    log.info("UCCSD MP2 init E_corr = %.14f", float(emp2))
    if diis_backend == "device":
        from pyscf_mpcc_tpu_torch.lib import device_diis
        dstate = device_diis.init(sum(int(np.prod(s)) for s in shapes),
                                  diis_space, dt, device=dev)
        vec_old = amplitudes_to_vector(t1, t2)
    else:
        diis = DIIS(space=diis_space)
    e_last = float(energy(t1, t2, eris))
    converged = False
    e = e_last
    for it in range(max_cycle):
        t1new, t2new = update_amps(t1, t2, eris, level_shift, ntile=ntile)
        normt = sum(float(torch.linalg.norm(a - b))
                    for a, b in zip((*t1new, *t2new), (*t1, *t2)))
        del t1, t2
        vec_new = amplitudes_to_vector(t1new, t2new)
        del t1new, t2new
        if diis_backend == "device":
            dstate, vec = device_diis.update_hostsolve(dstate, vec_new,
                                                       vec_new - vec_old)
            vec_old = vec
        else:
            vec = torch.from_numpy(
                diis.update(vec_new.cpu().numpy())).to(dev, dt)
        del vec_new
        t1, t2 = vector_to_amplitudes(vec, shapes)
        e = float(energy(t1, t2, eris))
        log.info("cycle %2d  E_corr(UCCSD) = %.14f  dE = %10.3e  "
                 "|dt| = %9.3e", it, e, e - e_last, normt)
        if abs(e - e_last) < conv_tol and normt < conv_tol_normt:
            converged = True
            break
        e_last = e
    return converged, e, t1, t2


def to_spin_orbital(t1, t2, nocc):
    """Blocked amplitudes as spin-orbital tensors on their device, in the
    gccsd_slow ordering [occ_a, occ_b] x [vir_a, vir_b]."""
    t1a, t1b = t1
    t2aa, t2ab, t2bb = t2
    na, nb = nocc
    va = t1a.shape[1]
    vb = t1b.shape[1]
    no = na + nb
    nv = va + vb
    kw = dict(dtype=t1a.dtype, device=t1a.device)
    T1 = torch.zeros((no, nv), **kw)
    T1[:na, :va] = t1a
    T1[na:, va:] = t1b
    T2 = torch.zeros((no, no, nv, nv), **kw)
    T2[:na, :na, :va, :va] = t2aa
    T2[na:, na:, va:, va:] = t2bb
    T2[:na, na:, :va, va:] = t2ab
    T2[na:, :na, va:, :va] = t2ab.permute(1, 0, 3, 2)
    T2[:na, na:, va:, :va] = -t2ab.permute(0, 1, 3, 2)
    T2[na:, :na, :va, va:] = -t2ab.permute(1, 0, 2, 3)
    return T1, T2
