"""Orbital-optimized-MP2-like bath updates for unrestricted MP-CC.

Port of ``pyscf_mpcc_tpu/mpcc/oomp2.py``: the reference's four OO-MP2
update variants (pyscf/cc/umpccsd.py:76-92 select_update_amps_oomp2,
variants at :96/:493/:953/:1379) in the spin-traced language of
cc/uccsd.py.  The low-level operator is the CCSD update with the t2
dependence removed from the two-particle intermediates (tau in the
ladder/Wmnij quadratics is t1-only, Wmbej carries no t2 term) while the
Fock-closure terms keep full t2.  The variants put selected t2 couplings
back:

    variant      F-dressing   T1 [V,T2]    T2 extras     rings
    standard     -            -            -             -
    t2_fock      t2           t2           -             -
    t2_all       t2           t2           t2            -
    t2act        t2(active)   t2(active)   t2(active)    t2(active)

"F-dressing" is the tau~ contraction in Fae/Fmi, "T1 [V,T2]" the
t2.<ov||vv> / t2.<oo||vo> singles terms, "T2 extras" the t2.Wmnij and
ladder-dressing couplings, "rings" the t2.Wmbej contraction.  In the
MP-CC workflow this update relaxes the bath while the listed (active)
blocks are frozen at their incoming fragment-CC values.
"""

from __future__ import annotations

import torch

from pyscf_mpcc_tpu_torch.cc import uccsd as u
from pyscf_mpcc_tpu_torch.cc.spinsum import (ST, asym, seinsum, st_t2,
                                             t1_st, t2_st)

VARIANTS = ("standard", "t2_fock", "t2_all", "t2act")


def _zero_t2_like(t2):
    return tuple(torch.zeros_like(x) for x in t2)


def update_amps_oomp2(t1, t2, eris, variant="standard", act_masks=None,
                      level_shift=0.0, ntile=4):
    """One sweep of the selected OO-MP2 low-level operator.

    act_masks: (m2aa, m2ab, m2bb) boolean active-region masks (tensors on
    the amplitudes' device), required for variant='t2act'.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown oomp2 variant {variant!r}; "
                         f"one of {VARIANTS}")
    na, nb = u._nocc(eris)
    ea, eb = eris.mo_energy
    mo_ea_o, mo_ea_v = ea[:na], ea[na:] + level_shift
    mo_eb_o, mo_eb_v = eb[:nb], eb[nb:] + level_shift

    T1 = t1_st(t1)
    T2 = t2_st(t2)
    if variant == "standard":
        t2sel = _zero_t2_like(t2)
    elif variant == "t2act":
        t2sel = tuple(torch.where(m, x, 0.0) for m, x in zip(act_masks, t2))
    else:
        t2sel = t2
    T2sel = t2_st(t2sel)
    t2_doubles = T2sel if variant in ("t2_all", "t2act") else \
        t2_st(_zero_t2_like(t2))
    t2_rings = T2sel if variant == "t2act" else None

    fov = ST({"aa": eris.focka[:na, na:], "bb": eris.fockb[:nb, nb:]})
    foo_nd = ST({"aa": eris.focka[:na, :na] - torch.diag(mo_ea_o),
                 "bb": eris.fockb[:nb, :nb] - torch.diag(mo_eb_o)})
    fvv_nd = ST({"aa": eris.focka[na:, na:] - torch.diag(mo_ea_v),
                 "bb": eris.fockb[nb:, nb:] - torch.diag(mo_eb_v)})

    g_oovv = u._g_oovv(eris)
    g_ooov = u._g_ooov(eris)
    g_oooo = u._g_oooo(eris)
    g_ovvo = u._g_ovvo(eris)
    g_ovov = -1.0 * g_ovvo.transpose((0, 1, 3, 2))
    g_ovoo = g_ooov.transpose((2, 3, 0, 1))
    g_oovo = -1.0 * g_ooov.transpose((0, 1, 3, 2))

    x = seinsum("ia,jb->ijab", T1, T1)
    tau1 = x - x.transpose((0, 1, 3, 2))
    # dressing tau: t1-quadratic plus the variant's selected t2
    taud = T2sel + tau1 if variant in ("t2_all", "t2act") else \
        (T2sel * 0.0 + tau1 if variant == "standard" else tau1)
    if variant == "t2_fock":
        taud = tau1

    # high-virtual groups on the dressing tau; t1 term carries t2sel
    if eris.Lvv_a is not None:
        Fae_hi, Wmbej_hi, t1_hi, t2_hv = u._high_virtual_df(
            eris, t1, T1, T2sel, taud, g_oovv, u._g_oovv_dir(eris), ntile)
    else:
        Fae_hi, Wmbej_hi, t1_hi, t2_hv = u._high_virtual_materialized(
            eris, T1, T2sel, taud, g_oovv)
    # remove the W_abef quadratic (absent in the low-level operator) and
    # correct the bare-vvvv part from taud back to tau1
    Yanti = seinsum("ijef,mnef->mnij", taud, g_oovv)
    t2_hv = t2_hv - 0.125 * seinsum("mnab,mnij->ijab", taud, Yanti)
    extra = t2_doubles
    if eris.Lvv_a is not None:
        xaa, xab, xbb = st_t2(extra)
        t2_hv = t2_hv - ST({
            "aaaa": u._ladder_tiled(xaa, eris.Lvv_a, eris.Lvv_a, ntile),
            "abab": u._ladder_tiled(xab, eris.Lvv_a, eris.Lvv_b, ntile),
            "bbbb": u._ladder_tiled(xbb, eris.Lvv_b, eris.Lvv_b, ntile),
        })
    else:
        g_vvvv = u._g_vvvv(eris)
        t2_hv = t2_hv - 0.5 * seinsum("ijef,abef->ijab", extra, g_vvvv)

    # F intermediates: tau~ dressing with the selected t2
    taut_sel = T2sel + 0.5 * tau1
    Fae = (fvv_nd - 0.5 * seinsum("me,ma->ae", fov, T1) + Fae_hi
           - 0.5 * seinsum("mnaf,mnef->ae", taut_sel, g_oovv))
    Fmi = (foo_nd + 0.5 * seinsum("ie,me->mi", T1, fov)
           + seinsum("ne,mnie->mi", T1, g_ooov)
           + 0.5 * seinsum("inef,mnef->mi", taut_sel, g_oovv))
    Fme = fov + seinsum("nf,mnef->me", T1, g_oovv)

    # two-particle intermediates without t2 (the low-level operator)
    Wmnij = (g_oooo + asym(seinsum("je,mnie->mnij", T1, g_ooov), 2, 3)
             + 0.25 * seinsum("ijef,mnef->mnij", tau1, g_oovv))
    jnfb = seinsum("jf,nb->jnfb", T1, T1)
    Wmbej = (g_ovvo + Wmbej_hi
             - seinsum("nb,mnej->mbej", T1, g_oovo)
             - seinsum("jnfb,mnef->mbej", jnfb, g_oovv))

    # T1: CC-like singles; [V, T2] terms carry the selected t2
    t1new = (fov + t1_hi
             + seinsum("ie,ae->ia", T1, Fae)
             - seinsum("ma,mi->ia", T1, Fmi)
             + seinsum("imae,me->ia", T2, Fme)
             - seinsum("nf,naif->ia", T1, g_ovov)
             - 0.5 * seinsum("mnae,nmei->ia", T2sel, g_oovo))

    # T2: MP2-like doubles + variant extras
    FaeT = Fae - 0.5 * seinsum("mb,me->be", T1, Fme)
    FmiT = Fmi + 0.5 * seinsum("je,me->mj", T1, Fme)
    # ie,ma,mbej->ijab as two pairs: (ie,mbej->mbij), then (ma,mbij)
    ring = -1.0 * seinsum("ma,mbij->ijab", T1,
                          seinsum("ie,mbej->mbij", T1, g_ovvo))
    if t2_rings is not None:
        ring = ring + seinsum("imae,mbej->ijab", t2_rings, Wmbej)
    t2new = (g_oovv + t2_hv
             + asym(seinsum("ijae,be->ijab", T2, FaeT), 2, 3)
             - asym(seinsum("imab,mj->ijab", T2, FmiT), 0, 1)
             + 0.5 * seinsum("mnab,mnij->ijab", tau1 + t2_doubles, Wmnij)
             + asym(asym(ring, 2, 3), 0, 1)
             - asym(seinsum("ma,mbij->ijab", T1, g_ovoo), 2, 3))

    eia_a = mo_ea_o[:, None] - mo_ea_v[None, :]
    eia_b = mo_eb_o[:, None] - mo_eb_v[None, :]
    daa, dab, dbb = u._d2(eia_a, eia_b)
    return ((t1new["aa"] / eia_a, t1new["bb"] / eia_b),
            (t2new["aaaa"] / daa, t2new["abab"] / dab,
             t2new["bbbb"] / dbb))
