"""Active-space iterative T3 from t1-dressed DF factors.

Port of ``pyscf_mpcc_tpu/cc/ccsdt_act.py`` (the role of the fork's
pyscf/cc/umpcc_t_slow.py:448 make_intermediates, :699 get_vvvv_to_imds,
:1831 iterative_update_amps_t3):

*   t1 enters only through the similarity transform of the 3-center DF
    factors, Bt = Uc @ B @ Ua^T per spin; every dressed antisymmetrized
    block <pq||rs>~ is two GEMMs over Bt slices, made on demand for the
    index ranges one term needs.
*   The T3 equations are the t1-free spin-orbital einsum strings of the
    JAX package's oracle (gccsdt_slow.t3_residual / feedback), traced over
    spin blocks by spinsum.seinsum.
*   Every t3-bound index is active, so every operand carrying one is
    sliced to the active ranges before it is contracted.

Where the JAX code hands a three-operand string to ``jnp.einsum`` (which
picks a contraction order), the port contracts it as two pairs in a cheap
order: ``torch.einsum`` goes left to right unless opt_einsum is installed.
The index tensors of the active ranges are made once per ``DressedDF`` on
its device, and every array takes the dtype and device of its inputs.

models: 'ccsdt', 'ccsdt-3', 'ccsdt-1' as in the oracle.
"""

from __future__ import annotations

from itertools import permutations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.cc.spinsum import ST, seinsum, t2_st

einsum = torch.einsum

MODELS = ("ccsdt", "ccsdt-3", "ccsdt-1")

T3_CANONICAL = ("aaaaaa", "aabaab", "abbabb", "bbbbbb")


def _parity(perm):
    p = 1
    perm = list(perm)
    for x in range(len(perm)):
        for y in range(x + 1, len(perm)):
            if perm[x] > perm[y]:
                p = -p
    return p


# ---------------------------------------------------------------------------
# spin-blocked 6-index amplitudes
# ---------------------------------------------------------------------------

def expand_t3(blocks):
    """Canonical t3 block dict -> ST carrying every conserving signature
    (the permuted signatures follow from the (ijk)x(abc) antisymmetry of
    the underlying spin-orbital amplitude; they are permuted views)."""
    out = {}
    for sig, arr in blocks.items():
        if arr is None:
            continue
        for ph in permutations(range(3)):
            for pp in permutations(range(3)):
                nsig = ("".join(sig[i] for i in ph)
                        + "".join(sig[3 + i] for i in pp))
                if nsig in out:
                    continue
                s = _parity(ph) * _parity(pp)
                perm = tuple(ph) + tuple(3 + i for i in pp)
                out[nsig] = s * arr.permute(*perm)
    return ST(out)


def reduce_t3(x: ST):
    return {k: x.get(k) for k in T3_CANONICAL if x.get(k) is not None}


def _st_perm(x: ST, perm, sign=1.0):
    return ST({("".join(k[p] for p in perm)): sign * v.permute(*perm)
               for k, v in x.b.items()})


def st_a36(x: ST):
    """Full antisymmetrizer over (ijk) x (abc) for 6-index STs."""
    out = None
    for ph in permutations(range(3)):
        for pp in permutations(range(3)):
            s = _parity(ph) * _parity(pp)
            perm = tuple(ph) + tuple(3 + i for i in pp)
            t = _st_perm(x, perm, s)
            out = t if out is None else out + t
    return out


def st_p_hole(x: ST):
    return (x + _st_perm(x, (1, 0, 2, 3, 4, 5), -1.0)
            + _st_perm(x, (2, 1, 0, 3, 4, 5), -1.0))


def st_p_part(x: ST):
    return (x + _st_perm(x, (0, 1, 2, 4, 3, 5), -1.0)
            + _st_perm(x, (0, 1, 2, 5, 4, 3), -1.0))


# ---------------------------------------------------------------------------
# dressed DF integral factory
# ---------------------------------------------------------------------------

class DressedDF:
    """Index metadata of the dressed-DF integral factory.

    nocc: (nocca, noccb); nmo: (nmoa, nmob); act_hole/act_particle:
    per-spin active index arrays (occupied / virtual counting).  The
    arrays (dressed 3-center factors and dressed Fock) are built by
    :func:`dress_df` and passed to each call.  The active index tensors
    live on ``device``, made once here: the factory slices with them many
    times a sweep."""

    def __init__(self, nocc, nmo, act_hole, act_particle, *, device):
        self.nocc = tuple(int(x) for x in nocc)
        self.nmo = tuple(int(x) for x in nmo)
        self.act_hole = tuple(np.asarray(x, int) for x in act_hole)
        self.act_particle = tuple(np.asarray(x, int) for x in act_particle)
        self.device = torch.device(device)

        def idx(a):
            return torch.as_tensor(a, dtype=torch.long, device=self.device)

        self._hole = tuple(idx(a) for a in self.act_hole)
        self._part = tuple(idx(a) for a in self.act_particle)
        # active particles as indices into the MO dimension
        self._part_mo = tuple(idx(no + a) for no, a in
                              zip(self.nocc, self.act_particle))

    def index(self, kind, s):
        """The active index tensor of spin s: 'H' holes, 'P' particles
        (virtual counting)."""
        return self._hole[s] if kind == "H" else self._part[s]

    def _axis(self, x, ax, kind, s):
        """x sliced along axis ax of the MO dimension: 'h' full hole, 'H'
        active hole, 'p' full particle, 'P' active particle."""
        no = self.nocc[s]
        if kind == "h":
            return x.narrow(ax, 0, no)
        if kind == "p":
            return x.narrow(ax, no, self.nmo[s] - no)
        if kind == "H":
            return x.index_select(ax, self._hole[s])
        if kind == "P":
            return x.index_select(ax, self._part_mo[s])
        raise KeyError(kind)

    def _b(self, arrs, s, k1, k2):
        Bt = arrs["Bta" if s == 0 else "Btb"]
        return self._axis(self._axis(Bt, 1, k1, s), 2, k2, s)

    def g(self, arrs, spec):
        """Antisymmetrized dressed block <pq||rs>~ as an ST over all
        conserving spin signatures.  spec: 4 chars of h/H/p/P (physicists'
        order: p,q creation; r,s annihilation).
        <pq||rs>~ = (pr|qs)~ - (ps|qr)~ with (xy|zw)~ = Bt[L,x,y]Bt[L,z,w].
        """
        blocks = {}
        for sp in "ab":
            for sq in "ab":
                for sr in "ab":
                    for ss in "ab":
                        direct = (sp == sr) and (sq == ss)
                        exch = (sp == ss) and (sq == sr)
                        if not (direct or exch):
                            continue
                        val = None
                        if direct:
                            val = einsum(
                                "Lpr,Lqs->pqrs",
                                self._b(arrs, "ab".index(sp), spec[0],
                                        spec[2]),
                                self._b(arrs, "ab".index(sq), spec[1],
                                        spec[3]))
                        if exch:
                            e = einsum(
                                "Lps,Lqr->pqrs",
                                self._b(arrs, "ab".index(sp), spec[0],
                                        spec[3]),
                                self._b(arrs, "ab".index(sq), spec[1],
                                        spec[2]))
                            val = -e if val is None else val - e
                        blocks[sp + sq + sr + ss] = val
        return ST(blocks)

    def f(self, arrs, spec):
        """Dressed-Fock block ST ('aa'/'bb') for a 2-char range spec."""
        out = {}
        for s, sig in ((0, "aa"), (1, "bb")):
            fk = arrs["fa" if s == 0 else "fb"]
            out[sig] = self._axis(self._axis(fk, 0, spec[0], s), 1,
                                  spec[1], s)
        return ST(out)

    def take(self, x: ST, kinds):
        """Slice an ST's axes: '.' keep, 'H'/'P' slice to active."""
        out = {}
        for sig, arr in x.b.items():
            a = arr
            for ax, k in enumerate(kinds):
                if k != ".":
                    a = a.index_select(ax, self.index(k, "ab".index(sig[ax])))
            out[sig] = a
        return ST(out)


def dress_df(B, h, t1, nocc):
    """t1-dressed arrays: {'Bta','Btb','fa','fb'}.

    B: per-spin 3-center MO factors (naux, nmo, nmo) in chemists'
    (creation, annihilation) axis order; h: per-spin one-electron MO
    integrals; t1: (t1a, t1b), all tensors on one device.  Bt = Uc B Ua^T
    exactly eliminates t1 (gccsdt_slow.dress over DF factors); the
    dressed Fock adds the Coulomb/exchange closure over both spins'
    occupied blocks."""
    out = {}
    Bt = []
    ht = []
    for s in (0, 1):
        no = nocc[s]
        nmo = B[s].shape[1]
        t1s = t1[s]
        eye = torch.eye(nmo, dtype=B[s].dtype, device=B[s].device)
        Uc = eye.clone()
        Uc[no:, :no] -= t1s.T
        Ua = eye
        Ua[:no, no:] += t1s
        Bt.append(torch.matmul(torch.matmul(Uc, B[s]), Ua.T))
        ht.append(Uc @ h[s] @ Ua.T)
    j = [torch.diagonal(Bt[s][:, :nocc[s], :nocc[s]], dim1=1,
                        dim2=2).sum(-1) for s in (0, 1)]
    jtot = j[0] + j[1]
    for s in (0, 1):
        no = nocc[s]
        f = ht[s] + einsum("Lpq,L->pq", Bt[s], jtot)
        f = f - einsum("Lpj,Ljq->pq", Bt[s][:, :, :no], Bt[s][:, :no, :])
        out["fa" if s == 0 else "fb"] = f
    out["Bta"], out["Btb"] = Bt
    return out


# ---------------------------------------------------------------------------
# the T3 residual over active blocks (oracle einsum strings, sliced)
# ---------------------------------------------------------------------------

def t3_residual_act(t2: ST, t3, dd: DressedDF, arrs, model="ccsdt",
                    driving="full"):
    """Active-block T3 residual; the einsum strings are those of
    gccsdt_slow.t3_residual (oracle-locked), each operand sliced to the
    ranges its indices take when the output (ijkabc) is all-active.

    driving: 'full' (linear + quadratic t2 terms), 'linear', or 'none'
    (only the [H, T3] couplings, the part that varies per sweep)."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; one of {MODELS}")
    r3 = None
    if driving != "none":
        t2_HHPp = dd.take(t2, "HHP.")
        t2_HhPP = dd.take(t2, "H.PP")
        # x = t2[jkae] <bc||ei>~  -  t2[imbc] <ma||jk>~
        x = seinsum("jkae,bcei->ijkabc", t2_HHPp, dd.g(arrs, "PPpH"))
        x = x - seinsum("imbc,majk->ijkabc", t2_HhPP, dd.g(arrs, "hPHH"))
        r3 = st_p_hole(st_p_part(x))
        if driving == "full":
            t2_HhPp = dd.take(t2, "H.P.")
            t2_hHPP = dd.take(t2, ".HPP")
            g_hhHp = dd.g(arrs, "hhHp")
            g_hPpp = dd.g(arrs, "hPpp")
            # each three-operand string as two pairs
            # mnab,mnie,jkce: (mnab,mnie->abie),(abie,jkce)
            q = -0.125 * seinsum(
                "abie,jkce->ijkabc",
                seinsum("mnab,mnie->abie", dd.take(t2, "..PP"), g_hhHp),
                t2_HHPp)
            # jmae,mnie,nkbc: (jmae,mnie->jani),(jani,nkbc)
            q = q + -0.5 * seinsum(
                "jani,nkbc->ijkabc",
                seinsum("jmae,mnie->jani", t2_HhPp, g_hhHp), t2_hHPP)
            # jkef,maef,mibc: (jkef,maef->jkma),(jkma,mibc)
            q = q + 0.125 * seinsum(
                "jkma,mibc->ijkabc",
                seinsum("jkef,maef->jkma", dd.take(t2, "HH.."), g_hPpp),
                t2_hHPP)
            # imbe,maef,jkcf: (imbe,maef->ibaf),(ibaf,jkcf)
            q = q + 0.5 * seinsum(
                "ibaf,jkcf->ijkabc",
                seinsum("imbe,maef->ibaf", t2_HhPp, g_hPpp), t2_HHPp)
            # imbc,me,jkae: (imbc,me->ibce),(ibce,jkae)
            q = q + 0.25 * seinsum(
                "ibce,jkae->ijkabc",
                seinsum("imbc,me->ibce", t2_HhPP, dd.f(arrs, "hp")),
                t2_HHPp)
            r3 = r3 + st_a36(q)

    if t3 is None:
        return r3

    # ---- [H, T3] couplings (all bound indices active) ----------------------
    y = (1.0 / 12.0) * seinsum("ijkabe,ce->ijkabc", t3, dd.f(arrs, "PP"))
    y = y - (1.0 / 12.0) * seinsum("mjkabc,mi->ijkabc", t3,
                                   dd.f(arrs, "HH"))
    if model in ("ccsdt", "ccsdt-3"):
        y = y + (1.0 / 24.0) * seinsum("mnkabc,mnij->ijkabc", t3,
                                       dd.g(arrs, "HHHH"))
        y = y + (1.0 / 24.0) * seinsum("ijkaef,bcef->ijkabc", t3,
                                       dd.g(arrs, "PPPP"))
        y = y + 0.25 * seinsum("mjkebc,maei->ijkabc", t3,
                               dd.g(arrs, "HPPH"))
    if model == "ccsdt":
        # mnab,mnef,ijkcef: (mnab,mnef->abef),(abef,ijkcef)
        y = y + (1.0 / 48.0) * seinsum(
            "abef,ijkcef->ijkabc",
            seinsum("mnab,mnef->abef", dd.take(t2, "..PP"),
                    dd.g(arrs, "hhPP")), t3)
        # ijef,mnef,mnkabc: (ijef,mnef->ijmn),(ijmn,mnkabc)
        y = y + (1.0 / 48.0) * seinsum(
            "ijmn,mnkabc->ijkabc",
            seinsum("ijef,mnef->ijmn", dd.take(t2, "HH.."),
                    dd.g(arrs, "HHpp")), t3)
        # jmae,mnef,nikbcf: (jmae,mnef->janf),(janf,nikbcf)
        y = y + 0.25 * seinsum(
            "janf,nikbcf->ijkabc",
            seinsum("jmae,mnef->janf", dd.take(t2, "H.P."),
                    dd.g(arrs, "hHpP")), t3)
    ya = st_a36(y)
    return ya if r3 is None else r3 + ya


def _scatter_add(base, idx, val):
    """base[ix_(*idx)] += val, idx a tuple of 1-d index tensors."""
    n = len(idx)
    ix = tuple(x.view([-1 if a == ax else 1 for a in range(n)])
               for ax, x in enumerate(idx))
    return base.index_put_(ix, val, accumulate=True)


def feedback_act(t3: ST, dd: DressedDF, arrs):
    """T3 -> (R1, R2) additions in the dressed (t1-free) frame, scattered
    into full-shaped per-spin arrays (the active t3 feeds t2 elements with
    up to one inactive index).  Same einsum strings as
    gccsdt_slow.feedback; returns ((r1a, r1b), (r2aa, r2ab, r2bb))."""
    r1_act = 0.25 * seinsum("mnef,imnaef->ia", dd.g(arrs, "HHPP"), t3)
    y = seinsum("me,ijmabe->ijab", dd.f(arrs, "HP"), t3)
    # <bm||ef>~ with b free over the full particle range
    yb = seinsum("bmef,ijmaef->ijab", dd.g(arrs, "pHPP"), t3)
    # <mn||ej>~ with j free over the full hole range
    yj = seinsum("mnej,imnabe->ijab", dd.g(arrs, "HHPh"), t3)

    nocc, nmo = dd.nocc, dd.nmo
    like = arrs["fa"]
    kw = dict(dtype=like.dtype, device=like.device)
    r1 = []
    for s, sig in ((0, "aa"), (1, "bb")):
        no, nv = nocc[s], nmo[s] - nocc[s]
        base = torch.zeros((no, nv), **kw)
        if r1_act.get(sig) is not None:
            _scatter_add(base, (dd.index("H", s), dd.index("P", s)),
                         r1_act[sig])
        r1.append(base)

    full = {}

    def scatter(st, acts):
        for sig, arr in st.b.items():
            sp = ["ab".index(c) for c in sig]
            shape = (nocc[sp[0]], nocc[sp[1]],
                     nmo[sp[2]] - nocc[sp[2]], nmo[sp[3]] - nocc[sp[3]])
            idx = tuple(dd.index(acts[ax], sp[ax]) if acts[ax] != "."
                        else torch.arange(shape[ax], device=dd.device)
                        for ax in range(4))
            if sig not in full:
                full[sig] = torch.zeros(shape, **kw)
            _scatter_add(full[sig], idx, arr)

    scatter(y, "HHPP")
    scatter(yb, "HHP.")   # b free: full particle range
    scatter(yj, "H.PP")   # j free: full hole range
    yf = ST(full)
    yf = yf + _st_perm(yf, (1, 0, 2, 3), -1.0)
    yf = yf + _st_perm(yf, (0, 1, 3, 2), -1.0)
    r2 = ST({k: 0.25 * v for k, v in yf.b.items()})
    return ((r1[0], r1[1]),
            (r2.get("aaaa"), r2.get("abab"), r2.get("bbbb")))


# ---------------------------------------------------------------------------
# iterative active-T3 solver at fixed (t1, t2)
# ---------------------------------------------------------------------------

def d3_blocks(dd: DressedDF, mo_energy):
    """Bare-Fock active denominators per canonical signature, from the
    per-spin orbital energies (tensors on dd's device, in the working
    dtype)."""
    eo = [mo_energy[s][:dd.nocc[s]][dd.index("H", s)] for s in (0, 1)]
    ev = [mo_energy[s][dd.nocc[s]:][dd.index("P", s)] for s in (0, 1)]
    out = {}
    for sig in T3_CANONICAL:
        sh = ["ab".index(c) for c in sig[:3]]
        sv = ["ab".index(c) for c in sig[3:]]
        out[sig] = (eo[sh[0]][:, None, None, None, None, None]
                    + eo[sh[1]][None, :, None, None, None, None]
                    + eo[sh[2]][None, None, :, None, None, None]
                    - ev[sv[0]][None, None, None, :, None, None]
                    - ev[sv[1]][None, None, None, None, :, None]
                    - ev[sv[2]][None, None, None, None, None, :])
    return out


def mo_energy_like(mo_energy, like):
    """Per-spin orbital energies (arrays or tensors) as tensors in the
    dtype and on the device of ``like``: a float64 array met by a float32
    solve would otherwise promote it."""
    return tuple(torch.as_tensor(e, dtype=like.dtype, device=like.device)
                 for e in mo_energy)


def diis_blocks(diis, blocks, keys):
    """One host DIIS step over a dict of same-device blocks concatenated in
    ``keys`` order; returns the extrapolated blocks on that device."""
    like = blocks[keys[0]]
    vec = np.concatenate([b.detach().cpu().numpy().ravel()
                          for b in (blocks[k] for k in keys)])
    vec = torch.from_numpy(diis.update(vec)).to(like.device, like.dtype)
    out, p = {}, 0
    for k in keys:
        n = blocks[k].numel()
        out[k] = vec[p:p + n].view(blocks[k].shape)
        p += n
    return out


def solve_t3_act(t2_blocks, dd: DressedDF, arrs, mo_energy,
                 model="ccsdt-3", max_cycle=60, conv_tol=1e-8, verbose=0,
                 t3_init=None, diis_space=6):
    """Iteratively solve the active-block T3 at fixed (t1, t2).

    t2_blocks: (t2aa, t2ab, t2bb) in the frame matching arrs' dressing
    (the UCCSD amplitudes whose t1 built them).  The drive (the t2 terms)
    is computed once; each sweep adds only the [H, T3] couplings.
    Returns (t3_canonical dict, converged)."""
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    log = lg.Logger(verbose=verbose)
    t2st = t2_st(tuple(t2_blocks))
    d3 = d3_blocks(dd, mo_energy_like(mo_energy, arrs["fa"]))

    drive = reduce_t3(t3_residual_act(t2st, None, dd, arrs, model=model))
    canon = (dict(t3_init) if t3_init is not None
             else {k: torch.zeros_like(v) for k, v in drive.items()})
    keys = sorted(canon.keys())
    diis = DIIS(space=diis_space)
    converged = False
    for it in range(max_cycle):
        coup = reduce_t3(t3_residual_act(t2st, expand_t3(canon), dd, arrs,
                                         model=model, driving="none"))
        new = {}
        dn = 0.0
        for k in keys:
            r = drive[k]
            if coup.get(k) is not None:
                r = r + coup[k]
            new[k] = canon[k] + r / d3[k]
            dn += float(torch.linalg.norm(new[k] - canon[k]))
        canon = diis_blocks(diis, new, keys)
        log.info("t3-act cycle %2d  |dt3| = %9.3e", it, dn)
        if dn < conv_tol:
            converged = True
            break
    return canon, converged
