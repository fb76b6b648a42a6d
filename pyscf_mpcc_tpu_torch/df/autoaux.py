"""AutoAux: automatic auxiliary basis generation (Stoychev et al.).

Implements the ORCA AutoAux algorithm — G. L. Stoychev, A. A. Auer,
F. Neese, J. Chem. Theory Comput. 13, 554 (2017) — generating an
even-tempered fitting basis that spans the orbital-product space.  Role
of the reference's df/autoaux.py:75 ``_auto_aux_element`` / :124
``autoaux`` (we always generate locally; there is no basis-set-exchange
dependency).

Per element and angular momentum l the orbital basis contributes
effective exponent ranges; products (l1, l2) cover auxiliary momenta
|l1-l2| <= L <= l1+l2, capped by the valence rule L_max; the exponent
grid is even-tempered with the published beta progression and the f_laux
cap on the steep end.
"""

from __future__ import annotations

from math import factorial

import numpy as np

from pyscf_mpcc_tpu_torch.gto.mole import gaussian_int

# published AutoAux parameters (table 1 of JCTC 13, 554)
F_LAUX = np.array([20.0, 7.0, 4.0, 4.0, 3.5, 2.5, 2.0, 2.0])
BETA_BIG = np.array([1.8, 2.0, 2.2, 2.2, 2.2, 2.3, 3.0, 3.0])
BETA_SMALL = 1.8


def _ranges_by_l(shells):
    """(emax, emin, e_eff) arrays over l for one element's shells.

    e_eff is the effective exponent of the *contracted* function from its
    radial expectation value <r> (eq 9 of the paper, with the corrected
    squared denominator): for a primitive it reduces to the exponent."""
    lmax = max(sh.l for sh in shells)
    emin = np.full(lmax + 1, np.inf)
    emax = np.zeros(lmax + 1)
    eeff = np.zeros(lmax + 1)
    for sh in shells:
        l, es, cs = sh.l, np.asarray(sh.exps), np.asarray(sh.coefs)
        emin[l] = min(emin[l], es.min())
        emax[l] = max(emax[l], es.max())
        ee = es[:, None] + es[None, :]
        r_ints = gaussian_int(2 * l + 3, ee)          # \int chi^2 r dr
        r_exp = np.einsum("pi,pq,qi->i", cs, r_ints, cs)
        k = 2 ** (2 * l + 1) * factorial(l + 1) ** 2 / factorial(2 * l + 2)
        e_eff = 2 * k ** 2 / (np.pi * r_exp ** 2) - 1e-8
        eeff[l] = max(eeff[l], e_eff.max())
    return emax, emin, eeff


def _auto_aux_element(Z, shells):
    """Even-tempered recipe [(l, n, e_min, beta), ...] for one element."""
    a_max_by_l, a_min_by_l, a_eff_by_l = _ranges_by_l(shells)
    a_min_prim = a_min_by_l[:, None] + a_min_by_l
    a_max_prim = a_max_by_l[:, None] + a_max_by_l
    a_max_aux = a_eff_by_l[:, None] + a_eff_by_l

    l_max1 = a_max_by_l.size
    l_max = l_max1 - 1
    if Z <= 2:
        l_val = 0
    elif Z <= 20:
        l_val = 1
    elif Z <= 56:
        l_val = 2
    else:
        l_val = 3
    l_inc = 2 if Z > 18 else 1
    l_max_aux = min(max(l_val * 2, l_max + l_inc), l_max * 2)

    lsum = np.arange(l_max1)[:, None] + np.arange(l_max1)
    lsub = abs(np.arange(l_max1)[:, None] - np.arange(l_max1))
    mins = [a_min_prim[(lsub <= L) & (L <= lsum)].min()
            for L in range(l_max_aux + 1)]
    maxs = [a_max_prim[(lsub <= L) & (L <= lsum)].max()
            for L in range(l_max_aux + 1)]
    effs = [a_max_aux[(lsub <= L) & (L <= lsum)].max()
            for L in range(l_max_aux + 1)]

    # steep-end cap: below 2*l_val use min(f_laux * e_eff, e_max)
    top = [min(F_LAUX[L] * effs[L], maxs[L])
           for L in range(min(l_val * 2, l_max_aux) + 1)]
    top = top + effs[l_val * 2 + 1: l_max_aux + 1]

    emin = np.asarray(mins)
    emax = np.asarray(top)
    etb = []
    n_small = min(l_val * 2, l_max_aux) + 1
    ns = np.log(emax[:n_small] / emin[:n_small]) / np.log(BETA_SMALL)
    for L, n in enumerate(np.ceil(ns).astype(int) + 1):
        if n > 0:
            etb.append((L, int(n), float(emin[L]), BETA_SMALL))
    if l_max_aux >= n_small:
        ns = (np.log(emax[n_small:] / emin[n_small:])
              / np.log(BETA_BIG[n_small:l_max_aux + 1]))
        for i, n in enumerate(np.ceil(ns).astype(int) + 1):
            L = i + n_small
            if n > 0:
                etb.append((L, int(n), float(emin[L]), float(BETA_BIG[L])))
    return etb


def expand_etbs(etb):
    """[(l, n, e0, beta), ...] -> uncontracted shell list
    [[l, [e, 1.0]], ...] with exponents e0 * beta**k, k = 0..n-1."""
    out = []
    for l, n, e0, beta in etb:
        for k in reversed(range(n)):
            out.append([l, [float(e0 * beta ** k), 1.0]])
    return out


def autoaux(mol):
    """AutoAux auxiliary basis dict {element: shell list} for a Mole."""
    per_elem = {}
    for sh in mol.shells:
        per_elem.setdefault(mol.symbols[sh.atom_id], []).append(sh)
    out = {}
    for sym, shs in per_elem.items():
        Z = int(mol.charges[mol.symbols.index(sym)])
        etb = _auto_aux_element(Z, shs)
        if not etb:
            raise RuntimeError(f"AutoAux failed for element {sym}")
        out[sym] = expand_etbs(etb)
    return out
