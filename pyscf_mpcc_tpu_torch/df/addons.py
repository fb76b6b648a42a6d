"""Auxiliary basis helpers: even-tempered automatic generation.

Role of the reference's df/addons.py aug_etb (:162): when no optimized
fitting basis exists for an element, generate an even-tempered set that
spans the products of the orbital basis — exponents from 2*e_min to
2*e_max per angular momentum up to 2*l_max(occupied-ish), progression
``beta``.
"""

from __future__ import annotations

import numpy as np

ETB_BETA = 2.0


def aug_etb_for_element(shells, beta=ETB_BETA):
    """Even-tempered aux shells for one element's orbital shells.

    shells: list of (l, exps array).  Returns [[l, [e, 1.0]], ...].
    """
    lmax = max(l for l, _ in shells)
    emin = {}
    emax = {}
    for l, es in shells:
        emin[l] = min(emin.get(l, np.inf), float(np.min(es)))
        emax[l] = max(emax.get(l, 0.0), float(np.max(es)))
    out = []
    for l_aux in range(2 * lmax + 1):
        # product of two shells with l1 + l2 >= l_aux contributes
        lo = min(emin[l1] + emin[l2]
                 for l1 in emin for l2 in emin if l1 + l2 >= l_aux)
        hi = max(emax[l1] + emax[l2]
                 for l1 in emax for l2 in emax if l1 + l2 >= l_aux)
        ns = max(1, int(np.ceil(np.log(hi / lo) / np.log(beta))) + 1)
        es = lo * beta ** np.arange(ns)
        for e in es:
            out.append([l_aux, [float(e), 1.0]])
    return out


def aug_etb(mol, beta=ETB_BETA):
    """Auto-generated even-tempered auxiliary basis dict for a Mole."""
    per_elem = {}
    for sh, sym in ((s, mol.symbols[s.atom_id]) for s in mol.shells):
        per_elem.setdefault(sym, []).append((sh.l, sh.exps))
    return {sym: aug_etb_for_element(shs, beta)
            for sym, shs in per_elem.items()}
