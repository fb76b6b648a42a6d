"""Active-space index machinery for the MP-CC hybrid.

The reference enumerates 4 singles and 16 doubles blocks as np.ix_ tuples
(pyscf/cc/umpccsd.py:42-74, rmpccsd_slow.py:39) and overwrites the selected
blocks after every update (umpccsd.py:2219-2235).  Here: the same block
enumeration as *boolean masks*, combined once into a single frozen-block
mask per amplitude tensor, applied with torch.where on the device
(mpcc/rmpccsd) — no 16-way fancy-indexing, no host round trips.

A host copy of the JAX package's mpcc/masks.py (NumPy only).

Block ordering matches the reference exactly (idx_s / idx_d integers are
user-facing API):

singles: 0 (act_h, inact_p), 1 (inact_h, act_p), 2 (inact_h, inact_p),
         3 (act_h, act_p)
doubles: virtual-pair groups in order (inact,act), (act,inact),
         (inact,inact), (act,act); hole pairs within the first three groups
         in order (act,act), (inact,act), (act,inact), (inact,inact), and in
         the last group (inact,act), (act,inact), (inact,inact), (act,act).
"""

from __future__ import annotations

import numpy as np


def _indicators(act, n):
    a = np.zeros(n, dtype=bool)
    a[np.asarray(act, dtype=int)] = True
    return a, ~a


def singles_blocks(act_hole, act_particle, nocc, nvir):
    """4 boolean masks (nocc, nvir) in the reference's ordering."""
    ah, ih = _indicators(act_hole, nocc)
    ap, ip = _indicators(act_particle, nvir)
    return [
        np.outer(ah, ip),
        np.outer(ih, ap),
        np.outer(ih, ip),
        np.outer(ah, ap),
    ]


def doubles_blocks(act_hole, act_particle, nocc, nvir,
                   act_hole2=None, act_particle2=None, nocc2=None, nvir2=None):
    """16 boolean masks (nocc, nocc2, nvir, nvir2), reference ordering.

    The second hole/particle spaces default to the first (restricted or
    same-spin); pass the beta spaces for the alpha-beta mixed block
    (umpccsd.py idx_d_ab construction)."""
    if act_hole2 is None:
        act_hole2, act_particle2 = act_hole, act_particle
        nocc2, nvir2 = nocc, nvir
    ah1, ih1 = _indicators(act_hole, nocc)
    ap1, ip1 = _indicators(act_particle, nvir)
    ah2, ih2 = _indicators(act_hole2, nocc2)
    ap2, ip2 = _indicators(act_particle2, nvir2)

    def blk(h1, h2, p1, p2):
        return (h1[:, None, None, None] & h2[None, :, None, None]
                & p1[None, None, :, None] & p2[None, None, None, :])

    hole_pairs_std = [(ah1, ah2), (ih1, ah2), (ah1, ih2), (ih1, ih2)]
    hole_pairs_last = [(ih1, ah2), (ah1, ih2), (ih1, ih2), (ah1, ah2)]
    part_groups = [(ip1, ap2), (ap1, ip2), (ip1, ip2), (ap1, ap2)]

    out = []
    for gi, (p1, p2) in enumerate(part_groups):
        pairs = hole_pairs_last if gi == 3 else hole_pairs_std
        for (h1, h2) in pairs:
            out.append(blk(h1, h2, p1, p2))
    return out


def frozen_masks(act_hole, act_particle, nocc, nvir, idx_s, idx_d):
    """Combined frozen-block masks (m1, m2) for restricted amplitudes."""
    s = singles_blocks(act_hole, act_particle, nocc, nvir)
    d = doubles_blocks(act_hole, act_particle, nocc, nvir)
    m1 = np.zeros((nocc, nvir), dtype=bool)
    for i in idx_s:
        m1 |= s[i]
    m2 = np.zeros((nocc, nocc, nvir, nvir), dtype=bool)
    for i in idx_d:
        m2 |= d[i]
    return m1, m2
