"""AVAS-style automated active-space selection.

Role of the reference's pyscf/mcscf/avas.py as consumed by the MP-CC
workflow (examples/cc/44-mpcc/n2_rohf_umpccsd.py): pick active occupied /
virtual orbitals by their overlap with a target AO subspace.

Clean-room variant: the target subspace is spanned by computational-basis
AOs selected by label substring (e.g. 'N 2p' -> all p functions on N
atoms); for each MO the projection weight onto that subspace (Lowdin-
orthogonalized) is computed, and orbitals above ``threshold`` enter the
active space.  Returns index arrays relative to the occupied / virtual
blocks, the form the MPCC masks consume.

A host copy of the JAX package's lo/avas.py (NumPy and the port's gto).
"""

from __future__ import annotations

import numpy as np


def _ao_indices_by_label(mol, patterns):
    labels = mol.ao_labels()
    out = []
    for i, lab in enumerate(labels):
        if any(p in lab for p in patterns):
            out.append(i)
    return np.asarray(out, dtype=int)


def avas(mol, ao_patterns, mo_coeff, mo_occ, threshold=0.2, S=None):
    """Select active holes/particles by projection onto an AO subspace.

    ao_patterns: list of substrings matched against mol.ao_labels()
                 (labels look like "1 O p m=0").
    Returns (act_hole, act_particle, weights): indices into the occupied
    block / virtual block respectively.
    """
    from pyscf_mpcc_tpu_torch import gto as _gto
    if S is None:
        S = _gto.intor_ovlp(mol)
    sub = _ao_indices_by_label(mol, ao_patterns)
    if len(sub) == 0:
        raise ValueError(f"No AOs match patterns {ao_patterns}")
    # projector onto the selected AO subspace: P = S[:,sub] S_sub^-1 S[sub,:]
    S_sub = S[np.ix_(sub, sub)]
    X = np.linalg.solve(S_sub, S[sub, :])
    # weight of MO i: c_i^T S[:,sub] S_sub^-1 S[sub,:] c_i
    W = mo_coeff.T @ S[:, sub] @ X @ mo_coeff
    w = np.diag(W)
    occ_idx = np.where(mo_occ > 0)[0]
    vir_idx = np.where(mo_occ == 0)[0]
    act_hole = np.where(w[occ_idx] > threshold)[0]
    act_particle = np.where(w[vir_idx] > threshold)[0]
    return act_hole, act_particle, w
