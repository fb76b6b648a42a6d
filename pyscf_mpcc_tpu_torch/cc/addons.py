"""Amplitude-representation converters (reference cc/addons.py role).

spatial2spin / spin2spatial between closed-shell (RCCSD) amplitudes and
spin-orbital (GCCSD) amplitudes in the [occ_a, occ_b, vir_a, vir_b]
ordering of cc.gccsd_slow.build_eris.

A host copy of the JAX package's cc/addons.py (NumPy, its imports pointed at
the port).
"""

from __future__ import annotations

import numpy as np


def spatial2spin_t1(t1):
    """Restricted t1 (o, v) -> spin-orbital t1 (2o, 2v)."""
    t1 = np.asarray(t1)
    no, nv = t1.shape
    out = np.zeros((2 * no, 2 * nv), t1.dtype)
    out[:no, :nv] = t1
    out[no:, nv:] = t1
    return out


def spatial2spin_t2(t2):
    """Restricted t2[i,j,a,b] -> antisymmetrized spin-orbital t2."""
    t2 = np.asarray(t2)
    no, _, nv, _ = t2.shape
    out = np.zeros((2 * no, 2 * no, 2 * nv, 2 * nv), t2.dtype)
    out[:no, no:, :nv, nv:] = t2
    out[no:, :no, nv:, :nv] = t2
    out[:no, no:, nv:, :nv] = -t2.transpose(0, 1, 3, 2)
    out[no:, :no, :nv, nv:] = -t2.transpose(0, 1, 3, 2)
    taa = t2 - t2.transpose(0, 1, 3, 2)
    out[:no, :no, :nv, :nv] = taa
    out[no:, no:, nv:, nv:] = taa
    return out


def spin2spatial_t1(t1g, no, nv):
    """Spin-orbital t1 -> the alpha spatial block (== beta for RHF)."""
    return np.asarray(t1g)[:no, :nv]


def spin2spatial_t2(t2g, no, nv):
    """Spin-orbital t2 -> the restricted t2[i,j,a,b] (the ab block)."""
    return np.asarray(t2g)[:no, no:, :nv, nv:]
