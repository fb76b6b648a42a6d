"""HDF5 checkpoint save/load of nested dict/array payloads.

A host copy of ``pyscf_mpcc_tpu/lib/chkfile.py`` with the same on-disk
format, so a chk file written by either package loads in the other
(tests/test_torch_host_layers.py).  Arrays are datasets, nested dicts
groups, sequences groups flagged ``__seq__``.  Payloads are numpy arrays:
callers move tensors to the host first.  h5py is imported at first use,
not with the module, since the card's machine may not have it.
"""

from __future__ import annotations

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise RuntimeError("h5py unavailable") from exc
    return h5py


def save(path, key, value):
    """Save a (possibly nested-dict) value under ``key``."""
    with _h5py().File(path, "a") as f:
        if key in f:
            del f[key]
        _write(f, key, value)


def _write(grp, key, value):
    if isinstance(value, dict):
        sub = grp.create_group(key)
        for k, v in value.items():
            _write(sub, k, v)
    elif isinstance(value, (list, tuple)):
        sub = grp.create_group(key)
        sub.attrs["__seq__"] = True
        for i, v in enumerate(value):
            _write(sub, f"{i:08d}", v)
    else:
        grp[key] = np.asarray(value)


def load(path, key):
    with _h5py().File(path, "r") as f:
        return _read(f[key])


def _read(node):
    if isinstance(node, _h5py().Group):
        if node.attrs.get("__seq__", False):
            return [_read(node[k]) for k in sorted(node.keys())]
        return {k: _read(node[k]) for k in node.keys()}
    return node[()]


def dump_cc(path, e_corr, t1, t2, mo_coeff=None, key="ccsd"):
    """CCSD checkpoint payload (e_corr, t1, t2, mo_coeff)."""
    payload = {"e_corr": np.asarray(e_corr),
               "t1": np.asarray(t1), "t2": np.asarray(t2)}
    if mo_coeff is not None:
        payload["mo_coeff"] = np.asarray(mo_coeff)
    save(path, key, payload)


def load_cc(path, key="ccsd"):
    return load(path, key)
