"""ctypes binding of the McMurchie-Davidson engine ``mdint.cpp``.

A frozen copy of the port's gto/native binding, cut to the integrals the
input maker needs: overlap, kinetic, nuclear attraction, and the two- and
three-centre Coulomb integrals of density fitting.

The library is built with g++ -O3 -march=native -fopenmp into
``ccbench/inputmaker/build/`` under a name keyed on the source, the flags
and the host CPU's model, so a checkout builds it once per kind of host and
never loads a build made for another CPU.  It is written under a temporary
name and renamed into place.  There is no slow fallback: a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from ccbench.inputmaker.mole import cart2sph

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "mdint.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared")

_lock = threading.Lock()
_lib = None


def _cpu_model():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def lib_path():
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update(_cpu_model().encode())
    return os.path.join(BUILD_DIR, f"libmdint-{h.hexdigest()[:16]}.so")


def get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(["g++", *FLAGS, SRC, "-o", tmp],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed on {SRC}:\n{proc.stderr}")
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        _lib = ctypes.CDLL(path)
        return _lib


def segment_shells(mol):
    """A Mole's shells as segmented (one contraction each) C arrays."""
    ls, nprims, prim_offs, exps, coefs, centers, ao_off = \
        [], [], [], [], [], [], []
    nao = 0
    per = (lambda l: (l + 1) * (l + 2) // 2) if mol.cart else (lambda l: 2 * l + 1)
    for sh in mol.shells:
        for c in range(sh.nctr):
            col = sh.coefs[:, c]
            keep = np.abs(col) > 0.0
            ls.append(sh.l)
            nprims.append(int(keep.sum()))
            prim_offs.append(len(exps))
            exps.extend(sh.exps[keep].tolist())
            coefs.extend(col[keep].tolist())
            centers.extend(sh.center.tolist())
            ao_off.append(nao)
            nao += per(sh.l)
    ao_off.append(nao)
    if nao != mol.nao:
        raise ValueError(f"segmented {nao} AOs, the molecule has {mol.nao}")
    return dict(
        l=np.array(ls, dtype=np.int32),
        nprim=np.array(nprims, dtype=np.int32),
        prim_off=np.array(prim_offs, dtype=np.int32),
        exps=np.array(exps, dtype=np.float64),
        coefs=np.array(coefs, dtype=np.float64),
        centers=np.array(centers, dtype=np.float64),
        ao_off=np.array(ao_off, dtype=np.int32),
        nsh=len(ls),
        nao=nao,
    )


def c2s_tables(lmax=6):
    mats = [cart2sph(l) for l in range(lmax + 1)]
    off = np.zeros(lmax + 1, dtype=np.int64)
    data = []
    pos = 0
    for l, m in enumerate(mats):
        off[l] = pos
        data.append(m.ravel())
        pos += m.size
    return np.concatenate(data), off


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _lp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _shell_args(s):
    return (_ip(s["l"]), _ip(s["nprim"]), _ip(s["prim_off"]), _dp(s["exps"]),
            _dp(s["coefs"]), _dp(s["centers"]), _ip(s["ao_off"]),
            ctypes.c_int(s["nsh"]))


def eri3c(mol, auxmol):
    """(mu nu|P), shape (nao, nao, naux)."""
    lib = get_lib()
    s = segment_shells(mol)
    x = segment_shells(auxmol)
    c2s, off = c2s_tables()
    out = np.zeros((s["nao"], s["nao"], x["nao"]))
    lib.md_eri3c(*_shell_args(s), *_shell_args(x), _dp(c2s), _lp(off),
                 ctypes.c_int(1 if mol.cart else 0), ctypes.c_int(s["nao"]),
                 ctypes.c_int(x["nao"]), _dp(out))
    return out


def eri2c(auxmol):
    """(P|Q), shape (naux, naux)."""
    lib = get_lib()
    x = segment_shells(auxmol)
    c2s, off = c2s_tables()
    out = np.zeros((x["nao"], x["nao"]))
    lib.md_eri2c(*_shell_args(x), _dp(c2s), _lp(off),
                 ctypes.c_int(1 if auxmol.cart else 0), ctypes.c_int(x["nao"]),
                 _dp(out))
    return out


def ovlp_kin(mol):
    """(S, T), each (nao, nao)."""
    lib = get_lib()
    s = segment_shells(mol)
    c2s, off = c2s_tables()
    S = np.zeros((s["nao"], s["nao"]))
    T = np.zeros((s["nao"], s["nao"]))
    lib.md_ovlp_kin(*_shell_args(s), _dp(c2s), _lp(off),
                    ctypes.c_int(1 if mol.cart else 0), ctypes.c_int(s["nao"]),
                    _dp(S), _dp(T))
    return S, T


def nuc(mol):
    """Nuclear attraction, (nao, nao)."""
    lib = get_lib()
    s = segment_shells(mol)
    c2s, off = c2s_tables()
    out = np.zeros((s["nao"], s["nao"]))
    coords = np.ascontiguousarray(mol.atom_coords(), dtype=np.float64)
    charges = np.ascontiguousarray(mol.atom_charges(), dtype=np.float64)
    lib.md_nuc(*_shell_args(s), _dp(coords), _dp(charges),
               ctypes.c_int(mol.natm), _dp(c2s), _lp(off),
               ctypes.c_int(1 if mol.cart else 0), ctypes.c_int(s["nao"]),
               _dp(out))
    return out
