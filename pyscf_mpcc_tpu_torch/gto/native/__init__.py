"""ctypes binding for the native McMurchie-Davidson engine (mdint.cpp).

Builds the shared library on demand with g++ -O3 -fopenmp into
``build/native/`` at the root of the checkout (written under a temporary
name and renamed into place, so parallel processes cannot load a half
written file).  Falls back silently if no compiler is available — callers
check ``available()`` and use the NumPy engine otherwise.

The native engine works on SEGMENTED shells (one contraction per shell);
:func:`segment_shells` expands general contractions and drops zero-weight
primitives before calling in.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "mdint.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    _HERE))), "build", "native")
_LIB = os.path.join(_BUILD, "libmdint.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build():
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-fPIC", "-shared",
               _SRC, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_LIB)
                    or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_LIB)
            lib.md_num_threads.restype = ctypes.c_int
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available():
    return get_lib() is not None


def segment_shells(mol):
    """Flatten a Mole's shells into segmented (nctr=1) arrays for the C ABI.

    Returns dict of arrays + a map from segmented AO index to mol AO index
    (identity when the mole is already segmented, since AO ordering is
    contraction-major within each shell either way).
    """
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
    assert nao == mol.nao
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
    from pyscf_mpcc_tpu_torch.gto.mole import cart2sph
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


def eri3c(mol, auxmol):
    lib = get_lib()
    s = segment_shells(mol)
    x = segment_shells(auxmol)
    c2s, off = c2s_tables()
    out = np.zeros((s["nao"], s["nao"], x["nao"]))
    lib.md_eri3c(
        _ip(s["l"]), _ip(s["nprim"]), _ip(s["prim_off"]), _dp(s["exps"]),
        _dp(s["coefs"]), _dp(s["centers"]), _ip(s["ao_off"]),
        ctypes.c_int(s["nsh"]),
        _ip(x["l"]), _ip(x["nprim"]), _ip(x["prim_off"]), _dp(x["exps"]),
        _dp(x["coefs"]), _dp(x["centers"]), _ip(x["ao_off"]),
        ctypes.c_int(x["nsh"]),
        _dp(c2s), _lp(off), ctypes.c_int(1 if mol.cart else 0),
        ctypes.c_int(s["nao"]), ctypes.c_int(x["nao"]), _dp(out))
    return out


def eri2c(auxmol):
    lib = get_lib()
    x = segment_shells(auxmol)
    c2s, off = c2s_tables()
    out = np.zeros((x["nao"], x["nao"]))
    lib.md_eri2c(
        _ip(x["l"]), _ip(x["nprim"]), _ip(x["prim_off"]), _dp(x["exps"]),
        _dp(x["coefs"]), _dp(x["centers"]), _ip(x["ao_off"]),
        ctypes.c_int(x["nsh"]),
        _dp(c2s), _lp(off), ctypes.c_int(1 if auxmol.cart else 0),
        ctypes.c_int(x["nao"]), _dp(out))
    return out


def eri4c(mol):
    lib = get_lib()
    s = segment_shells(mol)
    c2s, off = c2s_tables()
    out = np.zeros((s["nao"],) * 4)
    lib.md_eri4c(
        _ip(s["l"]), _ip(s["nprim"]), _ip(s["prim_off"]), _dp(s["exps"]),
        _dp(s["coefs"]), _dp(s["centers"]), _ip(s["ao_off"]),
        ctypes.c_int(s["nsh"]),
        _dp(c2s), _lp(off), ctypes.c_int(1 if mol.cart else 0),
        ctypes.c_int(s["nao"]), _dp(out))
    return out


# kernel ids understood by md_eri4c_kern (mdint.cpp Kern)
KERN_COULOMB = 0        # 1/r12
KERN_GAUSS = 1          # exp(-gamma r12^2)
KERN_GAUSS_COULOMB = 2  # exp(-gamma r12^2)/r12
KERN_GAUSS_R2 = 3       # r12^2 exp(-gamma r12^2)


def eri4c_kern(mol, kern_type, gamma, screen=0.0):
    """Full 4-center integrals of a generalized r12 kernel (chemists'
    notation).  Used by the F12 machinery: Slater geminals are fitted
    sums of KERN_GAUSS terms; Yukawa-like f12/r12 uses
    KERN_GAUSS_COULOMB.  ``screen`` > 0 enables Schwarz prescreening
    (valid for the positive-definite kernels 0-2)."""
    lib = get_lib()
    s = segment_shells(mol)
    c2s, off = c2s_tables()
    out = np.zeros((s["nao"],) * 4)
    lib.md_eri4c_kern(
        _ip(s["l"]), _ip(s["nprim"]), _ip(s["prim_off"]), _dp(s["exps"]),
        _dp(s["coefs"]), _dp(s["centers"]), _ip(s["ao_off"]),
        ctypes.c_int(s["nsh"]),
        _dp(c2s), _lp(off), ctypes.c_int(1 if mol.cart else 0),
        ctypes.c_int(s["nao"]), ctypes.c_int(int(kern_type)),
        ctypes.c_double(float(gamma)), ctypes.c_double(float(screen)),
        _dp(out))
    return out


def ovlp_kin(mol):
    lib = get_lib()
    s = segment_shells(mol)
    c2s, off = c2s_tables()
    S = np.zeros((s["nao"], s["nao"]))
    T = np.zeros((s["nao"], s["nao"]))
    lib.md_ovlp_kin(
        _ip(s["l"]), _ip(s["nprim"]), _ip(s["prim_off"]), _dp(s["exps"]),
        _dp(s["coefs"]), _dp(s["centers"]), _ip(s["ao_off"]),
        ctypes.c_int(s["nsh"]),
        _dp(c2s), _lp(off), ctypes.c_int(1 if mol.cart else 0),
        ctypes.c_int(s["nao"]), _dp(S), _dp(T))
    return S, T


def nuc(mol):
    lib = get_lib()
    s = segment_shells(mol)
    c2s, off = c2s_tables()
    out = np.zeros((s["nao"], s["nao"]))
    coords = np.ascontiguousarray(mol.atom_coords(), dtype=np.float64)
    charges = np.ascontiguousarray(mol.atom_charges(), dtype=np.float64)
    lib.md_nuc(
        _ip(s["l"]), _ip(s["nprim"]), _ip(s["prim_off"]), _dp(s["exps"]),
        _dp(s["coefs"]), _dp(s["centers"]), _ip(s["ao_off"]),
        ctypes.c_int(s["nsh"]),
        _dp(coords), _dp(charges), ctypes.c_int(mol.natm),
        _dp(c2s), _lp(off), ctypes.c_int(1 if mol.cart else 0),
        ctypes.c_int(s["nao"]), _dp(out))
    return out
