"""Gaussian basis-set handling: NWChem-format parser and basis lookup.

A frozen copy of the port's gto/basis.py for the benchmark's input maker.
Basis sets come only from ``basis_data/`` beside this file (the four sets
the benchmark's configurations and tests use), never from the environment
or an installed PySCF, so every run of a configuration reads the same
numbers.

Internal representation (as the reference's pyscf/gto/basis/parse_nwchem.py):
``{element: [[l, [exp, c1, c2, ...], ...], ...]}``, where several
coefficient columns denote a generally contracted shell.
"""

from __future__ import annotations

import os
import re
from functools import lru_cache

ANGULAR = {"S": 0, "P": 1, "D": 2, "F": 3, "G": 4, "H": 5, "I": 6}

_VENDORED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "basis_data")


# common aliases -> canonical file stem (after normalization)
_ALIASES = {
    "weigend": "def2-universal-jfit",
    "weigend+etb": "def2-universal-jfit",
    "weigendcfit": "def2-universal-jfit",
    "weigendjfit": "def2-universal-jfit",
    "weigendjkfit": "def2-universal-jkfit",
    "def2universaljfit": "def2-universal-jfit",
    "def2universaljkfit": "def2-universal-jkfit",
}


def _norm_name(name: str) -> str:
    # '*' is conventionally spelled 's' in Pople basis file names
    return re.sub(r"[-_ ]", "", name.lower()).replace("*", "s")


def library_dirs():
    return [_VENDORED_DIR]


@lru_cache(maxsize=None)
def _file_index():
    """Map normalized basis-set name -> file path, scanning the library dirs."""
    index = {}
    for d in library_dirs():
        for root, _dirs, files in os.walk(d):
            for fn in sorted(files):
                if not fn.endswith(".dat"):
                    continue
                key = _norm_name(fn[:-4])
                index.setdefault(key, os.path.join(root, fn))
    return index


def find_basis_file(name: str) -> str:
    key = _norm_name(name)
    key = _norm_name(_ALIASES.get(key, key))
    index = _file_index()
    if key in index:
        return index[key]
    raise FileNotFoundError(
        f"Basis set '{name}' not found in {_VENDORED_DIR}"
    )


_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eEdD][+-]?\d+)?$")


def _tofloat(tok: str) -> float:
    return float(tok.replace("D", "e").replace("d", "e"))


def parse_nwchem(text: str, element: str):
    """Parse NWChem-format basis text, returning the shells for one element."""
    elem = element.strip().capitalize()
    shells = []
    cur = None  # (l_list, rows)
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        up = line.upper()
        if up.startswith("BASIS") or up.startswith("END"):
            continue
        toks = line.split()
        if _FLOAT_RE.match(toks[0]):
            if cur is not None:
                cur[1].append([_tofloat(t) for t in toks])
            continue
        # header line: "<Elem> <ShellType>"
        if len(toks) >= 2 and (toks[1].upper() in ANGULAR
                               or toks[1].upper() == "SP"):
            if cur is not None:
                shells.append(cur)
            if toks[0].capitalize() == elem:
                stype = toks[1].upper()
                if stype == "SP":
                    cur = ("SP", [])
                else:
                    cur = (ANGULAR[stype], [])
            else:
                cur = None
        else:
            cur = None
    if cur is not None:
        shells.append(cur)

    out = []
    for l, rows in shells:
        if not rows:
            continue
        if l == "SP":
            out.append([0] + [[r[0], r[1]] for r in rows])
            out.append([1] + [[r[0], r[2]] for r in rows])
        else:
            ncol = max(len(r) for r in rows)
            # rows may have ragged columns in some files; pad with zeros
            rows = [r + [0.0] * (ncol - len(r)) for r in rows]
            out.append([l] + [list(r) for r in rows])
    if not out:
        raise KeyError(f"Element {element} not found in basis file")
    return out


@lru_cache(maxsize=None)
def _load_element(path: str, element: str):
    """Extract the text block for one element from an NWChem file and parse it."""
    elem = element.strip().capitalize()
    lines = open(path).read().splitlines()
    block = []
    in_block = False
    for raw in lines:
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        toks = line.split()
        if not _FLOAT_RE.match(toks[0]) and len(toks) >= 2:
            in_block = toks[0].capitalize() == elem
        if in_block:
            block.append(raw)
    if not block:
        raise KeyError(f"Element {element} not in {path}")
    return parse_nwchem("\n".join(block), element)


def load(name: str, element: str):
    """Load basis data for ``element`` from named basis set.

    Returns the internal format ``[[l, [e, c...], ...], ...]``.
    """
    path = find_basis_file(name)
    return _load_element(path, element)
