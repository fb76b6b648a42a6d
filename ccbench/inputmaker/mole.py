"""Molecule and shell structure.

Clean-room replacement for the reference's molecule layer (pyscf/gto/mole.py):
geometry handling, basis attachment, GTO normalization, and the cartesian ->
real-spherical-harmonic transformation.  Conventions match the reference so
that total energies are directly comparable:

- coordinates stored in Bohr (input default Angstrom, BOHR = 0.52917721092),
- primitive radial normalization ``gto_norm(l, a) = 1/sqrt(int r^(2l+2) e^(-2ar^2) dr)``,
- contracted functions normalized to unit self-overlap (spherical),
- real solid harmonics with m = -l..l ordering (p shells kept in x,y,z order).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ccbench.inputmaker import basis as basis_mod
from ccbench.inputmaker.elements import BOHR, charge as elem_charge, std_symbol


# ---------------------------------------------------------------------------
# normalization helpers
# ---------------------------------------------------------------------------

def gaussian_int(n, alpha):
    r""":math:`\int_0^\infty r^n e^{-\alpha r^2} dr`."""
    n1 = (n + 1) * 0.5
    return math.gamma(n1) / (2.0 * alpha ** n1) if np.isscalar(alpha) else (
        _gamma(n1) / (2.0 * np.asarray(alpha) ** n1))


def _gamma(x):
    from scipy.special import gamma
    return gamma(x)


def gto_norm(l, expnt):
    """Radial normalization of a solid-harmonic GTO r^l e^{-a r^2}."""
    return 1.0 / np.sqrt(gaussian_int(l * 2 + 2, 2.0 * np.asarray(expnt, dtype=float)))


def normalize_contraction(l, es, cs):
    """Scale contraction columns so each contracted spherical AO has unit norm.

    ``cs`` must already include the primitive norms ``gto_norm(l, es)``.
    """
    ee = es[:, None] + es[None, :]
    g = 1.0 / np.sqrt(ee) ** (2 * l + 3) * math.gamma(l + 1.5) / 2.0
    s = np.einsum("pi,pq,qi->i", cs, g, cs)
    return cs / np.sqrt(s)[None, :]


# ---------------------------------------------------------------------------
# cartesian monomials and real solid harmonics
# ---------------------------------------------------------------------------

def cart_components(l):
    """Cartesian monomial exponents in CCA order: x^l first, z^l last."""
    return [(i, j, l - i - j) for i in range(l, -1, -1) for j in range(l - i, -1, -1)]


def ncart(l):
    return (l + 1) * (l + 2) // 2


class _Poly(dict):
    """Sparse polynomial over cartesian monomials {(i,j,k): coeff}."""

    def __mul_mono__(self, mono, fac):
        out = _Poly()
        for (i, j, k), c in self.items():
            out[(i + mono[0], j + mono[1], k + mono[2])] = (
                out.get((i + mono[0], j + mono[1], k + mono[2]), 0.0) + c * fac)
        return out

    def axpy(self, other, fac):
        for m, c in other.items():
            self[m] = self.get(m, 0.0) + c * fac


def _real_solid_harmonics(lmax):
    """Real solid harmonics S_lm via the standard recursion (Helgaker 6.4.47-50).

    Racah-normalized: angular self-overlap over the unit sphere is 4pi/(2l+1).
    Returns ``tab[l][m+l]`` as a _Poly in (x, y, z).
    """
    tab = [[_Poly({(0, 0, 0): 1.0})]]
    for l in range(lmax):
        prev = tab[l]
        new = [None] * (2 * (l + 1) + 1)
        # vertical recursion for |m| <= l
        for m in range(-l, l + 1):
            p = _Poly()
            p.axpy(prev[m + l].__mul_mono__((0, 0, 1), 1.0), 2 * l + 1)
            if l - 1 >= abs(m):
                below = tab[l - 1][m + l - 1]
                fac = -math.sqrt((l + m) * (l - m))
                for mono in ((2, 0, 0), (0, 2, 0), (0, 0, 2)):
                    p.axpy(below.__mul_mono__(mono, 1.0), fac)
            denom = math.sqrt((l + 1 + m) * (l + 1 - m))
            q = _Poly()
            q.axpy(p, 1.0 / denom)
            new[m + l + 1] = q
        # diagonal recursion for m = +-(l+1)
        fac = math.sqrt((2 * l + 1) / (2.0 * l + 2.0)) * (math.sqrt(2.0) if l == 0 else 1.0)
        stop = tab[l][2 * l]     # S_{l,l}
        sbot = tab[l][0]         # S_{l,-l}
        top = _Poly()
        top.axpy(stop.__mul_mono__((1, 0, 0), 1.0), fac)
        if l > 0:
            top.axpy(sbot.__mul_mono__((0, 1, 0), 1.0), -fac)
        bot = _Poly()
        bot.axpy(stop.__mul_mono__((0, 1, 0), 1.0), fac)
        if l > 0:
            bot.axpy(sbot.__mul_mono__((1, 0, 0), 1.0), fac)
        new[2 * l + 2] = top
        new[0] = bot
        tab.append(new)
    return tab


_SPH_TAB = None


def cart2sph(l):
    """(2l+1, ncart) transform from cartesian monomial integrals to unit-norm
    real-spherical AOs (radial part normalized via gto_norm)."""
    global _SPH_TAB
    lmax_needed = max(l, 6)
    if _SPH_TAB is None or len(_SPH_TAB) <= lmax_needed:
        _SPH_TAB = _real_solid_harmonics(lmax_needed)
    comps = cart_components(l)
    idx = {m: i for i, m in enumerate(comps)}
    mat = np.zeros((2 * l + 1, ncart(l)))
    scale = math.sqrt((2 * l + 1) / (4.0 * math.pi))
    for mm in range(2 * l + 1):
        for mono, c in _SPH_TAB[l][mm].items():
            mat[mm, idx[mono]] += c * scale
    if l == 1:
        # keep p functions in x, y, z order (reference convention)
        mat = mat[[2, 0, 1]]
    return mat


# ---------------------------------------------------------------------------
# shells and molecule
# ---------------------------------------------------------------------------

@dataclass
class Shell:
    atom_id: int
    l: int
    exps: np.ndarray          # (nprim,)
    coefs: np.ndarray         # (nprim, nctr), includes primitive norms
    center: np.ndarray        # (3,) Bohr

    @property
    def nprim(self):
        return len(self.exps)

    @property
    def nctr(self):
        return self.coefs.shape[1]

    def nao(self, cart=False):
        per = ncart(self.l) if cart else 2 * self.l + 1
        return per * self.nctr


def _parse_atom(atom):
    """Accept pyscf-style atom specs: string 'O 0 0 0; H ...' or list
    [[sym_or_Z, (x, y, z)], ...]. Returns list of (symbol, xyz array)."""
    out = []
    if isinstance(atom, str):
        for seg in atom.replace("\n", ";").split(";"):
            seg = seg.strip()
            if not seg:
                continue
            toks = seg.replace(",", " ").split()
            sym = std_symbol(int(toks[0])) if toks[0].isdigit() else std_symbol(toks[0])
            out.append((sym, np.array([float(t) for t in toks[1:4]])))
    else:
        for entry in atom:
            sym = entry[0]
            if isinstance(sym, (int, np.integer)):
                sym = std_symbol(int(sym))
            else:
                sym = std_symbol(sym)
            xyz = np.asarray(entry[1], dtype=float).reshape(3)
            out.append((sym, xyz))
    return out


class Mole:
    """Molecular system: geometry + basis -> shell table.

    Mirrors the reference API surface that the correlation stack consumes:
    ``natm, nao, nelectron, atom_coords(), atom_charges(), energy_nuc()``.
    """

    def __init__(self, atom=None, basis="sto-3g", unit="angstrom", charge=0,
                 spin=0, cart=False, verbose=0):
        self.atom = atom
        self.basis = basis
        self.unit = unit
        self.charge = charge
        self.spin = spin  # 2S = nalpha - nbeta
        self.cart = cart
        self.verbose = verbose
        self._built = False

    def build(self):
        atoms = _parse_atom(self.atom)
        fac = 1.0 if self.unit.lower().startswith("b") or self.unit.lower() == "au" \
            else 1.0 / BOHR
        self.symbols = [a[0] for a in atoms]
        self.coords = np.array([a[1] * fac for a in atoms])  # Bohr
        self.charges = np.array([elem_charge(s) for s in self.symbols], dtype=int)

        # attach basis
        if isinstance(self.basis, str):
            bas_tab = {s: basis_mod.load(self.basis, s) for s in set(self.symbols)}
        else:
            bas_tab = {}
            for s in set(self.symbols):
                b = self.basis[s]
                bas_tab[s] = basis_mod.load(b, s) if isinstance(b, str) else b

        shells = []
        for ia, sym in enumerate(self.symbols):
            for entry in bas_tab[sym]:
                l = entry[0]
                rows = np.array(entry[1:], dtype=float)
                es = rows[:, 0]
                cs = rows[:, 1:]
                # drop all-zero columns defensively
                keep = np.abs(cs).max(axis=0) > 0
                cs = cs[:, keep]
                cs = cs * gto_norm(l, es)[:, None]
                cs = normalize_contraction(l, es, cs)
                shells.append(Shell(ia, l, es, cs, self.coords[ia]))
        self.shells = shells

        # AO bookkeeping
        self.ao_loc = np.zeros(len(shells) + 1, dtype=int)
        for i, sh in enumerate(shells):
            self.ao_loc[i + 1] = self.ao_loc[i] + sh.nao(self.cart)
        self.nao = int(self.ao_loc[-1])
        self.nelectron = int(self.charges.sum()) - self.charge
        if (self.nelectron + self.spin) % 2 != 0:
            raise ValueError(
                f"Electron number {self.nelectron} and spin {self.spin} inconsistent")
        self.nelec = ((self.nelectron + self.spin) // 2,
                      (self.nelectron - self.spin) // 2)
        self._built = True
        return self

    # --- reference-compatible accessors -----------------------------------
    @property
    def natm(self):
        return len(self.symbols)

    def atom_coords(self):
        return self.coords

    def atom_charges(self):
        return self.charges

    def nbas(self):
        return len(self.shells)

    def energy_nuc(self):
        e = 0.0
        for i in range(self.natm):
            for j in range(i):
                r = np.linalg.norm(self.coords[i] - self.coords[j])
                e += self.charges[i] * self.charges[j] / r
        return e

    def ao_labels(self):
        labels = []
        lsym = "spdfghi"
        for sh in self.shells:
            for c in range(sh.nctr):
                if self.cart:
                    for (i, j, k) in cart_components(sh.l):
                        labels.append(
                            f"{sh.atom_id} {self.symbols[sh.atom_id]} "
                            f"{lsym[sh.l]} {'x'*i}{'y'*j}{'z'*k}")
                else:
                    ms = [0] if sh.l == 0 else (
                        ["x", "y", "z"] if sh.l == 1 else
                        list(range(-sh.l, sh.l + 1)))
                    for m in ms:
                        labels.append(
                            f"{sh.atom_id} {self.symbols[sh.atom_id]} "
                            f"{lsym[sh.l]} m={m}")
        return labels


def M(**kwargs):
    """Shortcut constructor mirroring the reference's ``gto.M()``."""
    return Mole(**kwargs).build()
