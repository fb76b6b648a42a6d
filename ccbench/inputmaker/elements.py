"""Periodic-table data: element symbols and nuclear charges."""

ELEMENTS = [
    "X",  # ghost
    "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe",
    "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd", "Tb", "Dy",
    "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt",
    "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At", "Rn",
]

SYMBOL_TO_Z = {s.upper(): z for z, s in enumerate(ELEMENTS)}

# Matches the reference constant pyscf/data/nist.py (BOHR in Angstrom).
BOHR = 0.52917721092


def charge(symbol: str) -> int:
    s = symbol.strip().upper()
    if s.startswith("GHOST") or s.startswith("X-") or s == "X":
        return 0
    # strip trailing digits used to tag atoms, e.g. "H1"
    base = s.rstrip("0123456789")
    if base in SYMBOL_TO_Z:
        return SYMBOL_TO_Z[base]
    raise KeyError(f"Unknown element symbol: {symbol}")


def std_symbol(symbol) -> str:
    """Normalize an element spec (symbol string or atomic number) to 'He' form."""
    if isinstance(symbol, (int,)):
        return ELEMENTS[symbol]
    s = symbol.strip()
    base = s.rstrip("0123456789")
    return base.capitalize()
