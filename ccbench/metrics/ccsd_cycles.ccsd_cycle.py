"""ccsd_cycles.ccsd_cycle: Cycles per converged CCSD solve, counted from the lines rccsd.kernel
prints at verbose=5.
Returns None where the run recorded nothing to read."""

def read(rec):
    c = rec.get("cycles")
    return sum(c) / len(c) if c else None
