"""cycle_rest_s.ccsd_cycle: Seconds of a CCSD cycle outside its sweep: the traced run's window over
its cycles less sweep_s (the DIIS ring, the energy, the norms and the
host syncs of rccsd.kernel).
Returns None where the run recorded nothing to read."""

def read(rec):
    if "sweep_s" not in rec:
        return None
    return rec["per_unit_s"] - rec["sweep_s"]
