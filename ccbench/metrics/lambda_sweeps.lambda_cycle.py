"""lambda_sweeps.lambda_cycle: A Lambda cycle in CCSD sweeps: the traced run's window over its Lambda
cycles, over sweep_s timed in the same run.
Returns None where the run recorded nothing to read."""

def read(rec):
    if "sweep_s" not in rec:
        return None
    return rec["per_unit_s"] / rec["sweep_s"]
