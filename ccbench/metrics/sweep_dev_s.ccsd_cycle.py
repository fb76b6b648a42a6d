"""sweep_dev_s.ccsd_cycle: Seconds of one CCSD sweep inside the traced window: the device
interval of the program's span ccsd.update_amps (rccsd.kernel), summed over
the window and divided by its ccsd.cycle spans.
Returns None where the run recorded nothing to read."""

from ccbench.harness import spans


def read(rec):
    return spans.per_cycle(rec, "ccsd.cycle", "ccsd.update_amps")
