"""loop_self_s.ccsd_cycle: Seconds a CCSD cycle outside its sweep, ring and energy: the self
time on the device of the program's span ccsd.cycle (its device interval
less those of ccsd.update_amps, ccsd.diis and ccsd.energy: the norms, the
host syncs and the host's gaps between them), per cycle of the traced
window.
Returns None where the run recorded nothing to read."""

from ccbench.harness import spans


def read(rec):
    return spans.per_cycle(rec, "ccsd.cycle", "ccsd.cycle", self_time=True)
