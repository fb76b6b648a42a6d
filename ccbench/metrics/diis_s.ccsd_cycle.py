"""diis_s.ccsd_cycle: Seconds a CCSD cycle in the DIIS ring: the device interval of the
program's span ccsd.diis (the push, the Gram products, the Gram matrix's
read to the host, the host B solve and the extrapolation), per cycle of
the traced window.
Returns None where the run recorded nothing to read."""

from ccbench.harness import spans


def read(rec):
    return spans.per_cycle(rec, "ccsd.cycle", "ccsd.diis")
