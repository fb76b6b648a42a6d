"""host_syncs.ccsd_cycle: Reads that block the host on the device, per CCSD cycle: the
program's spans sync.* over its spans ccsd.cycle in the traced window
(the per-solve reads spread over the solve's cycles).
Returns None where the run recorded nothing to read."""

from ccbench.harness import spans


def read(rec):
    return spans.spans_per_cycle(rec, "ccsd.cycle", "sync.")
