"""idle_pct.ccsd_cycle: Share of the traced window in which no kernel, copy or set runs on the
card: 100 less the union of the profiler's device intervals.
Returns None where the run recorded nothing to read."""

from ccbench.harness.readers import trace_idle


def read(rec):
    return trace_idle(rec)
