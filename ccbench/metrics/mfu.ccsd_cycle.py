"""mfu.ccsd_cycle: Share of the card's bf16 dense peak that a whole CCSD cycle reaches:
the sweep's needed FLOP (harness/counts.py) over the traced run's
seconds a cycle, over the peak.
Returns None where the run recorded nothing to read."""

from ccbench.harness import counts, peaks


def read(rec):
    naux, nocc, nvir = rec["shape"]
    flops = counts.sweep_flops(nocc, nvir, naux)
    return 100.0 * flops / (rec["per_unit_s"] * peaks.DENSE_FLOPS)
