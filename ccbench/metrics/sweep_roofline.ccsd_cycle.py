"""sweep_roofline.ccsd_cycle: Share of its roofline that one CCSD sweep reaches: the least time of
the sweep's mathematics (harness/counts.py: FLOP with the ladder's pair
symmetry over the bf16 dense peak, or bytes over HBM bandwidth) over
sweep_s.
Returns None where the run recorded nothing to read."""

from ccbench.harness import counts


def read(rec):
    if "sweep_s" not in rec:
        return None
    naux, nocc, nvir = rec["shape"]
    least = counts.least_time(counts.sweep_flops(nocc, nvir, naux),
                              counts.sweep_bytes(nocc, nvir, naux))
    return 100.0 * least / rec["sweep_s"]
