"""mfu.triples: Share of the card's bf16 dense peak that a whole (T) energy reaches:
the needed FLOP (harness/counts.py) over the traced run's seconds an
energy, over the peak.
Returns None where the run recorded nothing to read."""

from ccbench.harness import counts, peaks


def read(rec):
    naux, nocc, nvir = rec["shape"]
    flops = counts.triples_flops(nocc, nvir)
    return 100.0 * flops / (rec["per_unit_s"] * peaks.DENSE_FLOPS)
