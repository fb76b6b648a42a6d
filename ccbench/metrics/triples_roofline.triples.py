"""triples_roofline.triples: Share of its roofline that the (T) kernels reach: the least time of
the (T) energy's mathematics (harness/counts.py: FLOP over the a > b > c
triples against the bf16 dense peak, or bytes over HBM bandwidth) over
the summed device time of every kernel in the traced ccsd_t.kernel call.
Returns None where the run recorded nothing to read."""

from ccbench.harness import counts


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["kernel_s"] <= 0:
        return None
    naux, nocc, nvir = rec["shape"]
    n = len(rec["units"])
    least = counts.least_time(counts.triples_flops(nocc, nvir),
                              counts.triples_bytes(nocc, nvir, naux))
    return 100.0 * least * n / tr["kernel_s"]
