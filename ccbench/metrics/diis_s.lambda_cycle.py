"""diis_s.lambda_cycle: Seconds a Lambda cycle in the DIIS ring: the device interval of the
program's span lambda.diis, per Lambda cycle of the traced window.
Returns None where the run recorded nothing to read."""

from ccbench.harness import spans


def read(rec):
    return spans.per_cycle(rec, "lambda.cycle", "lambda.diis")
