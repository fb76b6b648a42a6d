"""ladder_vjp_s.lambda_cycle: Seconds a Lambda cycle in the vjp of the particle-particle ladder:
the device interval of the program's span lambda.seg.ladder
(lambda_ad._lambda_step), per Lambda cycle of the traced window.
Returns None where the run recorded nothing to read."""

from ccbench.harness import spans


def read(rec):
    return spans.per_cycle(rec, "lambda.cycle", "lambda.seg.ladder")
