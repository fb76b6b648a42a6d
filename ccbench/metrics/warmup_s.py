"""warmup_s: Seconds of the warm-up in set-up: from the integrals being ready to
the end of the driver's warm-up unit (host clock, synchronised).
Returns None where the run recorded nothing to read."""

def read(rec):
    return rec.get("warmup_s")
