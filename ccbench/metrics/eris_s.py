"""eris_s: Seconds of the program's integral transform, cc/eris.make_eris_df,
from the benchmark's inputs to the fp32 MO blocks (host clock, synchronised).
Returns None where the run recorded nothing to read."""

def read(rec):
    return rec.get("eris_s")
