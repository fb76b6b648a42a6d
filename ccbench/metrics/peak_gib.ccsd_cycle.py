"""peak_gib.ccsd_cycle: Peak device memory over the traced window, GiB
(torch.cuda.max_memory_allocated after reset_peak_memory_stats).
Returns None where the run recorded nothing to read."""

def read(rec):
    b = rec.get("peak_window_bytes")
    return None if b is None else b / 2**30
