"""sweep_s.ccsd_cycle: Seconds of one CCSD sweep, rccsd.update_amps, at the window's last
amplitudes: CUDA events around a few sweeps after the traced window.
Returns None where the run recorded nothing to read."""

def read(rec):
    return rec.get("sweep_s")
