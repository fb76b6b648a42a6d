"""ladder_work.ccsd_cycle: The DF ladder's executed work a CCSD cycle, as a multiple of
the pair-symmetric minimum: the program's counter ladder.w_elems (the W
elements its pair sweeps build, rccsd.mirrored_sweep) over the traced
window's ccsd.cycle spans, over nvir^4 / 2.  2.0 is the dense ladder of
one tile; (ntile + 1) / ntile at nvir divisible by ntile.
Returns None where the run recorded nothing to read."""

from ccbench.harness import spans


def read(rec):
    cycles = spans._spans(rec)
    if cycles is None:
        return None
    from pyscf_mpcc_tpu_torch.utils import profiling
    w = profiling.session()[1].get("ladder.w_elems")
    n = sum(s.name == "ccsd.cycle" for s in cycles)
    if not w or not n:
        return None
    nvir = rec["shape"][2]
    return w / n / (nvir ** 4 / 2)
