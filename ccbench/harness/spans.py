"""The program's own spans, for the per-layer readers of metrics/ (source
program_span).

The program records them only while a profiler session is active
(pyscf_mpcc_tpu_torch.utils.profiling), so they exist only in a traced run,
and only the last session's are kept: the traced window's.  A program that
records none (an older checkout) gives None, never an error.  Every value
is per cycle: divided by the window's cycle spans (ccsd.cycle,
lambda.cycle).
"""

from __future__ import annotations


def _spans(rec):
    """The traced window's spans, or None."""
    if not rec.get("trace"):
        return None
    from pyscf_mpcc_tpu_torch.utils import profiling
    read = getattr(profiling, "session", None)
    if read is None:
        return None
    return read()[0] or None


def per_cycle(rec, cycle, name, self_time=False):
    """Seconds a cycle of the spans ``name`` on the device (their self
    time with ``self_time``), summed over the window and divided by the
    number of spans ``cycle``; None where there is nothing to read."""
    spans = _spans(rec)
    if spans is None:
        return None
    n = sum(s.name == cycle for s in spans)
    mine = [s for s in spans if s.name == name and s.device is not None]
    if not n or not mine:
        return None
    ns = sum(s.self_ns if self_time else s.device[1] - s.device[0]
             for s in mine)
    return ns * 1e-9 / n


def spans_per_cycle(rec, cycle, prefix):
    """The spans whose name starts with ``prefix`` over the spans
    ``cycle``, over the window."""
    spans = _spans(rec)
    if spans is None:
        return None
    n = sum(s.name == cycle for s in spans)
    return sum(s.name.startswith(prefix) for s in spans) / n if n else None
