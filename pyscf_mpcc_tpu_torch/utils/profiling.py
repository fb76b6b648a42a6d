"""Tracing: a ``torch.profiler`` trace, and the program's own spans and
counters on the profiler's clock.

Port of ``pyscf_mpcc_tpu/utils/profiling.py``: wall timers live in
lib.logger; this module adds

- ``trace(logdir)``: a ``torch.profiler`` session around a block, written
  as a Chrome trace ``trace.json`` with the program's spans beside the
  profiler's rows;
- ``span(name, device=False)``: what the solver loops (cc/rccsd,
  cc/lambda_ad, cc/ccsd_t, lib/device_diis) record of themselves; a
  read that blocks the host on the device is a span ``sync.<site>``;
- ``count(name, n=1)``: a counter, for what no span counts (the (T)'s
  tiles, the W elements of the CCSD ladder);
- ``session()``: the spans and counters of the last profiler session,
  resolved, for a reader such as the benchmark's per-layer metrics.

The switch is the profiler itself: spans and counters are recorded only
while a ``torch.profiler`` session is active (any activity, CUDA alone
included), so whoever opens one, ``trace()`` or a benchmark's window,
gets them.  Otherwise a span is one flag check that returns a shared
no-op context: it allocates nothing, records no CUDA event and never
synchronises.

A recorded span keeps its name, its parent, the solve it belongs to (a
span opened with no span open starts a new solve: each solver entry is
one) and its host interval, stamped with ``time.time_ns``, the clock of
the profiler's Kineto events.  A device span (``device=True``) also
records a CUDA event at its start and end on the current stream; each is
placed on the host clock through one anchor per session and device, an
event recorded right after one ``torch.cuda.synchronize()`` at a known
host time, the only synchronisation the recorder adds.  Its device
interval is then when the stream reached the span's start and end.
Without CUDA a device span's device interval is its host interval.
Events are read only when ``session()`` resolves them.

Each new profiler session drops the last one's spans and counts: from
its first recorded span on, the recorder has torch's own session-start
call (``torch.autograd.profiler._run_on_profiler_start``) mark it stale.
Where torch has no such call, sessions cannot be told apart and nothing
is recorded (a warning says so).  One thread records.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import NamedTuple, Optional, Tuple

import torch

_profiling = torch._C._autograd._profiler_enabled

# the pid of the program's rows in trace.json (the profiler's are the
# process's own pid and the devices' indices)
PROGRAM_PID = 1 << 30


class Span(NamedTuple):
    """One resolved span.  Times are ns on the profiler's clock; parent is
    an index into the session's list, or None."""
    name: str
    solve: int
    parent: Optional[int]
    host: Tuple[int, int]
    device: Optional[Tuple[int, int]]
    self_ns: int    # the interval less the part its children's cover, on
    #                 the device where the span has a device interval


# the span when tracing is off
_OFF = contextlib.nullcontext()


class _Open:
    """A recorded span: ev holds its two CUDA events and the stream they
    are recorded on, dev the device (-1 for a device span without CUDA,
    None for a host span)."""
    __slots__ = ("rec", "name", "dev", "ev", "solve", "parent", "t0", "t1")

    def __init__(self, rec, name, dev, ev):
        self.rec, self.name, self.dev, self.ev = rec, name, dev, ev
        self.t1 = None

    def __enter__(self):
        rec = self.rec
        self.parent = rec.stack[-1] if rec.stack else None
        if self.parent is None:
            rec.nsolve += 1
            self.solve = rec.nsolve
        else:
            self.solve = self.parent.solve
        rec.stack.append(self)
        rec.spans.append(self)
        if self.ev is not None:
            self.ev[0].record(self.ev[2])
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.ev is not None:
            self.ev[1].record(self.ev[2])
        stack = self.rec.stack
        if stack and stack[-1] is self:    # not cleared by a new session
            stack.pop()
        return False


class _Recorder:
    """The spans (open ones on ``stack``), counts and clock anchors of the
    current profiler session."""

    def __init__(self):
        self.nsolve = 0
        self.spans, self.stack, self.counts, self.anchors = [], [], {}, {}
        self.stale = True       # the first span starts a session

    def begin(self):
        """Start a new session: drop the last one's spans and counts.
        False, and nothing recorded, where sessions cannot be told apart
        (``_watch_sessions``)."""
        if not _watch_sessions():
            return False
        self.spans, self.stack, self.counts, self.anchors = [], [], {}, {}
        self.stale = False
        return True

    def open(self, name, device):
        if self.stale and not self.begin():
            return _OFF
        if not device:
            return _Open(self, name, None, None)
        if not torch.cuda.is_initialized():
            return _Open(self, name, -1, None)
        dev = torch.cuda.current_device()
        # fetched once a span: torch.cuda.current_stream() costs as much
        # as a record
        stream = torch.cuda.current_stream(dev)
        if dev not in self.anchors:
            torch.cuda.synchronize(dev)
            a = torch.cuda.Event(enable_timing=True)
            a.record(stream)
            self.anchors[dev] = (a, time.time_ns())
        return _Open(self, name, dev, (torch.cuda.Event(enable_timing=True),
                                       torch.cuda.Event(enable_timing=True),
                                       stream))

    def add(self, name, n):
        if self.stale and not self.begin():
            return
        self.counts[name] = self.counts.get(name, 0) + n


_REC = _Recorder()


def _watch_sessions():
    """Have each profiler session's start mark the recorder stale, by
    wrapping the function that torch.autograd.profiler calls as a
    session starts (once per process).  False where this torch has no
    such function."""
    from torch.autograd import profiler as ap
    start = getattr(ap, "_run_on_profiler_start", None)
    if start is None:
        warnings.warn("torch.autograd.profiler has no "
                      "_run_on_profiler_start: the program's spans are "
                      "not recorded")
        return False
    if getattr(start, "marks_spans_stale", False):
        return True

    def on_start():
        _REC.stale = True
        start()

    on_start.marks_spans_stale = True
    ap._run_on_profiler_start = on_start
    return True


def span(name, device=False):
    """Context manager: record the enclosed block as a span ``name`` while
    a profiler session is active (see the module docstring); with
    ``device=True`` also when the current CUDA stream ran it."""
    if not _profiling():
        return _OFF
    return _REC.open(name, device)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while a profiler session is
    active."""
    if _profiling():
        _REC.add(name, n)


def _cover(ivs, lo, hi):
    """Length of the union of the intervals ivs within [lo, hi]."""
    tot, end = 0, lo
    for a, b in sorted(ivs):
        a, b = max(a, end), min(b, hi)
        if b > a:
            tot += b - a
            end = b
    return tot


def session():
    """(spans, counts) of the last profiler session: a list of Span in the
    order they opened, and {name: n}; empty for a session that recorded
    nothing.  Waits for the CUDA events it reads; spans still open are
    left out."""
    rec = _REC
    if rec.stale:
        return [], {}
    done = [s for s in rec.spans if s.t1 is not None]
    pos = {id(s): i for i, s in enumerate(done)}

    def on_host(ev, dev):
        a, h = rec.anchors[dev]
        return h + round(a.elapsed_time(ev) * 1e6)

    dev_iv = []
    for s in done:
        if s.ev is not None:
            s.ev[1].synchronize()
            dev_iv.append((on_host(s.ev[0], s.dev), on_host(s.ev[1], s.dev)))
        else:
            dev_iv.append(None if s.dev is None else (s.t0, s.t1))
    kids = [[] for _ in done]
    for i, s in enumerate(done):
        if id(s.parent) in pos:
            kids[pos[id(s.parent)]].append(i)
    out = []
    for i, s in enumerate(done):
        # self time on the span's own clock: the device's where it has a
        # device interval (a host-only child takes none of it), the host's
        # otherwise
        if dev_iv[i] is not None:
            lo, hi = dev_iv[i]
            ivs = [dev_iv[k] for k in kids[i] if dev_iv[k] is not None]
        else:
            lo, hi = s.t0, s.t1
            ivs = [(done[k].t0, done[k].t1) for k in kids[i]]
        out.append(Span(s.name, s.solve, pos.get(id(s.parent)),
                        (s.t0, s.t1), dev_iv[i],
                        hi - lo - _cover(ivs, lo, hi)))
    return out, dict(rec.counts)


def _program_events(spans, counts, base_ns, end_ns):
    """Chrome trace events of the program's spans, one row of host
    intervals and one of device intervals, and of its counters, each
    one sample of its total where the session ends."""
    evs = [dict(ph="M", name="process_name", pid=PROGRAM_PID, tid=0,
                args=dict(name="program")),
           dict(ph="M", name="thread_name", pid=PROGRAM_PID, tid=0,
                args=dict(name="host (enqueue)")),
           dict(ph="M", name="thread_name", pid=PROGRAM_PID, tid=1,
                args=dict(name="device (stream)"))]
    for s in spans:
        args = dict(solve=s.solve, self_us=s.self_ns / 1e3)
        if s.parent is not None:
            args["parent"] = spans[s.parent].name
        for tid, iv in ((0, s.host), (1, s.device)):
            if iv is not None:
                evs.append(dict(ph="X", name=s.name, pid=PROGRAM_PID,
                                tid=tid, ts=(iv[0] - base_ns) / 1e3,
                                dur=(iv[1] - iv[0]) / 1e3, args=args))
    for name, n in counts.items():
        evs.append(dict(ph="C", name=name, pid=PROGRAM_PID,
                        ts=(end_ns - base_ns) / 1e3, args={name: n}))
    return evs


@contextlib.contextmanager
def trace(logdir="profile"):
    """Capture a ``torch.profiler`` trace of the enclosed block (CPU, and
    CUDA where a card is present) and write it as a Chrome trace
    ``trace.json`` under ``logdir`` (relative to the working directory),
    with the program's spans as a process "program": a row of their host
    intervals and a row of their device intervals, so that under each
    idle gap of the device the span the host was in shows, and its
    counters' totals.  Yields the profiler, whose ``key_averages()`` sums
    time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            end_ns = time.time_ns()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += _program_events(
        *session(), doc.get("baseTimeNanoseconds", 0), end_ns)
    with open(path, "w") as f:
        json.dump(doc, f)
