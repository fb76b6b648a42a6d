"""A profiled window on the card: device busy time, kernel time by name,
and the idle gaps labelled by the kernels around them.

``torch.profiler`` records CUDA activity only (kernels, copies, sets, and
the runtime calls that launch them): recording every CPU operator as well
made the per-tile host work of the (T) 2.5 times slower and the idle share
meaningless.  A gap is labelled by the kernels that end and start it, which
names the host step between them.  The raw Kineto events are read
directly, without building PyTorch's event tree, so a window of a few
hundred thousand kernels is reduced in seconds.
"""

from __future__ import annotations

import time
from collections import Counter, defaultdict

import torch

TOP = 10


def _ns(ev, which):
    f = getattr(ev, which + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, which + "_us")() * 1000)


class Window:
    """Context manager: profile the work inside it.  On exit ``result``
    holds window_s (host clock, synchronised), busy_s (union of device
    activity), kernel_s (summed kernel durations), device_ops and
    idle_gaps (each at most TOP [name, seconds] pairs)."""

    def __init__(self, device):
        self.device = device
        self.result = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA if self.device.type == "cuda"
                else ProfilerActivity.CPU]
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.result = reduce(self.prof.profiler.kineto_results.events(),
                                 window_s)
        return False


def _short(name):
    """A kernel's name without its template and argument lists."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0),
              default=len(name))
    return name[:cut][-60:] or name[:60]


def reduce(events, window_s):
    """The readings of a list of Kineto events over a window of
    ``window_s`` host seconds: device events are those on a CUDA device
    (on a CPU device, for the tests, the CPU operators stand in)."""
    evs = []
    for ev in events:
        dur = int(ev.duration_ns()) if hasattr(ev, "duration_ns") else int(
            ev.duration_us() * 1000)
        evs.append((str(ev.device_type()), _ns(ev, "start"), dur, ev.name()))
    kind = "CUDA" if any("CUDA" in e[0] for e in evs) else "CPU"
    dev = sorted((s, s + d, n) for k, s, d, n in evs
                 if kind in k and not n.startswith("cuda"))
    by_kernel = Counter()
    kernel_ns = 0
    busy = 0
    merged = []
    for s, e, n in dev:
        if not n.startswith(("Memcpy", "Memset")):
            by_kernel[n[:160]] += e - s
            kernel_ns += e - s
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                busy += e - merged[-1][1]
                merged[-1][1] = e
                merged[-1][3] = n
        else:
            merged.append([s, e, n, n])
            busy += e - s
    idle = defaultdict(int)
    for prev, nxt in zip(merged, merged[1:]):
        idle[f"{_short(prev[3])} -> {_short(nxt[2])}"] += nxt[0] - prev[1]
    top_ops = [[n, v * 1e-9] for n, v in by_kernel.most_common(TOP)]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(window_s=window_s, busy_s=busy * 1e-9,
                kernel_s=kernel_ns * 1e-9, device_events=len(dev),
                device_ops=top_ops,
                idle_gaps=[[n, v * 1e-9] for n, v in top_idle])
