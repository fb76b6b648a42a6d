"""Tracing and utilization reporting.

Port of ``pyscf_mpcc_tpu/utils/profiling.py``: wall timers live in
lib.logger; this module adds a ``torch.profiler`` trace context (a Chrome
trace of the host and, on a card, the device) and utilization reporting
against an analytic FLOP model.
"""

from __future__ import annotations

import contextlib
import os
import time

# dense peak rates of one NVIDIA H100 SXM at its 700 W power limit
# (NVIDIA's data sheet, without sparsity), TFLOP/s, for utilization
# percentages; a card set to a lower power limit runs slower under load
PEAK_TFLOPS = {
    "h100-fp64": 67.0,    # FP64 tensor cores
    "h100-fp32": 67.0,    # float32 outside the tensor cores
    "h100-tf32": 495.0,
    "h100-bf16": 989.0,
}


@contextlib.contextmanager
def trace(logdir="profile"):
    """Capture a ``torch.profiler`` trace of the enclosed block (CPU, and
    CUDA where a card is present) and write it as a Chrome trace
    ``trace.json`` under ``logdir`` (relative to the working directory).
    Yields the profiler, whose ``key_averages()`` sums time by kernel."""
    import torch
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
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def report_utilization(flops, label="kernel", peak="h100-fp32", log=None):
    """Time the enclosed block and report achieved TFLOP/s and its
    fraction of ``peak`` (a PEAK_TFLOPS key).  The clock stops after a
    ``torch.cuda.synchronize()`` when a card is present, so the time is
    the device's, not the enqueue's.

    flops: analytic count (e.g. cc.rccsd.flops_per_update)."""
    import torch
    sync = torch.cuda.synchronize if torch.cuda.is_available() else None
    if sync:
        sync()
    t0 = time.perf_counter()
    yield
    if sync:
        sync()
    dt = time.perf_counter() - t0
    tflops = flops / dt / 1e12
    frac = tflops / PEAK_TFLOPS.get(peak, float("inf"))
    msg = (f"{label}: {dt:.3f} s, {tflops:.2f} TFLOP/s "
           f"({100 * frac:.1f}% of {peak} peak)")
    if log is not None:
        log.info(msg)
    else:
        print(msg, flush=True)
