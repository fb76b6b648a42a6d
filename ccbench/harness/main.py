"""One run of one cell: set-up, the measured window, the check of what the
window produced against the plain reference, and the result line.

    python3 ccbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in setup_s, from the process start to the first measured
unit): the benchmark's inputs from the seed (inputmaker/), then the
driver's set-up, which builds the program's integrals and whatever the
unit starts from, and warms up every shape the unit uses.  The window runs
units back to back, a closed loop: one caller waits for each result.  A
unit still running when ``--seconds`` ends runs to its end and is counted.
The end-to-end time per unit is the whole window over all the units in it.

With ``--trace 1`` the window is the traffic's ``trace_units`` units under
the profiler (harness/devtrace.py), then the driver's probes run, and the
per-layer metrics are read from what was recorded (metrics/<name>.py).

Once the window has closed and the device peak is read, the program's
state is freed and the driver's ``judge`` runs the reference on the
benchmark's inputs; ``correct`` holds when every unit succeeded and every
number the cell's limits file names is at most its limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "pyscf_mpcc_tpu")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level names in sys.modules that a run may not load, compared
    whole (pyscf_mpcc_tpu_torch is not pyscf_mpcc_tpu)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32",), default=None,
                   help="run the program in the precision below the "
                   "configuration's (the correctness control; the "
                   "benchmark's own runs never pass it)")
    return p.parse_args(argv)


def run_cell(cell, seed, seconds, trace, device, t_start, control=None):
    """Run one cell on ``device`` and return the result dict (the last
    line's object).  Works on a CPU device too, for the tests: there the
    device numbers are left out."""
    import torch
    from ccbench.harness import devtrace
    from ccbench.inputmaker import scf

    cuda = device.type == "cuda"
    rec = {}
    ctx = SimpleNamespace(config=cell.config, traffic=cell.traffic,
                          device=device, rec=rec, control=control,
                          dtype=getattr(torch, cell.config["dtype"]))
    inputs = scf.make_inputs(cell.config, seed, device)
    log(f"inputs: nao {inputs['nao']} naux {inputs['naux']} nocc "
        f"{inputs['nocc']} frozen {inputs['frozen']}; E_SCF "
        f"{inputs['e_scf']:.10f} in {inputs['scf_cycles']} cycles; "
        f"molecule {inputs['mol_s']:.2f} s, DF factors {inputs['df_s']:.2f}"
        f" s, SCF {inputs['scf_s']:.2f} s")
    state = cell.driver.setup(ctx, inputs)
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    rec["setup_s"] = time.perf_counter() - t_start
    log(f"set-up {rec['setup_s']:.3f} s (eris {rec['eris_s']:.3f} s, "
        f"warm-up {rec['warmup_s']:.3f} s)")

    units = []
    if trace:
        with devtrace.Window(device) as win:
            for _ in range(int(cell.traffic.get("trace_units", 1))):
                units.append(cell.driver.unit(state, ctx))
        rec["trace"] = win.result
        window_s = win.result["window_s"]
    else:
        t0 = time.perf_counter()
        ends = []
        while True:
            units.append(cell.driver.unit(state, ctx))
            if cuda:
                torch.cuda.synchronize(device)
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        window_s = ends[-1]
        log("unit seconds " + " ".join(
            f"{b - a:.3f}" for a, b in zip([0.0] + ends, ends)))
    per = cell.traffic["per"]
    n = sum(u["count"][per] for u in units)
    rec.update(window_s=window_s, units=units, per_unit_s=window_s / n,
               shape=tuple(state["er"].Lov.shape))
    log(f"window {window_s:.3f} s: {len(units)} units, {n} {per}s, "
        f"{rec['per_unit_s']:.6f} s a {per}; cycles {rec.get('cycles')}")
    peak = None
    if cuda:
        rec["peak_window_bytes"] = torch.cuda.max_memory_allocated(device)
        peak = max(setup_peak, rec["peak_window_bytes"])
    if trace:
        cell.driver.probe(state, ctx)

    ans = cell.driver.answers(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = cell.driver.judge(ctx, inputs, ans, set(cell.limits["compare"]))
    log(f"reference check {time.perf_counter() - t0:.3f} s "
        f"{ctx.rec.get('reference_detail', '')}")
    failed = sum(not u["ok"] for u in units)
    checks = {k: dict(value=numbers[k], limit=v["limit"])
              for k, v in cell.limits["compare"].items()}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(rec)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        values = {"setup_s": rec["setup_s"],
                  cell.traffic["metric"]: rec["per_unit_s"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    out = dict(correct=bool(correct), attempted=len(units), failed=failed,
               metrics=metrics)
    if cuda:
        out["device"] = dict(platform="gpu",
                             kind=torch.cuda.get_device_name(device),
                             count=cell.chips, memory_peak_bytes=peak)
        if trace:
            out["device"].update(busy_s=rec["trace"]["busy_s"],
                                 window_s=rec["trace"]["window_s"])
            out["breakdown"] = dict(device_ops=rec["trace"]["device_ops"],
                                    idle_gaps=rec["trace"]["idle_gaps"])
    out["checks"] = checks
    return out


def main(argv, t_start):
    args = parse(argv)
    import torch
    from ccbench.harness import cell as cell_mod

    cell = cell_mod.resolve(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"the cell needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} are visible")
        return 3
    log(f"card: {power_limit()}")
    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seed, args.seconds, args.trace, device,
                   t_start, control=args.control)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in this process: {', '.join(bad)}")
        return 4
    for name, c in out["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0
