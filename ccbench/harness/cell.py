"""Resolve a benchmark cell from its entry in BENCHMARK.json to its files.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one per-layer metric is a file of its own, found by name:

- ``configs/<config>.json``: the molecule, basis, fitting, frozen core,
  working dtype and the campaign's solver tolerances;
- ``traffic/<traffic>.json``: the work unit and the driver that runs it
  (``drivers/<driver>.py``);
- ``limits/<workload>.json``: the numbers compared to decide ``correct``,
  each with its limit;
- ``metrics/<metric>.py``: one reader per per-layer metric.

So a cell is added by adding files and one entry, never by editing a file
that is already there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    driver: object
    end_to_end: list          # the BENCHMARK.json entries this cell reports
    per_layer: list
    readers: dict = field(default_factory=dict)


def benchmark_path(bench_dir=HERE):
    return os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json")


def _reports(metric, workload):
    wl = metric.get("workloads")
    return wl is None or workload in wl


def resolve(workload, bench=None, bench_dir=HERE):
    """The Cell named ``workload``: its entry in ``bench`` (the parsed
    BENCHMARK.json, read from beside ``bench_dir`` when None) with its
    files under ``bench_dir``."""
    if bench is None:
        bench = _load_json(benchmark_path(bench_dir))
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(entries)})")
    w = entries[workload]
    config = _load_json(os.path.join(bench_dir, "configs",
                                     w["config"] + ".json"))
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      w["traffic"] + ".json"))
    limits = _load_json(os.path.join(bench_dir, "limits", workload + ".json"))
    driver = _load_module(os.path.join(bench_dir, "drivers",
                                       traffic["driver"] + ".py"),
                          "ccbench_driver_" + traffic["driver"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in names)]
    readers = {m["name"]: _load_module(
        os.path.join(bench_dir, "metrics", m["name"] + ".py"),
        "ccbench_metric_" + m["name"].replace(".", "_")) for m in per_layer}
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, driver=driver,
                end_to_end=e2e, per_layer=per_layer, readers=readers)
