"""The per-layer metric ladder_work.ccsd_cycle, read from the program's
counter ladder.w_elems (source program_counter): a traced CPU run on
H2O/cc-pVDZ reports the dense ladder of one tile, an untraced run
nothing, and a traced window without the counter None.

Run from the checkout's root:  python -m pytest ccbench/tests -q
"""

import json
import os
import time

import pytest
import torch

from ccbench.harness import cell as cell_mod
from ccbench.harness import main

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
H2O = json.load(open(os.path.join(ROOT, "ccbench", "tests", "data",
                                  "h2o_vdz.json")))
METRIC = "ladder_work.ccsd_cycle"


def run_h2o(workload, trace):
    c = cell_mod.resolve(workload)
    c.config = H2O
    c.limits = {"compare": {k: {"limit": 1e-7} for k in c.limits["compare"]}}
    return main.run_cell(c, 1618033988749894, 0.0, trace,
                         torch.device("cpu"), time.perf_counter())


def test_traced_run_reports_the_ladder_work(cpu_budget):
    out = run_h2o("benzene_vtz.ccsd", trace=1)
    assert out["correct"]
    # H2O/cc-pVDZ plans one tile: the dense ladder, twice the
    # pair-symmetric minimum
    assert out["metrics"][METRIC]["value"] == pytest.approx(2.0)
    assert METRIC not in run_h2o("benzene_vtz.ccsd", trace=0)["metrics"]


def test_ladder_work_reads_none_without_the_counter():
    """A traced window whose program counts no ladder work (one that
    predates the counter) gives None, not an error."""
    from torch.profiler import ProfilerActivity, profile
    from pyscf_mpcc_tpu_torch.utils import profiling
    reader = cell_mod._load_module(
        os.path.join(ROOT, "ccbench", "metrics", METRIC + ".py"),
        "ladder_work")
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("ccsd.cycle", device=True):
            profiling.count("triples.tiles")
    rec = dict(trace=dict(window_s=1.0), shape=(10, 2, 5))
    assert reader.read(rec) is None
    assert reader.read(dict(shape=(10, 2, 5))) is None
