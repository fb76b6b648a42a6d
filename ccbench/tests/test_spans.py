"""The per-layer metrics read from the program's own spans
(harness/spans.py, source program_span): a traced CPU run of each kind
of cell on H2O/cc-pVDZ reports them, with the numbers the program's
loops must give, and an untraced run none.

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
CCSD_SPANS = {"sweep_dev_s.ccsd_cycle", "diis_s.ccsd_cycle",
              "loop_self_s.ccsd_cycle", "host_syncs.ccsd_cycle"}
LAMBDA_SPANS = {"ladder_vjp_s.lambda_cycle", "diis_s.lambda_cycle"}


def run_h2o(workload, trace):
    c = cell_mod.resolve(workload)
    c.config = H2O
    c.limits = {"compare": {k: {"limit": 1e-7} for k in c.limits["compare"]}}
    return main.run_cell(c, 1618033988749894, 0.0, trace,
                         torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("workload,names", [
    ("benzene_vtz.ccsd", CCSD_SPANS), ("w8_vtz.lambda", LAMBDA_SPANS)])
def test_traced_run_reports_the_program_spans(workload, names, cpu_budget):
    out = run_h2o(workload, trace=1)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert names <= set(m)
    if workload == "benzene_vtz.ccsd":
        cycles = m["ccsd_cycles.ccsd_cycle"]
        # four blocking reads a cycle and two a solve, one solve traced
        assert m["host_syncs.ccsd_cycle"] == pytest.approx(4 + 2 / cycles)
        assert 0 < m["diis_s.ccsd_cycle"] < m["sweep_dev_s.ccsd_cycle"]
        assert 0 < m["loop_self_s.ccsd_cycle"]
    else:
        assert 0 < m["diis_s.lambda_cycle"] < m["ladder_vjp_s.lambda_cycle"]


def test_untraced_run_reports_no_span_metric(cpu_budget):
    out = run_h2o("benzene_vtz.ccsd", trace=0)
    assert not set(out["metrics"]) & CCSD_SPANS
