"""Driver of converged CCSD solves (traffic ccsd_cycles, ccsd_solves).

Set-up builds the program's integrals from the benchmark's inputs, plans
the solver as the campaigns do and warms up with a one-cycle solve.  One
unit is rccsd.kernel from the MP2 guess to the configuration's
tolerances; it counts as one solve and as the cycles the solver printed.

Judged numbers (limits/<cell>.json names the ones a cell compares):

- ccsd_step: |R1/D1| + |R2/D2| of the reference's fp64 residual at the
  program's final amplitudes (the last solve of the window), the length
  of one Jacobi step from them;
- ccsd_energy_gap: the largest |E_program - E_reference| over the
  window's solves, E_reference from the reference's own fp64 solve from
  the benchmark's inputs, to a step under 1e-8.
"""

from __future__ import annotations

import sys
import time

import torch

from ccbench.harness import port


def setup(ctx, inputs):
    er = port.build_eris(ctx, inputs)
    kw = port.solver_kw(ctx, er)
    port.enter_timed(ctx)
    t0 = time.perf_counter()
    port.ccsd(er, kw, dict(ctx.config["ccsd"], max_cycle=1))
    port.sync(ctx.device)
    ctx.rec["warmup_s"] = time.perf_counter() - t0
    return dict(er=er, kw=kw, energies=[], amps=None)


def unit(state, ctx):
    conv, e, t1, t2, cycles, lines = port.ccsd(state["er"], state["kw"],
                                               ctx.config["ccsd"])
    state["energies"].append(e)
    state["lines"] = lines
    state["amps"] = (t1, t2)
    ctx.rec.setdefault("cycles", []).append(cycles)
    return dict(ok=conv, count=dict(solve=1, cycle=cycles))


def probe(state, ctx):
    """Trace run only: a few sweeps at the window's last amplitudes."""
    t1, t2 = state["amps"]
    ctx.rec["sweep_s"] = port.sweep_seconds(t1, t2, state["er"],
                                            state["kw"]["ntile"])


def answers(state):
    print(state["lines"], file=sys.stderr, end="")
    t1, t2 = state["amps"]
    return dict(t1=t1, t2=t2, energies=list(state["energies"]))


def judge(ctx, inputs, ans, names):
    from ccbench.reference import ccsd as ref
    ints = ref.mo_ints(inputs["B"], inputs["mo"], inputs["fock_ao"],
                       inputs["nocc"])
    t1 = ans["t1"].to(torch.float64)
    t2 = ans["t2"].to(torch.float64)
    out = {}
    if "ccsd_step" in names:
        out["ccsd_step"] = ref.step_norm(*ref.residual(t1, t2, ints), ints)
    if "ccsd_energy_gap" in names:
        del t1, t2
        e, _, _, cycles = ref.solve(ints)
        ctx.rec["reference_detail"] = f"reference solve: {cycles} cycles"
        out["ccsd_energy_gap"] = max(abs(x - e)
                                            for x in ans["energies"])
    return out
