"""Driver of converged Lambda solves (traffic lambda_cycles).

Set-up builds the program's integrals, solves CCSD at the configuration's
tolerances (the amplitudes every Lambda solve of the run starts from),
plans the Lambda solver as examples/campaign.py's plan_solver does for the
campaigns (the device ring, at most two slots where six do not fit, the
ladder tile planned for the vjp), and warms up with a one-cycle Lambda
solve.  One unit is lambda_ad.kernel from l = t to the configuration's
tolerance; it counts as one solve and as the cycles the solver printed.

Judged numbers (limits/<cell>.json names the ones a cell compares):

- lambda_step: |res1/D1| + |res2/D2| of the reference's fp64 Lambda
  residual (the gradient of E(t) + <l, R(t)>) at the program's amplitudes
  and the window's last multipliers, the length of one Jacobi step;
- lambda_step_doubles: its doubles part |res2/D2| alone;
"""

from __future__ import annotations

import time

import torch

from ccbench.harness import port


def setup(ctx, inputs):
    er = port.build_eris(ctx, inputs)
    kw = port.solver_kw(ctx, er)
    conv, _, t1, t2, _, _ = port.ccsd(er, kw, ctx.config["ccsd"])
    if not conv:
        raise RuntimeError("the set-up CCSD did not converge")
    lkw = port.solver_kw(ctx, er, vjp=True, backend=kw["diis_backend"],
                         fallback_space=2)
    port.enter_timed(ctx)
    t0 = time.perf_counter()
    port.lam(t1, t2, er, lkw, dict(ctx.config["lambda"], max_cycle=1))
    port.sync(ctx.device)
    ctx.rec["warmup_s"] = time.perf_counter() - t0
    return dict(er=er, kw=kw, lkw=lkw, t1=t1, t2=t2, mult=None)


def unit(state, ctx):
    conv, l1, l2, cycles = port.lam(state["t1"], state["t2"], state["er"],
                                    state["lkw"], ctx.config["lambda"])
    state["mult"] = (l1, l2)
    ctx.rec.setdefault("cycles", []).append(cycles)
    return dict(ok=conv, count=dict(solve=1, cycle=cycles))


def probe(state, ctx):
    """Trace run only: CCSD sweeps at the amplitudes, the unit that the
    Lambda cycle is counted in."""
    ctx.rec["sweep_s"] = port.sweep_seconds(state["t1"], state["t2"],
                                            state["er"], state["kw"]["ntile"])


def answers(state):
    l1, l2 = state["mult"]
    return dict(t1=state["t1"], t2=state["t2"], l1=l1, l2=l2)


def judge(ctx, inputs, ans, names):
    from ccbench.reference import ccsd as ref
    ints = ref.mo_ints(inputs["B"], inputs["mo"], inputs["fock_ao"],
                       inputs["nocc"])
    t1 = ans["t1"].to(torch.float64)
    t2 = ans["t2"].to(torch.float64)
    out = {}
    if names & {"lambda_step", "lambda_step_doubles"}:
        res1, res2 = ref.lambda_residual(t1, t2, ans["l1"], ans["l2"], ints)
        out["lambda_step"] = ref.step_norm(res1, res2, ints)
        out["lambda_step_doubles"] = float(torch.linalg.norm(
            res2 / ref.denominators(ints)[1]))
    return out
