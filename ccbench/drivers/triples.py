"""Driver of (T) energies (traffic triples_energies).

Set-up builds the program's integrals, solves CCSD at the configuration's
tolerances (the amplitudes every (T) of the run is taken at) and warms up
with one whole (T), which builds the program's CUDA kernels on the first
run in a checkout.  One unit is ccsd_t.kernel(t1, t2, eris, tile=0) with
the program's defaults (engine 'auto').

Judged numbers (limits/<cell>.json names the ones a cell compares):

- triples_gap: the largest |E(T)_program - E(T)_reference| over the
  window's energies, E(T)_reference the reference's fp64 (T) at the
  program's amplitudes;
"""

from __future__ import annotations

import time

import torch

from ccbench.harness import port


def _triples(state):
    from pyscf_mpcc_tpu_torch.cc import ccsd_t
    return float(ccsd_t.kernel(state["t1"], state["t2"], state["er"],
                               tile=0))


def setup(ctx, inputs):
    er = port.build_eris(ctx, inputs)
    kw = port.solver_kw(ctx, er)
    conv, _, t1, t2, _, _ = port.ccsd(er, kw, ctx.config["ccsd"])
    if not conv:
        raise RuntimeError("the set-up CCSD did not converge")
    state = dict(er=er, t1=t1, t2=t2, energies=[])
    port.enter_timed(ctx)
    t0 = time.perf_counter()
    _triples(state)
    port.sync(ctx.device)
    ctx.rec["warmup_s"] = time.perf_counter() - t0
    return state


def unit(state, ctx):
    state["energies"].append(_triples(state))
    return dict(ok=True, count=dict(energy=1))


def probe(state, ctx):
    pass


def answers(state):
    return dict(t1=state["t1"], t2=state["t2"],
                energies=list(state["energies"]))


def judge(ctx, inputs, ans, names):
    from ccbench.reference import ccsd as ref
    from ccbench.reference import triples as ref_t
    ints = ref.mo_ints(inputs["B"], inputs["mo"], inputs["fock_ao"],
                       inputs["nocc"])
    t1 = ans["t1"].to(torch.float64)
    t2 = ans["t2"].to(torch.float64)
    out = {}
    if "triples_gap" in names:
        e = ref_t.energy(t1, t2, ints)
        out["triples_gap"] = max(abs(x - e) for x in ans["energies"])
    return out
