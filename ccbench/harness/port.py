"""The benchmark's calls into the program, pyscf_mpcc_tpu_torch: the
library entries the production campaigns use (examples/campaign.py), with
their solver settings planned as the campaigns plan them.

Nothing here computes what the program computes; it builds the program's
integrals from the benchmark's inputs, runs its solvers, and counts the
cycles the solvers print at verbose=5.
"""

from __future__ import annotations

import contextlib
import io
import time

import torch


class Lines(io.TextIOBase):
    """A solver's stdout, kept to count its cycle lines."""

    def __init__(self):
        self.text = []

    def write(self, s):
        self.text.append(s)
        return len(s)

    def count(self, key):
        return sum(key in ln for ln in "".join(self.text).splitlines())


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_eris(ctx, inputs):
    """cc/eris.make_eris_df of the inputs in the configuration's dtype,
    ovvv-free, as the campaigns build them; its seconds go to
    ctx.rec['eris_s']."""
    from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
    t0 = time.perf_counter()
    er = eris_mod.make_eris_df(inputs["B"], inputs["mo"], inputs["fock_ao"],
                               inputs["nocc"], dtype=ctx.dtype,
                               keep_ovvv=False, device=ctx.device)
    sync(ctx.device)
    ctx.rec["eris_s"] = time.perf_counter() - t0
    return er


def enter_timed(ctx):
    """Called by each driver before its warm-up: from here on the run is
    the timed path.  Under the correctness control (--control tf32) the
    timed path runs its fp32 GEMMs in TF32, the precision below the
    configuration's; set-up (the integrals, a set-up CCSD solve) stays in
    the configuration's precision."""
    if ctx.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")


def solver_kw(ctx, er, vjp=False, backend="device", fallback_space=3):
    """examples/campaign.plan_solver's settings for this problem: the
    device DIIS ring and the ladder tile planned on the budget less the
    ring (vjp=True for Lambda)."""
    from pyscf_mpcc_tpu_torch.examples import campaign
    naux, nocc, nvir = er.Lov.shape
    n = nocc * nvir + (nocc * nvir) ** 2
    return campaign.plan_solver(n, nocc, nvir, naux, ctx.dtype,
                                campaign.budget(ctx.device), backend,
                                fallback_space=fallback_space, vjp=vjp)


def ccsd(er, kw, tol):
    """rccsd.kernel from the MP2 guess.  Returns (converged, e_corr, t1,
    t2, cycles, the lines the solver printed)."""
    from pyscf_mpcc_tpu_torch.cc import rccsd
    out = Lines()
    with contextlib.redirect_stdout(out):
        conv, e, t1, t2 = rccsd.kernel(er, verbose=5, **tol,
                                       **kw)
    return (bool(conv), float(e), t1, t2, out.count("E_corr(RCCSD)"),
            "".join(out.text))


def lam(t1, t2, er, kw, tol):
    """lambda_ad.kernel from l = t.  Returns (converged, l1, l2, cycles)."""
    from pyscf_mpcc_tpu_torch.cc import lambda_ad
    out = Lines()
    with contextlib.redirect_stdout(out):
        conv, l1, l2 = lambda_ad.kernel(t1, t2, er, verbose=5, **tol,
                                        **kw)
    return bool(conv), l1, l2, out.count("lambda cycle")


def sweep_seconds(t1, t2, er, ntile, n=2):
    """Mean seconds of ``n`` rccsd.update_amps calls at (t1, t2), timed
    with CUDA events after one untimed call (with the host clock on a
    CPU, for the tests)."""
    from pyscf_mpcc_tpu_torch.cc import rccsd
    rccsd.update_amps(t1, t2, er, ntile=ntile)
    if t2.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            rccsd.update_amps(t1, t2, er, ntile=ntile)
        return (time.perf_counter() - t0) / n
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        rccsd.update_amps(t1, t2, er, ntile=ntile)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1000.0 / n
