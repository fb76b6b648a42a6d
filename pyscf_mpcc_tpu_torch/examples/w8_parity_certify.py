#!/usr/bin/env python
"""(H2O)8/cc-pVTZ frozen-core DF-CCSD certified on one card: the BASELINE
gate (|dE| <= 1e-7 Ha against fp64) at the width the port exists for.

    python -m pyscf_mpcc_tpu_torch.examples.w8_parity_certify              # CUDA
    python -m pyscf_mpcc_tpu_torch.examples.w8_parity_certify --reuse-scf  # from the checkpoint
    python -m pyscf_mpcc_tpu_torch.examples.w8_parity_certify --small --device cpu

The twin of the JAX package's examples/w8_parity_certify.py.  That script
runs its fp32 and fp64 stages in two subprocesses because JAX fixes x64
and the platform per process; torch holds both dtypes on one device, so
here the stages are plain functions run in one process:

1. ``build_mf`` (examples/campaign.py, as the rest of the stages'
   parts that the campaign scripts share): DF-RHF of the cube cluster (cc-pVTZ, cc-pVTZ-JKFIT,
   conv_tol 1e-10) on the port's gto/df/scf.  J and K contract in fp64:
   on the card (native fp64) when ``run`` is on CUDA, on the host
   otherwise.  An fp32 J/K could not reach the record's energy.
2. ``stage_fp32``: ovvv-free DF integrals of the frozen-core MOs in the
   working dtype (fp32 with TF32 off on the card), RCCSD to conv_tol 1e-6
   and conv_tol_normt 1.5e-4 (80 cycles at most), then Lambda to
   |dl| < 1e-4, both on the device DIIS ring.
3. The checkpoint, ``np.savez`` files under W8_SCRATCH (default
   .campaign/w8_parity/_torch, and its ``small`` subdirectory for
   --small): scf.npz (mo_full, fock_ao, B, e_scf, nelectron) and amps.npz
   (t1, t2, l1, l2, e32).  --reuse-scf starts from whichever exists.
4. ``certify``: the integrals rebuilt in fp64 on the same device from the
   same B, mo and fock, and one E_L = E(t) + <l, R(t)> of the upcast
   amplitudes.  (t, l) is a stationary point of the Lagrangian, so
   |E_L - E_exact| = O(|dt|^2 + |dl||dt|).

Sizes (campaign.plan_solver).  The ladder tile comes from
lib/memory.plan_ladder_tiles (vjp=True for Lambda), planned after the DIIS ring is set aside.  A ring of six
slots with errors in the working dtype is taken where it needs at most a
quarter of the device budget; otherwise the JAX script's recipe for a
16 GB chip, three slots (two for Lambda) with bf16 errors.  On a CPU
without config.MAX_MEMORY there is nothing to plan: one tile, six slots.

The JAX script's environment knobs keep their names and override the
planned values: W8_SCRATCH, W8_NTILE, W8_LAMBDA_NTILE, W8_DIIS_BACKEND
(device or host), W8_DIIS_SPACE, W8_DIIS_ERR_DTYPE (bfloat16, float32,
none), W8_CONV, W8_NORMT, W8_LAMBDA_CONV, W8_LAMBDA_MAXCYC,
W8_LAMBDA_DIIS_SPACE, W8_LAMBDA_DIIS_BACKEND, W8_LAMBDA_DIIS_ERR_DTYPE.
With the host ring the DIIS history spills to ccsd_diis.npz and
lambda_diis.npz beside the checkpoint and a rerun resumes from it.  The
certification runs where the solve ran, in native fp64, so the JAX
script's W8_STAGE64_BACKEND (its host and int8 emulation) has no
counterpart.

--small is (H2O)2/cc-pVDZ with weigend fitting and two O 1s frozen, as
examples/w8_ccsd_pipeline.py --small.  Progress goes to stderr; stdout
gets one JSON line of readings (``run``'s dict).
"""

import argparse
import itertools
import json
import os
import time

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.examples import campaign as cp
from pyscf_mpcc_tpu_torch.examples.campaign import (  # noqa: F401
    build_mf, certify)
from pyscf_mpcc_tpu_torch.lib import device as _dev

ROOT = cp.ROOT

# Hydrogen-bonded cubic (H2O)8 (the standard cube-cluster motif), a copy
# of examples/w8_ccsd_pipeline.py's _w8_cube: O on a 2.8 A cube, each of
# the 12 edges carries exactly one O-H...O hydrogen bond (donor assignment
# by backtracking; 4 double-donor + 4 single-donor waters, free H of
# single donors pointing outward).
_A = 2.8
_r_oh = 0.9572
_ang = 104.52 * np.pi / 180.0


def _w8_cube():
    corners = list(itertools.product((0, 1), repeat=3))
    edges = []
    for c in corners:
        for ax in range(3):
            n = list(c)
            n[ax] ^= 1
            n = tuple(n)
            if c < n:
                edges.append((c, n))
    don = {c: 0 for c in corners}
    choice = []

    def solve(i):
        if i == len(edges):
            return all(v in (1, 2) for v in don.values())
        u, v = edges[i]
        for d in (u, v):
            if don[d] < 2:
                don[d] += 1
                choice.append(d)
                if solve(i + 1):
                    return True
                don[d] -= 1
                choice.pop()
        return False

    assert solve(0)
    center = np.full(3, 0.5) * _A
    geom = []
    for c in corners:
        O = np.array(c, float) * _A
        dirs = [(np.array(v if u == c else u, float) * _A - O) / _A
                for i, (u, v) in enumerate(edges) if choice[i] == c]
        if len(dirs) == 1:
            e1 = dirs[0]
            out = O - center
            out /= np.linalg.norm(out)
            e2 = out - (out @ e1) * e1
            e2 /= np.linalg.norm(e2)
            dirs.append(np.cos(_ang) * e1 + np.sin(_ang) * e2)
        geom.append(["O", tuple(O)])
        geom += [["H", tuple(O + _r_oh * d)] for d in dirs]
    return geom


W8_GEOM = _w8_cube()

W2_GEOM = [["O", (0.0, 0.0, 0.0)], ["H", (0.757, 0.587, 0.0)],
           ["H", (-0.757, 0.587, 0.0)],
           ["O", (0.0, 0.0, 2.98)], ["H", (0.757, 0.587, 2.98)],
           ["H", (-0.757, 0.587, 2.98)]]

# (geometry, basis, auxiliary basis, frozen core) of the campaign and of
# --small
FULL = (W8_GEOM, "cc-pvtz", "cc-pvtz-jkfit", 8)
SMALL = (W2_GEOM, "cc-pvdz", "weigend", 2)

# the JAX package's campaign (docs/PARITY.md): DF-RHF energy (:63, :183),
# the certified E_corr (:21, round 4) and the TPU's raw fp32 fixed point
# (:22)
RECORD = dict(e_scf=-608.4722402812, e_corr=-2.1875497066,
              e32_tpu=-2.1875844002)


def _env(name, default, cast=str):
    v = os.environ.get(name, "")
    return cast(v) if v else default


def _solver(prefix, n, nocc, nvir, naux, dtype, budget, spill,
            backend="device", fallback_space=3, vjp=False):
    """campaign.plan_solver with the JAX script's knobs (prefix W8_ for
    CCSD, W8_LAMBDA_ for Lambda): DIIS_BACKEND, DIIS_SPACE,
    DIIS_ERR_DTYPE (a torch dtype name, or none for errors in the working
    dtype) and NTILE, each overriding the planned value where set."""
    override = {}
    if os.environ.get(prefix + "DIIS_SPACE"):
        override["space"] = int(os.environ[prefix + "DIIS_SPACE"])
    v = os.environ.get(prefix + "DIIS_ERR_DTYPE", "")
    if v:
        override["err_dtype"] = None if v == "none" else getattr(torch, v)
    if os.environ.get(prefix + "NTILE"):
        override["ntile"] = int(os.environ[prefix + "NTILE"])
    return cp.plan_solver(n, nocc, nvir, naux, dtype, budget,
                          backend=_env(prefix + "DIIS_BACKEND", backend),
                          fallback_space=fallback_space, vjp=vjp,
                          spill=spill, **override)


def stage_fp32(scf, frozen, device=None, dtype=None, scratch=None):
    """CCSD and Lambda of scf (the scf.npz dict) with ``frozen`` core
    orbitals, in ``dtype`` on ``device`` (lib/device.resolve: fp32 on
    CUDA), at the campaign's tolerances.  Raises if CCSD does not
    converge.  ``scratch``: where the host ring spills.  Returns (the
    amps.npz dict, readings)."""
    dev, dtype = _dev.resolve(device, dtype)
    cp.reset_peak(dev)
    er, out = cp.make_eris(scf, frozen, dtype, dev)
    nocc, nvir, naux = out["nocc"], out["nvir"], out["naux"]
    out["dtype"] = str(dtype)
    n = nocc * nvir + (nocc * nvir) ** 2
    budget = cp.budget(dev)
    kw = _solver("W8_", n, nocc, nvir, naux, dtype, budget,
                 scratch and os.path.join(scratch, "ccsd_diis.npz"))
    cp.log(f"{dtype} eris: nocc={nocc} nvir={nvir} naux={naux} "
           f"({out['eris_s']:.1f} s); CCSD {cp.settings(kw)}")
    t1, t2, r = cp.solve_ccsd(
        er, kw, conv_tol=_env("W8_CONV", 1e-6, float),
        conv_tol_normt=_env("W8_NORMT", 1.5e-4, float), max_cycle=80)
    out.update(r)
    if not out["ccsd_converged"]:
        raise RuntimeError(f"CCSD did not converge: {out}")

    lkw = _solver("W8_LAMBDA_", n, nocc, nvir, naux, dtype, budget,
                  scratch and os.path.join(scratch, "lambda_diis.npz"),
                  backend=kw["diis_backend"], fallback_space=2, vjp=True)
    cp.log(f"E_corr({dtype}) = {out['e32']:.10f} in {out['ccsd_cycles']} "
           f"cycles; Lambda {cp.settings(lkw)}")
    l1, l2, r = cp.solve_lambda(
        t1, t2, er, lkw, conv_tol=_env("W8_LAMBDA_CONV", 1e-4, float),
        max_cycle=_env("W8_LAMBDA_MAXCYC", 80, int))
    out.update(r)
    return cp.amplitudes(t1, t2, l1, l2, out["e32"]), out


def default_scratch(small=False):
    """The checkpoint directory: W8_SCRATCH, by default
    .campaign/w8_parity/_torch, and its ``small`` subdirectory for
    --small."""
    scratch = _env("W8_SCRATCH", os.path.join(ROOT, ".campaign",
                                              "w8_parity", "_torch"))
    return os.path.join(scratch, "small") if small else scratch


def run(device=None, dtype=None, small=False, reuse_scf=False, scratch=None):
    """The campaign on ``device`` (default the card; lib/device.resolve
    raises without one): SCF, the ``dtype`` solve, the checkpoint and the
    fp64 certification.  reuse_scf starts from the checkpoint files in
    ``scratch`` (default W8_SCRATCH) that exist.  Returns the readings."""
    dev, dtype = _dev.resolve(device, dtype)
    geom, basis, auxbasis, frozen = SMALL if small else FULL
    scratch = scratch or default_scratch(small)
    os.makedirs(scratch, exist_ok=True)
    scf_path = os.path.join(scratch, "scf.npz")
    amps_path = os.path.join(scratch, "amps.npz")
    out = dict(system=f"{'(H2O)2' if small else '(H2O)8'}/{basis} "
               f"frozen core {frozen}, {auxbasis} fitting",
               device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"), scratch=scratch)
    t_all, ckpt_s = time.perf_counter(), 0.0

    if reuse_scf and os.path.exists(scf_path):
        scf = cp.npz(scf_path)
        out.update(scf_reused=True, e_scf=float(scf["e_scf"]),
                   nao=scf["B"].shape[1], naux=scf["B"].shape[0])
        cp.log(f"SCF reused: E = {out['e_scf']:.10f}")
    else:
        cp.reset_peak(dev)
        scf, r = cp.build_mf(geom, basis, auxbasis,
                          jk_device=dev if dev.type == "cuda" else None)
        out.update(r, scf_reused=False, peak_scf_gib=cp.peak_gib(dev))
        t0 = time.perf_counter()
        np.savez(scf_path, **scf)
        ckpt_s += time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    if reuse_scf and os.path.exists(amps_path):
        amps = cp.npz(amps_path)
        out.update(amps_reused=True, e32=float(amps["e32"]))
        cp.log(f"amplitudes reused: E_corr = {out['e32']:.10f}")
    else:
        amps, r = stage_fp32(scf, frozen, dev, dtype, scratch=scratch)
        out.update(r, amps_reused=False)
        t0 = time.perf_counter()
        np.savez(amps_path, **amps)
        ckpt_s += time.perf_counter() - t0
    out.update(nocc=amps["t1"].shape[0], nvir=amps["t1"].shape[1])

    e_lagr, r = cp.certify(scf, amps, frozen, dev)
    out.update(r)
    out["raw_gap"] = abs(out["e32"] - e_lagr)
    if not small:
        out.update(d_scf_vs_record=out["e_scf"] - RECORD["e_scf"],
                   d_certified_vs_record=e_lagr - RECORD["e_corr"],
                   d_e32_vs_tpu_record=out["e32"] - RECORD["e32_tpu"])
    out.update(checkpoint_s=ckpt_s, wall_s=time.perf_counter() - t_all)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    ap.add_argument("--small", action="store_true",
                    help="(H2O)2/cc-pVDZ, weigend fitting, 2 frozen")
    ap.add_argument("--reuse-scf", action="store_true",
                    help="start from the checkpoint files that exist")
    args = ap.parse_args(argv)
    dtype = None if args.dtype is None else getattr(torch, args.dtype)
    out = run(torch.device(args.device), dtype, small=args.small,
              reuse_scf=args.reuse_scf)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
