#!/usr/bin/env python
"""(H2O)8/aug-cc-pVTZ frozen-core DF-CCSD on one card with Lvv streamed
from host memory, certified by the fp64 Lagrangian energy.

    python -m pyscf_mpcc_tpu_torch.examples.w8aug_stream_certify            # both stages, CUDA
    python -m pyscf_mpcc_tpu_torch.examples.w8aug_stream_certify --stage32  # SCF, CCSD, Lambda
    python -m pyscf_mpcc_tpu_torch.examples.w8aug_stream_certify --stage64  # certification

The twin of the JAX package's examples/w8aug_stream_certify.py.  The shape
is nocc 32 (8 O 1s frozen), nvir 696, nao 736, aug-cc-pVTZ-JKFIT fitting:
Lvv alone is 3.04 GB in fp32.  The JAX script exists because the resident
update did not fit a 16 GB chip; an 80 GB card holds it (the capacity
record below says by how much), and the twin still runs the streamed path
as the JAX script does: make_eris_df(stream_vv=True) keeps Lvv in a
pinned host store (lib/hoststore) and the ladder pulls its row tiles
(cc/stream_ladder).  The JAX script runs its two stages in two
subprocesses because JAX fixes x64 per process; torch holds both dtypes
on one device, so without flags both stages run in one process.

1. The SCF (``scf_stage``): the DF-RHF through campaign.build_mf
   (conv_tol 1e-10, tighter than the JAX script's 1e-9), J and K in fp64
   on the card when the run is on CUDA.  Checkpoint scf.npz (mo_full,
   fock_ao, B, e_scf, nelectron), reused when it exists.
2. ``stage_fp32``: the streamed ovvv-free integrals in the working dtype
   (fp32 with TF32 off on the card), RCCSD (conv_tol 1e-6,
   conv_tol_normt 1.5e-4, 60 cycles at most) on the device DIIS ring of
   3 slots with bf16 errors at ladder ntile 16, then Lambda (conv_tol
   3e-4, 40 cycles at most, 2 slots).  The CCSD amplitudes go to
   amps_t.npz (t1, t2, e32) and a rerun resumes after CCSD from it; then
   amps.npz (t1, t2, l1, l2, e32).  Either solve not converging raises.
3. The capacity record (``capacity_record``): the JAX script's model,
   lib/memory.ccsd_working_set_bytes resident and streamed plus its
   device ring, beside the device budget (lib/memory.hbm_budget_bytes,
   where the JAX script had 16 GiB) and each stage's measured peak.
4. ``stage_fp64``: the integrals rebuilt in native fp64 on the same
   device from the same B, mo and fock, Lvv streamed as in the solve,
   and one E_L = E(t) + <l, R(t)> of the upcast amplitudes
   (campaign.certify, ladder tile planned).  Resident fp64 does not fit
   an 80 GB card at this shape: at the planner's ntile 14 it ran out of
   memory with 59.3 GiB allocated; streamed it peaks at 53.6 GiB.

Not ported: the JAX script's io_callback probe, which checks for a limit
of the TPU runtime (the port streams with CUDA copies, not host
callbacks), and its default int8 Ozaki certification: W8_STAGE64_BACKEND
=ozaki raises (the port's fp64 is native, ROADMAP north star rule 3);
=host certifies on the CPU.

The JAX script's environment knobs keep their names and override the
defaults: W8AUG_SCRATCH (default .campaign/w8aug_stream/_torch),
W8AUG_NTILE, W8AUG_CONV, W8AUG_NORMT, W8AUG_DIIS_BACKEND (device or
host), W8AUG_DIIS_SPACE, W8AUG_LAMBDA_CONV, W8AUG_LAMBDA_MAXCYC.

``run`` takes the molecule, basis, fitting basis and frozen count as
arguments (the campaign's by default).  Progress goes to stderr; stdout
gets the ``W8AUG capacity {json}`` line and one ``W8AUG {json}`` line a
stage.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.examples import campaign as cp
from pyscf_mpcc_tpu_torch.examples.w8_parity_certify import W8_GEOM, _env
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.lib import memory as _mem

FROZEN = 8
BASIS = "aug-cc-pvtz"
AUXBASIS = "aug-cc-pvtz-jkfit"

# the port's own values: this campaign never ran in the JAX package (its
# resident update did not fit the TPU and the TPU runtime rejected the
# streamed path's host callbacks), so there is no record.  E_SCF: the
# DF-RHF of scf_stage on an NVIDIA H100 80GB HBM3 (J/K fp64 on the card;
# 12 cycles, S's smallest eigenvalue 1.83e-5), the first E_SCF of this
# molecule in either package
PINS = dict(e_scf=-608.4838869346906)

# the JAX script's defaults
CCSD_TOL = dict(conv_tol=1e-6, conv_tol_normt=1.5e-4, max_cycle=60)
LAMBDA_TOL = dict(conv_tol=3e-4, max_cycle=40)
NTILE, CCSD_SPACE, LAMBDA_SPACE = 16, 3, 2


def default_scratch():
    return _env("W8AUG_SCRATCH", os.path.join(cp.ROOT, ".campaign",
                                              "w8aug_stream", "_torch"))


def _is_campaign(geom, basis, auxbasis):
    return (geom, basis, auxbasis) == (W8_GEOM, BASIS, AUXBASIS)


def scf_stage(device=None, scratch=None, geom=W8_GEOM, basis=BASIS,
              auxbasis=AUXBASIS):
    """The SCF checkpoint dict and readings: scratch/scf.npz where it
    exists, else campaign.build_mf (J/K in fp64 on ``device`` when it is
    the card), saved to scratch/scf.npz when ``scratch`` is given."""
    dev, _ = _dev.resolve(device)
    path = scratch and os.path.join(scratch, "scf.npz")
    t0 = time.perf_counter()
    if path and os.path.exists(path):
        scf = cp.npz(path)
        out = dict(scf_reused=True, nao=scf["B"].shape[1],
                   naux=scf["B"].shape[0])
        cp.log(f"SCF reused: E = {float(scf['e_scf']):.10f}")
    else:
        cp.reset_peak(dev)
        scf, out = cp.build_mf(geom, basis, auxbasis,
                               jk_device=dev if dev.type == "cuda" else None)
        out.update(scf_reused=False, peak_scf_gib=cp.peak_gib(dev))
        if path:
            os.makedirs(scratch, exist_ok=True)
            np.savez(path, **scf)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out.update(e_scf=float(scf["e_scf"]), scf_stage_s=time.perf_counter() - t0)
    if _is_campaign(geom, basis, auxbasis) and PINS["e_scf"] is not None:
        out["d_scf_vs_pin"] = out["e_scf"] - PINS["e_scf"]
    return scf, out


def capacity_record(nocc, nvir, naux, ntile, budget=None, peaks=None):
    """The JAX script's capacity model at ladder ``ntile``: the resident
    and streamed working sets (lib/memory.ccsd_working_set_bytes, fp32)
    and its device ring (3 slots, errors in bf16), in GiB, beside the
    device ``budget`` (bytes; None where there is none) and the measured
    ``peaks`` (GiB by stage).  Printed as the ``W8AUG capacity`` line."""
    gib = 2.0 ** 30
    resident = _mem.ccsd_working_set_bytes(nocc, nvir, naux, ntile=ntile)
    streamed = _mem.ccsd_working_set_bytes(nocc, nvir, naux, ntile=ntile,
                                           stream_vv=True)
    t_sz = (nocc * nvir + nocc * nocc * nvir * nvir) * 4
    ring = 3 * (t_sz + t_sz // 2)
    rec = dict(ntile=ntile, resident_model_gib=resident / gib,
               ring_gib=ring / gib,
               resident_total_gib=(resident + ring) / gib,
               streamed_model_gib=(streamed + ring) / gib,
               budget_gib=None if budget is None else budget / gib,
               resident_fits=(None if budget is None
                              else resident + ring <= budget),
               peak_gib=dict(peaks or {}))
    print("W8AUG capacity " + json.dumps(rec), flush=True)
    return rec


def _solver(n, nocc, nvir, naux, dtype, budget, lam=False):
    """campaign.plan_solver at the JAX script's settings, its knobs
    applied: the ring's backend (W8AUG_DIIS_BACKEND) and slots (3 for
    CCSD, W8AUG_DIIS_SPACE; 2 for Lambda), bf16 errors on the device
    ring, ladder ntile 16 (W8AUG_NTILE)."""
    space = LAMBDA_SPACE if lam else _env("W8AUG_DIIS_SPACE", CCSD_SPACE,
                                           int)
    return cp.plan_solver(n, nocc, nvir, naux, dtype, budget,
                          backend=_env("W8AUG_DIIS_BACKEND", "device"),
                          space=space, err_dtype=torch.bfloat16,
                          ntile=_env("W8AUG_NTILE", NTILE, int))


def stage_fp32(scf, frozen=FROZEN, device=None, dtype=None, scratch=None):
    """Streamed CCSD and Lambda of scf (the scf.npz dict) with ``frozen``
    core orbitals, in ``dtype`` on ``device`` (fp32 on CUDA), resuming
    after CCSD from scratch/amps_t.npz where it exists (and writing it
    otherwise, when ``scratch`` is given).  Raises if a solve does not
    converge.  Returns (the amps.npz dict, readings)."""
    dev, dtype = _dev.resolve(device, dtype)
    nocc = int(scf["nelectron"]) // 2 - frozen
    naux, nmo = scf["B"].shape[0], scf["mo_full"].shape[1]
    nvir = nmo - frozen - nocc
    n = nocc * nvir + (nocc * nvir) ** 2
    budget = cp.budget(dev)
    kw = _solver(n, nocc, nvir, naux, dtype, budget)
    cp.reset_peak(dev)
    er, out = cp.make_eris(scf, frozen, dtype, dev, stream_vv=True)
    store = er.Lvv_stream
    peaks = dict(eris=cp.peak_gib(dev))
    out.update(dtype=str(dtype), store_gb=store.nbytes / 1e9)
    cp.log(f"STREAMED {dtype} eris: nocc={nocc} nvir={nvir} naux={naux} "
           f"({out['eris_s']:.1f} s, Lvv {out['store_gb']:.2f} GB in host "
           f"memory); CCSD {cp.settings(kw)}")

    t_path = scratch and os.path.join(scratch, "amps_t.npz")
    if t_path and os.path.exists(t_path):
        zt = cp.npz(t_path)
        t1, t2 = (torch.as_tensor(zt[k]).to(dev, dtype) for k in ("t1", "t2"))
        out.update(ccsd_reused=True, ccsd_converged=True,
                   e32=float(zt["e32"]))
        cp.log(f"CCSD amplitudes reused: E_corr = {out['e32']:.10f}")
    else:
        tol = dict(CCSD_TOL, conv_tol=_env("W8AUG_CONV", CCSD_TOL[
            "conv_tol"], float), conv_tol_normt=_env(
            "W8AUG_NORMT", CCSD_TOL["conv_tol_normt"], float))
        b0 = store.bytes_moved
        t1, t2, r = cp.solve_ccsd(er, kw, **tol)
        moved = (store.bytes_moved - b0) / 1e9
        out.update(r, ccsd_reused=False, ccsd_h2d_gb=moved,
                   h2d_gb_per_sweep=moved / max(r["ccsd_cycles"], 1))
        peaks["ccsd"] = r["peak_ccsd_gib"]
        cp.log(f"E_corr(CCSD, streamed, {dtype}) = {out['e32']:.10f} in "
               f"{r['ccsd_cycles']} cycles ({r['ccsd_s']:.1f} s, "
               f"{out['h2d_gb_per_sweep']:.2f} GB host -> device a sweep)")
        if not r["ccsd_converged"]:
            raise RuntimeError(f"CCSD did not converge: {out}")
        if t_path:
            np.savez(t_path, t1=t1.cpu().numpy(), t2=t2.cpu().numpy(),
                     e32=np.float64(out["e32"]))

    lkw = _solver(n, nocc, nvir, naux, dtype, budget, lam=True)
    tol = dict(conv_tol=_env("W8AUG_LAMBDA_CONV", LAMBDA_TOL["conv_tol"],
                             float),
               max_cycle=_env("W8AUG_LAMBDA_MAXCYC", LAMBDA_TOL["max_cycle"],
                              int))
    b0 = store.bytes_moved
    l1, l2, r = cp.solve_lambda(t1, t2, er, lkw, **tol)
    out.update(r, lambda_h2d_gb=(store.bytes_moved - b0) / 1e9)
    peaks["lambda"] = r["peak_lambda_gib"]
    cp.log(f"Lambda converged={r['lambda_converged']} in "
           f"{r['lambda_cycles']} cycles ({r['lambda_s']:.1f} s)")
    if not r["lambda_converged"]:
        raise RuntimeError(f"Lambda did not converge: {out}")
    out["capacity"] = capacity_record(nocc, nvir, naux, kw["ntile"], budget,
                                      peaks)
    return cp.amplitudes(t1, t2, l1, l2, out["e32"]), out


def stage_fp64(scf, amps, frozen=FROZEN, device=None):
    """The certified E_corr of the amplitude checkpoint dict ``amps``:
    campaign.certify in native fp64 with Lvv streamed, on ``device``
    (default the card), or on the CPU where W8_STAGE64_BACKEND is
    'host'.  Its 'ozaki' (the JAX script's default) is not ported and
    raises.  Returns (e_lagr, readings)."""
    backend = _env("W8_STAGE64_BACKEND", "device")
    if backend == "ozaki":
        raise NotImplementedError(
            "W8_STAGE64_BACKEND=ozaki is not ported: the certification runs "
            "in native fp64 (ROADMAP north star, rule 3)")
    if backend not in ("device", "host"):
        raise ValueError(f"W8_STAGE64_BACKEND={backend!r}: device or host")
    dev = torch.device("cpu") if backend == "host" else device
    e_lagr, out = cp.certify(scf, amps, frozen, dev, stream_vv=True)
    out.update(stage64_backend=backend, raw_gap=abs(float(amps["e32"])
                                                    - e_lagr))
    return e_lagr, out


def run(device=None, dtype=None, scratch=None, stage32=True, stage64=True,
        geom=W8_GEOM, basis=BASIS, auxbasis=AUXBASIS, frozen=FROZEN):
    """The campaign on ``device`` (default the card; lib/device.resolve
    raises without one).  stage32: the SCF (reused from ``scratch``,
    default W8AUG_SCRATCH, where its file exists), the streamed ``dtype``
    solve and amps.npz; stage64: the certification, from the files when
    stage32 is off.  Prints a ``W8AUG`` line a stage and returns the
    readings."""
    dev, dtype = _dev.resolve(device, dtype)
    scratch = scratch or default_scratch()
    os.makedirs(scratch, exist_ok=True)
    amps_path = os.path.join(scratch, "amps.npz")
    t_all = time.perf_counter()
    scf = amps = None
    mol = "(H2O)8/" if _is_campaign(geom, basis, auxbasis) else ""
    out = dict(system=f"{mol}{basis} frozen core {frozen}, {auxbasis} "
               "fitting", device=(torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
               scratch=scratch)
    if stage32:
        scf, r = scf_stage(dev, scratch, geom, basis, auxbasis)
        out.update(r)
        amps, r = stage_fp32(scf, frozen, dev, dtype, scratch)
        out.update(r)
        t0 = time.perf_counter()
        np.savez(amps_path, **amps)
        out["checkpoint_s"] = time.perf_counter() - t0
        print("W8AUG " + json.dumps(dict(
            out, stage="fp32_streamed",
            conv=out["ccsd_converged"] and out["lambda_converged"],
            wall_s=time.perf_counter() - t_all)), flush=True)
    if stage64:
        t0 = time.perf_counter()
        if scf is None:
            scf = cp.npz(os.path.join(scratch, "scf.npz"))
            amps = cp.npz(amps_path)
        e_lagr, r = stage_fp64(scf, amps, frozen, dev)
        out.update(r)
        print("W8AUG " + json.dumps(dict(
            r, stage="fp64", backend=r["stage64_backend"],
            wall_s=time.perf_counter() - t0)), flush=True)
    out["wall_s"] = time.perf_counter() - t_all
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stage32", action="store_true",
                    help="the SCF, CCSD, Lambda and the checkpoint")
    ap.add_argument("--stage64", action="store_true",
                    help="the fp64 certification from the checkpoint")
    args = ap.parse_args(argv)
    both = not (args.stage32 or args.stage64)
    return run(torch.device(args.device), stage32=both or args.stage32,
               stage64=both or args.stage64)


if __name__ == "__main__":
    main()
