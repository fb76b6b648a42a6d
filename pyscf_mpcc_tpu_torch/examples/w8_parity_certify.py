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

1. ``build_mf``: DF-RHF of the cube cluster (cc-pVTZ, cc-pVTZ-JKFIT,
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

Sizes.  The ladder tile comes from lib/memory.plan_ladder_ntile (vjp=True
for Lambda), planned after the DIIS ring is set aside.  A ring of six
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
import contextlib
import io
import itertools
import json
import os
import re
import sys
import time

import numpy as np
import torch

from pyscf_mpcc_tpu_torch import config, gto
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.cc import lambda_ad, rccsd
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.lib import memory as _mem
from pyscf_mpcc_tpu_torch.lib.diis import DIIS
from pyscf_mpcc_tpu_torch.scf import RHF
from pyscf_mpcc_tpu_torch.scf.hf import _JKDF

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

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


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _env(name, default, cast=str):
    v = os.environ.get(name, "")
    return cast(v) if v else default


def _err_dtype(name, planned):
    """W8_*_ERR_DTYPE: a torch dtype name, or none (errors in the working
    dtype); the planned dtype when unset."""
    v = os.environ.get(name, "")
    if not v:
        return planned
    return None if v == "none" else getattr(torch, v)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev):
    if dev.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(dev) / 2**30, 3)


class _Tee(io.TextIOBase):
    """A solver's log: forwarded to stderr as progress and kept."""

    def __init__(self):
        self.text = []

    def write(self, s):
        sys.stderr.write(s)
        self.text.append(s)
        return len(s)

    def lines(self, key):
        return [ln for ln in "".join(self.text).splitlines() if key in ln]


def _last_norm(lines, label):
    """The value after ``label =`` in the last of lines (None if none)."""
    if not lines:
        return None
    return float(re.search(re.escape(label) + r" =\s*(\S+)",
                           lines[-1]).group(1))


def _budget(dev):
    """Device bytes the planners size against; None on a CPU without
    config.MAX_MEMORY, where there is no device memory to plan."""
    if dev.type == "cuda" or config.MAX_MEMORY:
        return _mem.hbm_budget_bytes(dev)
    return None


def plan_ring(n, dtype, budget, fallback_space=3):
    """(space, err_dtype) of a device DIIS ring of n-element vectors: six
    slots with errors in ``dtype`` where the ring (x and error rows) takes
    at most a quarter of ``budget``, which leaves the ladder planner three
    quarters for the sweep beside it; else ``fallback_space`` slots with
    bf16 errors, the JAX script's recipe for a 16 GB chip."""
    isz = dtype.itemsize
    if budget is None or 2 * 6 * n * isz <= budget // 4:
        return 6, None
    return fallback_space, torch.bfloat16


def _solver(prefix, n, nocc, nvir, naux, dtype, budget, spill,
            backend="device", fallback_space=3, vjp=False):
    """Keyword arguments of rccsd.kernel / lambda_ad.kernel: the DIIS ring
    (plan_ring) and the ladder's tile count, planned for the budget less
    the ring (one tile where there is no budget), each overridden by its
    knob (prefix W8_ for CCSD, W8_LAMBDA_ for Lambda).  The host ring
    spills to ``spill`` (a path or None) and resumes from it."""
    backend = _env(prefix + "DIIS_BACKEND", backend)
    space, edt = plan_ring(n, dtype, budget, fallback_space)
    space = _env(prefix + "DIIS_SPACE", space, int)
    ring = 0
    if backend == "device":
        edt = _err_dtype(prefix + "DIIS_ERR_DTYPE", edt)
        ring = space * n * (dtype.itemsize + (edt or dtype).itemsize)
    else:
        edt = None
    ntile = _env(prefix + "NTILE", 0, int) or (
        1 if budget is None else _mem.plan_ladder_ntile(
            nocc, nvir, naux, dtype=dtype, budget=budget - ring, vjp=vjp))
    spill = spill if spill and backend == "host" else None
    adiis = DIIS.restore(spill) if spill and os.path.exists(spill) else None
    return dict(diis_backend=backend, diis_space=space, diis_err_dtype=edt,
                ntile=ntile, adiis=adiis, diis_file=spill)


def _settings(kw):
    """The readings of a solver's settings."""
    return dict(backend=kw["diis_backend"], space=kw["diis_space"],
                err_dtype=str(kw["diis_err_dtype"]), ntile=kw["ntile"],
                resumed=kw["adiis"] is not None)


def build_mf(geom, basis, auxbasis, jk_device=None):
    """The campaign's DF-RHF, converged (conv_tol 1e-10).  J and K
    contract in fp64 on ``jk_device`` (a torch.device), or on the host
    when it is None.  Returns (the checkpoint dict of scf.npz, readings);
    on a device the readings hold one J/K call timed there and on the
    host at the converged density, and their largest difference."""
    log = _Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        mol = gto.M(atom=geom, basis=basis)
        mf = RHF(mol, verbose=6).density_fit(auxbasis)
    mf.conv_tol = 1e-10
    mf.with_df.build()
    B = mf.with_df.B_ao()
    out = dict(nao=mol.nao, naux=int(B.shape[0]), nelectron=mol.nelectron,
               df_s=time.perf_counter() - t0,
               jk="host fp64" if jk_device is None else
               f"{torch.device(jk_device).type} fp64")
    _log(f"DF built: nao={mol.nao} naux={out['naux']} ({out['df_s']:.1f} s)")
    if jk_device is not None:
        mf._jk = _JKDF(B, device=jk_device, dtype=torch.float64)
    t0 = time.perf_counter()
    mf.kernel()
    out.update(scf_s=time.perf_counter() - t0, e_scf=mf.e_tot,
               scf_converged=bool(mf.converged),
               scf_cycles=len(log.lines("SCF cycle")))
    _log(f"E(DF-RHF) = {mf.e_tot:.10f} converged={mf.converged} "
         f"({out['scf_cycles']} cycles, {out['scf_s']:.1f} s)")
    if not mf.converged:
        raise RuntimeError("the DF-RHF did not converge")
    dm = mf.make_rdm1()
    if jk_device is not None:
        dev = torch.device(jk_device)
        _sync(dev)
        t0 = time.perf_counter()
        jd, kd = mf.get_jk(dm)
        out["jk_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        jh, kh = _JKDF(B).get_jk(dm)
        out["jk_host_s"] = time.perf_counter() - t0
        out["jk_gap"] = float(max(np.abs(jd - jh).max(),
                                  np.abs(kd - kh).max()))
    scf = dict(mo_full=np.asarray(mf.mo_coeff),
               fock_ao=np.asarray(mf.get_fock(dm)), B=B,
               e_scf=np.float64(mf.e_tot),
               nelectron=np.int64(mol.nelectron))
    return scf, out


def stage_fp32(scf, frozen, device=None, dtype=None, scratch=None):
    """CCSD and Lambda of scf (the scf.npz dict) with ``frozen`` core
    orbitals, in ``dtype`` on ``device`` (lib/device.resolve: fp32 on
    CUDA), at the campaign's tolerances.  Raises if CCSD does not
    converge.  ``scratch``: where the host ring spills.  Returns (the
    amps.npz dict, readings)."""
    dev, dtype = _dev.resolve(device, dtype)
    nocc = int(scf["nelectron"]) // 2 - frozen
    _reset_peak(dev)
    t0 = time.perf_counter()
    er = eris_mod.make_eris_df(scf["B"], scf["mo_full"][:, frozen:],
                               scf["fock_ao"], nocc, dtype=dtype,
                               keep_ovvv=False, device=dev)
    _sync(dev)
    naux, nvir = er.Lvv.shape[:2]
    n = nocc * nvir + (nocc * nvir) ** 2
    budget = _budget(dev)
    out = dict(nocc=nocc, nvir=nvir, naux=naux, dtype=str(dtype),
               eris_s=time.perf_counter() - t0)

    kw = _solver("W8_", n, nocc, nvir, naux, dtype, budget,
                 scratch and os.path.join(scratch, "ccsd_diis.npz"))
    out["ccsd_diis"] = _settings(kw)
    _log(f"{dtype} eris: nocc={nocc} nvir={nvir} naux={naux} "
         f"({out['eris_s']:.1f} s); CCSD {out['ccsd_diis']}")
    log = _Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        conv, e32, t1, t2 = rccsd.kernel(
            er, conv_tol=_env("W8_CONV", 1e-6, float),
            conv_tol_normt=_env("W8_NORMT", 1.5e-4, float), max_cycle=80,
            verbose=5, **kw)
    _sync(dev)
    cyc = log.lines("E_corr(RCCSD)")
    out.update(ccsd_converged=bool(conv), e32=float(e32),
               ccsd_s=time.perf_counter() - t0, ccsd_cycles=len(cyc),
               ccsd_normt=_last_norm(cyc, "|dt|"), peak_ccsd_gib=_peak_gib(dev))
    out["ccsd_s_per_cycle"] = out["ccsd_s"] / max(len(cyc), 1)
    if not conv:
        raise RuntimeError(f"CCSD did not converge: {out}")

    lkw = _solver("W8_LAMBDA_", n, nocc, nvir, naux, dtype, budget,
                  scratch and os.path.join(scratch, "lambda_diis.npz"),
                  backend=kw["diis_backend"], fallback_space=2, vjp=True)
    out["lambda_diis"] = _settings(lkw)
    _log(f"E_corr({dtype}) = {e32:.10f} in {len(cyc)} cycles; "
         f"Lambda {out['lambda_diis']}")
    _reset_peak(dev)
    log = _Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        cl, l1, l2 = lambda_ad.kernel(
            t1, t2, er, conv_tol=_env("W8_LAMBDA_CONV", 1e-4, float),
            max_cycle=_env("W8_LAMBDA_MAXCYC", 80, int), verbose=5, **lkw)
    _sync(dev)
    cyc = log.lines("lambda cycle")
    out.update(lambda_converged=bool(cl), lambda_s=time.perf_counter() - t0,
               lambda_cycles=len(cyc), lambda_dl=_last_norm(cyc, "|dl|"),
               peak_lambda_gib=_peak_gib(dev))
    out["lambda_s_per_cycle"] = out["lambda_s"] / max(len(cyc), 1)
    amps = {k: v.cpu().numpy() for k, v in
            (("t1", t1), ("t2", t2), ("l1", l1), ("l2", l2))}
    amps["e32"] = np.float64(e32)
    return amps, out


def certify(scf, amps, frozen, device=None):
    """The certified correlation energy: the DF integrals of scf rebuilt in
    fp64 on ``device`` and one fp64 lagrangian_energy of the upcast
    amplitudes and multipliers in amps (the amps.npz dict).  Returns
    (e_lagr, readings)."""
    dev, f64 = _dev.resolve(device, torch.float64)
    nocc = int(scf["nelectron"]) // 2 - frozen
    _reset_peak(dev)
    t0 = time.perf_counter()
    er = eris_mod.make_eris_df(scf["B"], scf["mo_full"][:, frozen:],
                               scf["fock_ao"], nocc, dtype=f64,
                               keep_ovvv=False, device=dev)
    _sync(dev)
    naux, nvir = er.Lvv.shape[:2]
    out = dict(eris64_s=time.perf_counter() - t0)
    budget = _budget(dev)
    out["ntile64"] = nt = (1 if budget is None else _mem.plan_ladder_ntile(
        nocc, nvir, naux, dtype="float64", budget=budget))
    xs = [torch.as_tensor(amps[k]).to(dev, f64)
          for k in ("t1", "t2", "l1", "l2")]
    t0 = time.perf_counter()
    e_lagr = float(lambda_ad.lagrangian_energy(*xs, er, ntile=nt))
    out.update(residual64_s=time.perf_counter() - t0, e_lagr=e_lagr,
               peak_certify_gib=_peak_gib(dev))
    _log(f"E_corr(certified) = {e_lagr:.10f} ({out['eris64_s']:.1f} s "
         f"eris, {out['residual64_s']:.1f} s residual, ntile {nt})")
    return e_lagr, out


def default_scratch(small=False):
    """The checkpoint directory: W8_SCRATCH, by default
    .campaign/w8_parity/_torch, and its ``small`` subdirectory for
    --small."""
    scratch = _env("W8_SCRATCH", os.path.join(ROOT, ".campaign",
                                              "w8_parity", "_torch"))
    return os.path.join(scratch, "small") if small else scratch


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


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
        scf = _npz(scf_path)
        out.update(scf_reused=True, e_scf=float(scf["e_scf"]),
                   nao=scf["B"].shape[1], naux=scf["B"].shape[0])
        _log(f"SCF reused: E = {out['e_scf']:.10f}")
    else:
        _reset_peak(dev)
        scf, r = build_mf(geom, basis, auxbasis,
                          jk_device=dev if dev.type == "cuda" else None)
        out.update(r, scf_reused=False, peak_scf_gib=_peak_gib(dev))
        t0 = time.perf_counter()
        np.savez(scf_path, **scf)
        ckpt_s += time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    if reuse_scf and os.path.exists(amps_path):
        amps = _npz(amps_path)
        out.update(amps_reused=True, e32=float(amps["e32"]))
        _log(f"amplitudes reused: E_corr = {out['e32']:.10f}")
    else:
        amps, r = stage_fp32(scf, frozen, dev, dtype, scratch=scratch)
        out.update(r, amps_reused=False)
        t0 = time.perf_counter()
        np.savez(amps_path, **amps)
        ckpt_s += time.perf_counter() - t0
    out.update(nocc=amps["t1"].shape[0], nvir=amps["t1"].shape[1])

    e_lagr, r = certify(scf, amps, frozen, dev)
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
