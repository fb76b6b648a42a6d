"""The parts that the campaign scripts share (w8_parity_certify, w8_triples,
w8_ccsd_pipeline, benzene): progress and peak-memory readings, the
planners of the DIIS ring and the ladder tile, the campaign's DF-RHF, the
CCSD and Lambda solves, and the fp64 certification.

The planners take no environment knobs: a script that keeps the JAX
script's knobs reads them and passes what they set as overrides
(w8_parity_certify._solver).
"""

import contextlib
import io
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


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(dev):
    if dev.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(dev) / 2**30, 3)


def npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class Tee(io.TextIOBase):
    """A solver's log: forwarded to stderr as progress and kept."""

    def __init__(self):
        self.text = []

    def write(self, s):
        sys.stderr.write(s)
        self.text.append(s)
        return len(s)

    def lines(self, key):
        return [ln for ln in "".join(self.text).splitlines() if key in ln]


def last_norm(lines, label):
    """The value after ``label =`` in the last of lines (None if none)."""
    if not lines:
        return None
    return float(re.search(re.escape(label) + r" =\s*(\S+)",
                           lines[-1]).group(1))


def budget(dev):
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


def plan_solver(n, nocc, nvir, naux, dtype, budget, backend="device",
                fallback_space=3, vjp=False, spill=None, **override):
    """Keyword arguments of rccsd.kernel / lambda_ad.kernel: the DIIS ring
    (plan_ring) on ``backend`` and the ladder's tile count
    (lib/memory.plan_ladder_tiles), planned for the budget less the ring
    (one tile where there is no budget).
    ``override`` may set space, err_dtype (device ring only) and ntile in
    place of the planned values.  The host ring spills to ``spill`` (a
    path or None) and resumes from it."""
    space, edt = plan_ring(n, dtype, budget, fallback_space)
    space = override.get("space", space)
    ring = 0
    if backend == "device":
        edt = override.get("err_dtype", edt)
        ring = space * n * (dtype.itemsize + (edt or dtype).itemsize)
    else:
        edt = None
    ntile = override.get("ntile") or (
        1 if budget is None else _mem.plan_ladder_tiles(
            nocc, nvir, naux, dtype=dtype, budget=budget - ring, vjp=vjp))
    spill = spill if spill and backend == "host" else None
    adiis = DIIS.restore(spill) if spill and os.path.exists(spill) else None
    return dict(diis_backend=backend, diis_space=space, diis_err_dtype=edt,
                ntile=ntile, adiis=adiis, diis_file=spill)


def settings(kw):
    """The readings of a solver's settings."""
    return dict(backend=kw["diis_backend"], space=kw["diis_space"],
                err_dtype=str(kw["diis_err_dtype"]), ntile=kw["ntile"],
                resumed=kw["adiis"] is not None)


def build_mf(geom, basis, auxbasis, jk_device=None):
    """The campaign's DF-RHF, converged (conv_tol 1e-10).  J and K
    contract in fp64 on ``jk_device`` (a torch.device), or on the host
    when it is None.  Returns (the SCF checkpoint dict: mo_full, fock_ao,
    B, e_scf, nelectron; readings, with the overlap's smallest
    eigenvalue, s_min); on a device the readings hold one J/K call timed
    there and on the host at the converged density, and their largest
    difference."""
    tee = Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        mol = gto.M(atom=geom, basis=basis)
        mf = RHF(mol, verbose=6).density_fit(auxbasis)
    mf.conv_tol = 1e-10
    mf.with_df.build()
    B = mf.with_df.B_ao()
    out = dict(nao=mol.nao, naux=int(B.shape[0]), nelectron=mol.nelectron,
               df_s=time.perf_counter() - t0,
               jk="host fp64" if jk_device is None else
               f"{torch.device(jk_device).type} fp64")
    out["s_min"] = float(np.linalg.eigvalsh(mf.get_ovlp())[0])
    log(f"DF built: nao={mol.nao} naux={out['naux']} ({out['df_s']:.1f} s); "
        f"smallest overlap eigenvalue {out['s_min']:.3e}")
    if jk_device is not None:
        mf._jk = _JKDF(B, device=jk_device, dtype=torch.float64)
    t0 = time.perf_counter()
    mf.kernel()
    out.update(scf_s=time.perf_counter() - t0, e_scf=mf.e_tot,
               scf_converged=bool(mf.converged),
               scf_cycles=len(tee.lines("SCF cycle")))
    log(f"E(DF-RHF) = {mf.e_tot:.10f} converged={mf.converged} "
        f"({out['scf_cycles']} cycles, {out['scf_s']:.1f} s)")
    if not mf.converged:
        raise RuntimeError("the DF-RHF did not converge")
    dm = mf.make_rdm1()
    if jk_device is not None:
        dev = torch.device(jk_device)
        sync(dev)
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


def make_eris(scf, frozen, dtype, dev, stream_vv=False):
    """The ovvv-free DF integrals of the SCF checkpoint dict with
    ``frozen`` core orbitals, in ``dtype`` on ``dev``; with ``stream_vv``
    Lvv stays in a host store (``Lvv_stream``, cc/stream_ladder).
    Returns (eris, readings: nocc, nvir, naux, eris_s)."""
    nocc = int(scf["nelectron"]) // 2 - frozen
    t0 = time.perf_counter()
    er = eris_mod.make_eris_df(scf["B"], scf["mo_full"][:, frozen:],
                               scf["fock_ao"], nocc, dtype=dtype,
                               keep_ovvv=False, stream_vv=stream_vv,
                               device=dev)
    sync(dev)
    naux, _, nvir = er.Lov.shape
    return er, dict(nocc=nocc, nvir=nvir, naux=naux,
                    eris_s=time.perf_counter() - t0)


def solve_ccsd(er, kw, **tol):
    """RCCSD on ``er`` with the solver settings ``kw`` (plan_solver) at
    ``tol`` (conv_tol, conv_tol_normt, max_cycle), its cycles to stderr.
    Returns (t1, t2, readings: ccsd_diis, ccsd_converged, e32, ccsd_s,
    ccsd_cycles, ccsd_normt, peak_ccsd_gib, ccsd_s_per_cycle)."""
    dev = er.Lov.device
    reset_peak(dev)
    tee = Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        conv, e32, t1, t2 = rccsd.kernel(er, verbose=5, **tol, **kw)
    sync(dev)
    cyc = tee.lines("E_corr(RCCSD)")
    out = dict(ccsd_diis=settings(kw), ccsd_converged=bool(conv),
               e32=float(e32), ccsd_s=time.perf_counter() - t0,
               ccsd_cycles=len(cyc), ccsd_normt=last_norm(cyc, "|dt|"),
               peak_ccsd_gib=peak_gib(dev))
    out["ccsd_s_per_cycle"] = out["ccsd_s"] / max(len(cyc), 1)
    return t1, t2, out


def solve_lambda(t1, t2, er, kw, **tol):
    """Lambda of (t1, t2) on ``er`` with the solver settings ``kw`` at
    ``tol`` (conv_tol, max_cycle), its cycles to stderr.  Returns (l1,
    l2, readings: lambda_diis, lambda_converged, lambda_s, lambda_cycles,
    lambda_dl, peak_lambda_gib, lambda_s_per_cycle)."""
    dev = er.Lov.device
    reset_peak(dev)
    tee = Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        cl, l1, l2 = lambda_ad.kernel(t1, t2, er, verbose=5, **tol, **kw)
    sync(dev)
    cyc = tee.lines("lambda cycle")
    out = dict(lambda_diis=settings(kw), lambda_converged=bool(cl),
               lambda_s=time.perf_counter() - t0, lambda_cycles=len(cyc),
               lambda_dl=last_norm(cyc, "|dl|"),
               peak_lambda_gib=peak_gib(dev))
    out["lambda_s_per_cycle"] = out["lambda_s"] / max(len(cyc), 1)
    return l1, l2, out


def amplitudes(t1, t2, l1, l2, e32):
    """The amplitude checkpoint dict (t1, t2, l1, l2, e32) on the host."""
    amps = {k: v.cpu().numpy() for k, v in
            (("t1", t1), ("t2", t2), ("l1", l1), ("l2", l2))}
    amps["e32"] = np.float64(e32)
    return amps


def certify(scf, amps, frozen, device=None, stream_vv=False):
    """The certified correlation energy: the DF integrals of scf rebuilt in
    fp64 on ``device`` (Lvv in a host store with ``stream_vv``) and one
    fp64 lagrangian_energy of the upcast amplitudes and multipliers in
    amps (the amplitude checkpoint dict).  Returns (e_lagr, readings)."""
    dev, f64 = _dev.resolve(device, torch.float64)
    reset_peak(dev)
    er, r = make_eris(scf, frozen, f64, dev, stream_vv)
    out = dict(eris64_s=r["eris_s"], stream_vv64=stream_vv)
    b = budget(dev)
    out["ntile64"] = nt = (1 if b is None else _mem.plan_ladder_ntile(
        r["nocc"], r["nvir"], r["naux"], dtype="float64", budget=b))
    xs = [torch.as_tensor(amps[k]).to(dev, f64)
          for k in ("t1", "t2", "l1", "l2")]
    t0 = time.perf_counter()
    e_lagr = float(lambda_ad.lagrangian_energy(*xs, er, ntile=nt))
    out.update(residual64_s=time.perf_counter() - t0, e_lagr=e_lagr,
               peak_certify_gib=peak_gib(dev))
    log(f"E_corr(certified) = {e_lagr:.10f} ({out['eris64_s']:.1f} s "
        f"eris, {out['residual64_s']:.1f} s residual, ntile {nt})")
    return e_lagr, out
