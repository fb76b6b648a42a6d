#!/usr/bin/env python
"""EOM-CCSD of benzene/cc-pVDZ (nocc 21, nvir 93, all electrons, exact
integrals) against the reference's pins: EE (4 roots), IP (3), EA (3).

    python -m pyscf_mpcc_tpu_torch.examples.eom_benzene                  # CUDA, fp32
    python -m pyscf_mpcc_tpu_torch.examples.eom_benzene --dtype float64

The twin of the JAX package's examples/eom_benzene_chip.py, at its
settings: the pin geometry, the host RHF with exact J/K (conv_tol 1e-11),
incore MO integrals on the device, RCCSD to conv_tol 1e-8 /
conv_tol_normt 3e-6, and the Davidson to 1e-5 (150 cycles at most).  The
pins (docs/reference_pins.json benzene_ccpvdz: the reference's
eom_rccsd.py run on integrals injected from the JAX package, CCSD at
conv_tol 1e-8) are copied below.  Progress goes to stderr; stdout gets
one JSON line: per sector the roots in eV, their largest deviation from
the pins, Davidson cycles and matvecs, seconds per sigma (device work and
the vector's copies), per sector and the host Davidson's share of it, the
peak device memory; and the host RHF and ERI times apart from the device
integral transform and CCSD.
"""

import argparse
import contextlib
import io
import json
import sys
import time
from unittest import mock

import numpy as np
import torch

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.cc import eom, rccsd
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.scf import RHF

HARTREE_EV = 27.211386245988

# the pin geometry (D6h, R(CC) = 1.392, R(CH) = 1.086 Angstrom)
GEOM = """
C    0.000000    1.392000    0.000000
C    1.205508    0.696000    0.000000
C    1.205508   -0.696000    0.000000
C    0.000000   -1.392000    0.000000
C   -1.205508   -0.696000    0.000000
C   -1.205508    0.696000    0.000000
H    0.000000    2.478000    0.000000
H    2.146012    1.239000    0.000000
H    2.146012   -1.239000    0.000000
H    0.000000   -2.478000    0.000000
H   -2.146012   -1.239000    0.000000
H   -2.146012    1.239000    0.000000
"""

# docs/reference_pins.json benzene_ccpvdz
REF = dict(
    rhf_e_tot=-230.72221627495318,
    ccsd_e_corr=-0.8364146647850237,
    ee=[5.317611129002724, 6.8678031716863694,
        7.8784073251270375, 7.878407649536414],
    ip=[9.115824420140703, 9.115829213763188, 11.951420976970022],
    ea=[2.4231924553929907, 2.423195290706064, 3.866591229361914],
)
SECTORS = (("ee", eom.kernel_ee, 4), ("ip", eom.kernel_ip, 3),
           ("ea", eom.kernel_ea, 3))
CCSD_TOL = dict(conv_tol=1e-8, conv_tol_normt=3e-6, max_cycle=100)
DAVIDSON = dict(tol=1e-5, max_cycle=150)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _SigmaClock:
    """Counts the EOM sigmas (cc/eom.ee_sigma) and their seconds, the
    device synchronized around each."""

    def __init__(self, dev):
        self.dev, self.n, self.sec = dev, 0, 0.0

    def wrap(self, fn):
        def timed(*args, **kw):
            _sync(self.dev)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            _sync(self.dev)
            self.sec += time.perf_counter() - t0
            self.n += 1
            return out
        return timed


def sector(name, kern, nroots, t1, t2, er, dev):
    """One EOM sector against its pins: a dict of its readings."""
    clock = _SigmaClock(dev)
    log = io.StringIO()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with mock.patch.object(eom, "ee_sigma", clock.wrap(eom.ee_sigma)), \
            contextlib.redirect_stdout(log):
        conv, omegas, _ = kern(t1, t2, er, nroots=nroots, verbose=1,
                               **DAVIDSON)
    sec = time.perf_counter() - t0
    evs = [float(w) * HARTREE_EV for w in np.atleast_1d(omegas)]
    return dict(
        roots_ev=evs, ref_ev=REF[name],
        max_abs_dev_ev=max(abs(a - b) for a, b in zip(evs, REF[name])),
        converged=bool(np.all(conv)),
        cycles=log.getvalue().count("davidson cycle"), matvecs=clock.n,
        s_per_sigma=clock.sec / max(clock.n, 1), sec=sec,
        host_davidson_sec=sec - clock.sec,
        peak_gib=(round(torch.cuda.max_memory_allocated(dev) / 2**30, 3)
                  if dev.type == "cuda" else None))


def run(device=None, dtype=None):
    """RHF -> incore integrals -> RCCSD -> EE/IP/EA on ``device``
    (default the card); returns the readings."""
    dev, dtype = _dev.resolve(device, dtype)
    out = dict(molecule="benzene/cc-pvdz (pin geometry)", dtype=str(dtype))
    t0 = time.perf_counter()
    mol = gto.M(atom=GEOM, basis="cc-pvdz")
    mf = RHF(mol)              # exact J/K, as the pin run
    mf.conv_tol = 1e-11
    mf.kernel()
    out["rhf_s"] = time.perf_counter() - t0
    if not mf.converged:
        raise RuntimeError("benzene RHF did not converge")
    out.update(e_scf=mf.e_tot, d_scf_vs_ref=mf.e_tot - REF["rhf_e_tot"])
    _log(f"E(RHF) = {mf.e_tot:.10f} ({out['rhf_s']:.1f} s)")

    t0 = time.perf_counter()
    eri = gto.intor_eri(mol)
    out["eri_s"] = time.perf_counter() - t0
    nocc = mol.nelectron // 2
    t0 = time.perf_counter()
    er = eris_mod.make_eris_incore(eri, mf.mo_coeff,
                                   mf.get_fock(mf.make_rdm1()), nocc, dtype,
                                   device=dev)
    del eri
    _sync(dev)
    out["eris_s"] = time.perf_counter() - t0
    out.update(nocc=nocc, nvir=er.nvir)

    t0 = time.perf_counter()
    conv, e_corr, t1, t2 = rccsd.kernel(er, **CCSD_TOL)
    _sync(dev)
    out["ccsd_s"] = time.perf_counter() - t0
    if not conv:
        raise RuntimeError("benzene RCCSD did not converge")
    out.update(e_corr=e_corr, d_ccsd_vs_ref=e_corr - REF["ccsd_e_corr"])
    _log(f"E_corr(CCSD) = {e_corr:.10f} ({out['ccsd_s']:.1f} s)")

    for name, kern, nroots in SECTORS:
        out[name] = r = sector(name, kern, nroots, t1, t2, er, dev)
        _log(f"{name.upper()} roots (eV): "
             + ", ".join(f"{x:.5f}" for x in r["roots_ev"])
             + f"  |dev| {r['max_abs_dev_ev']:.2e} eV, {r['cycles']} "
             f"cycles, {r['matvecs']} sigmas, {r['sec']:.1f} s")
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    args = ap.parse_args(argv)
    dtype = None if args.dtype is None else getattr(torch, args.dtype)
    out = run(torch.device(args.device), dtype)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
