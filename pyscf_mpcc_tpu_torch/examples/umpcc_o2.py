#!/usr/bin/env python
"""Unrestricted MP-CC on an open-shell system (O2 triplet, sto-3g): UHF ->
UMP2 -> UCCSD, then a UCCSD-quality active block (the open-shell pi
system) embedded in an MP2 bath through umpccsd.kernel's per-spin freeze
masks.

    python -m pyscf_mpcc_tpu_torch.examples.umpcc_o2               # CUDA, fp64
    python -m pyscf_mpcc_tpu_torch.examples.umpcc_o2 --device cpu

The twin of the JAX package's examples/umpcc_o2.py: the same molecule,
tolerances, active space and printed lines, in fp64 (as the JAX script
runs under x64) on the card unless --device cpu is given.  The UHF runs on
the host; the integrals, UCCSD and UMPCC on the device.  A solve that does
not converge raises.  The last line is one JSON object of the energies
(``run``'s dict), which ``compare`` holds to PINS.
"""

import argparse
import json

import torch

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.cc import uccsd
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.mpcc import umpccsd
from pyscf_mpcc_tpu_torch.scf import UHF

# printed by the JAX package's examples/umpcc_o2.py (fp64 on a CPU), as it
# prints them (10 decimals; the share to 0.1 %)
PINS = dict(e_uhf=-147.6340485051, e_ump2=-0.0970644539,
            e_uccsd=-0.1086056193, e_umpcc=-0.1057377503, share_pct=75.2)
# the energies to 1e-8 Ha (the pins carry 10 decimals); the share to half
# a unit of its printed digit and the energies' effect on it (1e-3)
TOL = dict(e_uhf=1e-8, e_ump2=1e-8, e_uccsd=1e-8, e_umpcc=1e-8,
           share_pct=0.051)


def run(device=None):
    """The JAX script's steps in fp64 on ``device`` (default the card).
    Prints its lines and returns the energies."""
    dev, f64 = _dev.resolve(device, torch.float64)
    mol = gto.M(atom="O 0 0 0; O 0 0 1.21", basis="sto-3g", spin=2)
    mf = UHF(mol)
    mf.conv_tol = 1e-12
    mf.kernel()
    if not mf.converged:
        raise RuntimeError("the UHF did not converge")
    print(f"E(UHF) = {mf.e_tot:.10f}")

    ue = uccsd.eris_from_scf(mf, f64, device=dev)
    emp2 = float(uccsd.init_amps(ue)[0])
    conv, e_cc, *_ = uccsd.kernel(ue, conv_tol=1e-9)
    if not conv:
        raise RuntimeError("UCCSD did not converge")
    print(f"UMP2  E_corr = {emp2:.10f}")
    print(f"UCCSD E_corr = {e_cc:.10f}")

    # active space: the open-shell pi system (top occupieds / low virtuals;
    # alpha has a single virtual in this minimal basis)
    na, nb = mol.nelec
    act_hole = ([na - 2, na - 1], [nb - 2, nb - 1])
    act_particle = ([0], [0, 1])
    conv, e_mpcc, *_ = umpccsd.kernel(
        ue, act_hole, act_particle, idx_s=[], idx_d=list(range(15)),
        conv_tol=1e-9)
    if not conv:
        raise RuntimeError("UMPCC did not converge")
    share = 100 * (e_mpcc - emp2) / (e_cc - emp2)
    print(f"UMPCC E_corr = {e_mpcc:.10f}  ({share:.1f}% of "
          "UCCSD-beyond-MP2)")
    out = dict(e_uhf=float(mf.e_tot), e_ump2=emp2, e_uccsd=float(e_cc),
               e_umpcc=float(e_mpcc), share_pct=share,
               device=str(dev))
    print(json.dumps(out), flush=True)
    return out


def compare(out):
    """{key: (|value - pin|, tolerance)} of run's dict against PINS."""
    return {k: (abs(out[k] - PINS[k]), TOL[k]) for k in PINS}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(torch.device(args.device))


if __name__ == "__main__":
    main()
