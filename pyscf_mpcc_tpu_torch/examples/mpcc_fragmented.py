#!/usr/bin/env python
"""Fragmented MP-CC workflow on H2O/cc-pVDZ through the port's entry points:
localize the orbitals, solve the MP2 bath with the non-canonical iterative
solver, relax CCSD amplitudes on the oxygen fragment with the bath frozen,
and compare against global CCSD and MP2.

    python -m pyscf_mpcc_tpu_torch.examples.mpcc_fragmented   # CUDA, fp32
    python -m pyscf_mpcc_tpu_torch.examples.mpcc_fragmented --device cpu

The twin of the JAX package's examples/mpcc_fragmented.py.  The device
defaults to CUDA and the run raises without a card; the dtype follows the
port's policy (fp64 on the CPU, fp32 with TF32 off on CUDA) unless given.
"""

import argparse

import torch

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.cc.driver import CCSD
from pyscf_mpcc_tpu_torch.mpcc import workflow
from pyscf_mpcc_tpu_torch.scf import RHF


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    args = ap.parse_args(argv)
    kw = dict(device=torch.device(args.device),
              dtype=None if args.dtype is None else getattr(torch, args.dtype))

    mol = gto.M(atom="O 0 0 0; H 0 -0.757 0.587; H 0 0.757 0.587",
                basis="cc-pvdz")
    mf = RHF(mol)
    mf.conv_tol = 1e-12
    mf.kernel()

    cc = CCSD(mf, **kw).set(conv_tol=1e-9).run()
    e_mp2 = cc.emp2
    print(f"MP2  E_corr = {e_mp2:.10f}")
    print(f"CCSD E_corr = {cc.e_corr:.10f}  ({cc.device}, {cc.dtype})")

    # MPCCSD(4,2)-style: only the all-active doubles block relaxes, the
    # environment stays at its (localized, iterative) MP2 value.  fp32
    # cannot resolve the fp64 defaults' 1e-10 / 1e-8 energy steps
    conv = {} if cc.dtype == torch.float64 else dict(mp2_conv=1e-7,
                                                     cc_conv=1e-7)
    e_mpcc, t1, t2, c_loc, spaces = workflow.fragmented_mpcc(
        mol, mf, fragments=[[0]],          # oxygen fragment
        idx_s=[], idx_d=list(range(15)), pop_threshold=0.3, **conv, **kw)
    act_hole, act_particle = spaces[0]
    print(f"fragment active holes:     {act_hole}")
    print(f"fragment active particles: {act_particle}")
    print(f"MPCC E_corr = {e_mpcc:.10f}")
    print(f"  recovers {100 * (e_mpcc - e_mp2) / (cc.e_corr - e_mp2):.1f}% "
          "of the CCSD-beyond-MP2 correlation")
    return e_mpcc


if __name__ == "__main__":
    main()
