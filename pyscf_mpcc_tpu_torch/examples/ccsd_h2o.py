#!/usr/bin/env python
"""Minimal end-to-end run on H2O/cc-pVDZ: RHF -> CCSD -> (T) -> Lambda ->
one-particle RDM, through the port's user entry points.

    python -m pyscf_mpcc_tpu_torch.examples.ccsd_h2o              # CUDA, fp32
    python -m pyscf_mpcc_tpu_torch.examples.ccsd_h2o --device cpu # fp64
    python -m pyscf_mpcc_tpu_torch.examples.ccsd_h2o --dtype float64

The twin of the JAX package's examples/ccsd_h2o.py.  The device defaults to
CUDA and the run raises without a card; the dtype follows the port's policy
(fp64 on the CPU, fp32 with TF32 off on CUDA) unless given.
"""

import argparse

import torch

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.cc.driver import CCSD
from pyscf_mpcc_tpu_torch.scf import RHF


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    args = ap.parse_args(argv)
    dtype = None if args.dtype is None else getattr(torch, args.dtype)

    mol = gto.M(atom="O 0 0 0; H 0 -0.757 0.587; H 0 0.757 0.587",
                basis="cc-pvdz")
    mf = RHF(mol)
    mf.kernel()
    print(f"E(RHF)   = {mf.e_tot:.10f}")

    cc = CCSD(mf, device=torch.device(args.device), dtype=dtype).run()
    print(f"E(CCSD)  = {cc.e_tot:.10f}  (E_corr = {cc.e_corr:.10f}, "
          f"{cc.device}, {cc.dtype})")
    # the memory planner sizes the (T) tile from the card's free memory; a
    # CPU device has none to query, so it gets the JAX package's edge of 8
    et = cc.ccsd_t(tile=8 if cc.device.type == "cpu" else 0)
    print(f"E(T)     = {et:.10f}")
    rdm1 = cc.make_rdm1()
    print(f"tr(rdm1) = {float(rdm1.trace()):.8f}")
    return cc


if __name__ == "__main__":
    main()
