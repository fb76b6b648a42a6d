#!/usr/bin/env python
"""Open-shell end-to-end run on the OH(H2O)3 doublet radical cluster:
DF-UHF -> DF-UCCSD -> UCCSD(T) -> unrestricted Lambda -> the certified
(fp64 Lagrangian) energy, through the port's user entry points.

    python -m pyscf_mpcc_tpu_torch.examples.uccsd_oh                 # CUDA fp32, cc-pVDZ
    python -m pyscf_mpcc_tpu_torch.examples.uccsd_oh --basis cc-pvtz
    python -m pyscf_mpcc_tpu_torch.examples.uccsd_oh --device cpu --basis sto-3g

The geometry and inputs are those of the JAX package's
examples/openshell_certify.py: all electrons, UHF conv_tol 1e-10, the
default auxiliary basis at cc-pVDZ and the matched -jkfit set at cc-pVTZ.
The amplitudes and multipliers are solved in the working dtype (fp32 on
CUDA with TF32 off, fp64 on the CPU) and certified by one evaluation of
E_L = E(t) + <l, R(t)> in fp64 on the same device.
"""

import argparse
import time

import torch

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.cc import lambda_ad, uccsd
from pyscf_mpcc_tpu_torch.cc.driver import CCSD
from pyscf_mpcc_tpu_torch.scf import UHF

# OH radical donating to water A; waters B/C donating back to the radical
# oxygen (Angstrom)
GEOM = (
    "O 0.0000 0.0000 0.0000; H 0.0000 0.0000 0.9700; "
    "O 0.0000 0.0000 2.8500; H 0.7583 0.0000 3.4387; "
    "H -0.7583 0.0000 3.4387; "
    "O 2.7500 0.0000 -0.6000; H 1.8121 0.0000 -0.3954; "
    "H 3.0689 0.8474 -0.2811; "
    "O -2.6000 0.9000 -0.7000; H -1.7208 0.5957 -0.4633; "
    "H -2.8768 0.0234 -0.4232"
)


def auxbasis_for(basis):
    """The matched -jkfit set at cc-pVTZ, the default aux basis below."""
    return basis + "-jkfit" if "pvtz" in basis.lower() else None


def uhf(basis="cc-pvdz"):
    mol = gto.M(atom=GEOM, basis=basis, spin=1)
    mf = UHF(mol).density_fit(auxbasis_for(basis))
    mf.conv_tol = 1e-10
    return mf.run()


def certify(cc, l1, l2):
    """fp64 Lagrangian correlation energy of (cc.t, l) from fp64 DF
    integrals rebuilt on the driver's device."""
    mf = cc._scf
    fa, fb = uccsd.uhf_focks(mf)
    e64 = uccsd.make_eris_df(mf.with_df.B_ao(), cc.mo_coeff[0],
                             cc.mo_coeff[1], fa, fb, *cc.nocc,
                             dtype=torch.float64, device=cc.device)

    def up(xs):
        return tuple(x.double() for x in xs)

    return float(lambda_ad.lagrangian_energy_u(up(cc.t1), up(cc.t2), up(l1),
                                               up(l2), e64))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--basis", default="cc-pvdz")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    ap.add_argument("--tile", type=int, default=8)
    args = ap.parse_args(argv)
    dtype = None if args.dtype is None else getattr(torch, args.dtype)

    t0 = time.perf_counter()
    mf = uhf(args.basis)
    print(f"E(UHF)     = {mf.e_tot:.10f}  converged={mf.converged}  "
          f"nao={mf.mol.nao}  nelec={mf.mol.nelec}  "
          f"naux={mf.with_df.B_ao().shape[0]}  "
          f"[{time.perf_counter() - t0:.1f} s]")
    cc = CCSD(mf, device=torch.device(args.device), dtype=dtype)
    cc.set(conv_tol=1e-8, conv_tol_normt=1e-6, diis_backend="device").run()
    print(f"E_corr     = {cc.e_corr:.10f}  converged={cc.converged}  "
          f"({cc.device}, {cc.dtype})  [{time.perf_counter() - t0:.1f} s]")
    conv_l, l1, l2 = lambda_ad.kernel_u(cc.t1, cc.t2, cc.eris,
                                        conv_tol=3e-6, max_cycle=60,
                                        diis_backend="device")
    print(f"Lambda converged={conv_l}  [{time.perf_counter() - t0:.1f} s]")
    e_cert = certify(cc, l1, l2)
    print(f"E_corr(certified) = {e_cert:.10f}  "
          f"(raw - certified = {cc.e_corr - e_cert:.3e})  "
          f"[{time.perf_counter() - t0:.1f} s]")
    et = cc.ccsd_t(tile=args.tile)
    print(f"E(T)       = {et:.10f}  [{time.perf_counter() - t0:.1f} s]")
    print(f"E_tot(certified) = {mf.e_tot + e_cert:.10f}")
    return cc, e_cert, et


if __name__ == "__main__":
    main()
