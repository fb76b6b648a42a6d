#!/usr/bin/env python
"""Property stack showcase on H2O/cc-pVDZ through the port's entry points:

  * DF-RHF on an AutoAux fitting basis (df/autoaux.py),
  * DF-MP2 with unrelaxed and orbital-relaxed densities and natural
    orbitals (mp/dfmp2.py, Z-vector),
  * the MP2-F12/SP explicitly correlated correction (mp/mp2f12.py),
  * CCSD with its T1/D1/D2 diagnostics,
  * EOM-CCSD: EE, IP, EA and spin-flip roots,
  * moment-conserving GF-CCSD poles and the 1-RDM of its zeroth moment
    against Lambda's.

    python -m pyscf_mpcc_tpu_torch.examples.properties_showcase               # CUDA, fp64
    python -m pyscf_mpcc_tpu_torch.examples.properties_showcase --device cpu

The twin of the JAX package's examples/properties_showcase.py: the same
molecule, settings and printed lines, in fp64 (as the JAX script runs
under x64) on the card unless --device cpu is given.  The RHFs and the
host copies (mp2f12, the spin-flip sector's spin-orbital CCSD) run on the
host; DF-MP2, CCSD, EOM and the GF moments on the device.  A solve that
does not converge raises.  The last line is one JSON object of the
printed values (``run``'s dict), which ``compare`` holds to PINS.
"""

import argparse
import json

import numpy as np
import torch

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.cc.driver import RCCSDDriver
from pyscf_mpcc_tpu_torch.cc.momgfccsd import MomGFCCSD
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.mp.dfmp2 import DFRMP2
from pyscf_mpcc_tpu_torch.mp.mp2f12 import energy_f12
from pyscf_mpcc_tpu_torch.scf import RHF

ATOM = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"

# printed by the JAX package's examples/properties_showcase.py (fp64 on a
# CPU), as it prints them: energies to 10 decimals, natural occupations
# and GF poles to 6, EOM roots to numpy's 8 digits, diagnostics to 5, GF
# weights to 3, the GF rdm1 gap to 3 digits
PINS = dict(
    e_rhf=-76.0267757222, e_mp2=-0.2039964883,
    natocc_unrelaxed=[1.999906, 1.987007, 1.974075, 1.97039],
    natocc_relaxed=[1.999907, 1.987053, 1.974127, 1.970592],
    e_f12=-0.1009066287, e_ccsd=-0.2133274273,
    t1_diag=0.00525, d1_diag=0.01109, d2_diag=0.12316,
    ee=[0.30062588, 0.37594404], ip=[0.43356437, 0.51865999],
    ea=[0.1674195, 0.24029463], sf=[0.27576967],
    gf_ip=[0.437715, 0.521799], gf_ip_weights=[0.934, 0.934],
    gf_rdm1_gap=2.22e-16)
# energies to 1e-8 Ha; EOM roots and GF poles to 1e-6 Ha; the rest to
# their printed digits (the natural occupations' 1e-6 is 2 half-units of
# the last digit)
TOL = dict(
    e_rhf=1e-8, e_mp2=1e-8, natocc_unrelaxed=1e-6, natocc_relaxed=1e-6,
    e_f12=1e-8, e_ccsd=1e-8, t1_diag=1e-5, d1_diag=1e-5, d2_diag=1e-5,
    ee=1e-6, ip=1e-6, ea=1e-6, sf=1e-6, gf_ip=1e-6, gf_ip_weights=1e-3,
    gf_rdm1_gap=1e-10)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dfmp2_stage(device=None):
    """The AutoAux DF-RHF (host) and DF-MP2 with its unrelaxed and
    relaxed natural occupations on ``device`` in fp64.  Returns (the
    DF-RHF, values)."""
    dev, f64 = _dev.resolve(device, torch.float64)
    mol = gto.M(atom=ATOM, basis="cc-pvdz", unit="angstrom")
    mf = RHF(mol).density_fit(auxbasis="autoaux")
    mf.conv_tol = 1e-12
    mf.kernel()
    if not mf.converged:
        raise RuntimeError("the DF-RHF did not converge")
    print(f"RHF (AutoAux DF)      E = {mf.e_tot:.10f}")
    pt = DFRMP2(mf, device=dev, dtype=f64).run()
    print(f"DF-MP2                E_corr = {pt.e_corr:.10f}")
    occ_u = _np(pt.make_natorbs(relaxed=False)[0])[:4]
    occ_r = _np(pt.make_natorbs(relaxed=True)[0])[:4]
    print(f"  natocc (unrelaxed)  {np.round(occ_u, 6)}")
    print(f"  natocc (relaxed)    {np.round(occ_r, 6)}")
    return mf, dict(e_rhf=float(mf.e_tot), e_mp2=float(pt.e_corr),
                    natocc_unrelaxed=occ_u.tolist(),
                    natocc_relaxed=occ_r.tolist())


def f12_stage(mf):
    """MP2-F12/SP with one frozen core orbital on the DF-RHF ``mf`` (the
    host copy mp/mp2f12)."""
    aux = gto.M(atom=ATOM, basis="cc-pvdz-f12-optri", unit="angstrom")
    ef12 = energy_f12(mf, aux, zeta=1.1, frozen=1)
    print(f"MP2-F12/SP (fc)       dE = {ef12:.10f}")
    return dict(e_f12=float(ef12))


def ccsd_stage(device=None):
    """The exact-integral RHF (host) and CCSD in fp64 on ``device`` to
    conv_tol 1e-10 with its diagnostics.  Returns (the driver, values)."""
    dev, f64 = _dev.resolve(device, torch.float64)
    mf = RHF(gto.M(atom=ATOM, basis="cc-pvdz", unit="angstrom"))
    mf.conv_tol = 1e-12
    mf.kernel()
    cc = RCCSDDriver(mf, device=dev, dtype=f64).set(
        conv_tol=1e-10, conv_tol_normt=1e-8).run()
    if not (mf.converged and cc.converged):
        raise RuntimeError("the RHF or CCSD did not converge")
    diag = (cc.get_t1_diagnostic(), cc.get_d1_diagnostic(),
            cc.get_d2_diagnostic())
    print(f"CCSD                  E_corr = {cc.e_corr:.10f}")
    print(f"  T1 diag = {diag[0]:.5f}  D1 = {diag[1]:.5f}  D2 = {diag[2]:.5f}")
    return cc, dict(e_ccsd=float(cc.e_corr), t1_diag=diag[0],
                    d1_diag=diag[1], d2_diag=diag[2])


def eom_stage(cc):
    """The two lowest EE, IP and EA roots of ``cc`` on its device."""
    ee = _np(cc.eeccsd(nroots=2))[:2]
    ip = _np(cc.ipccsd(nroots=2))[:2]
    ea = _np(cc.eaccsd(nroots=2))[:2]
    print(f"EE-EOM   lowest: {ee}")
    print(f"IP-EOM   lowest: {ip}")
    print(f"EA-EOM   lowest: {ea}")
    return dict(ee=ee.tolist(), ip=ip.tolist(), ea=ea.tolist())


def sf_stage(cc):
    """The lowest spin-flip root (the spin-orbital Jacobian on the host,
    through the host copy cc/gccsd_slow)."""
    sf = _np(cc.eomsf_ccsd(nroots=1))[:1]
    print(f"SF-EOM   lowest: {sf}")
    return dict(sf=sf.tolist())


def gf_stage(cc):
    """Lambda, the MOM-GF-CCSD IP poles and weights (niter 3, 3) and the
    largest gap of the GF zeroth-moment 1-RDM to Lambda's."""
    cc.solve_lambda()
    gf = MomGFCCSD(cc, niter=(3, 3))
    gf.kernel()
    ips, wts = (_np(x) for x in gf.ipgfccsd(nroots=2))
    print(f"momGF-CCSD IP poles:  {np.round(ips, 6)} (weights "
          f"{np.round(wts, 3)})")
    gap = float(np.abs(_np(gf.make_rdm1()) - _np(cc.make_rdm1())).max())
    print(f"GF moment-0 rdm1 vs Lambda rdm1: max|diff| = {gap:.2e}")
    return dict(gf_ip=ips.tolist(), gf_ip_weights=wts.tolist(),
                gf_rdm1_gap=gap)


def run(device=None):
    """The JAX script's steps in fp64 on ``device`` (default the card),
    the stages above in its order.  Prints its lines and returns the
    values."""
    dev, _ = _dev.resolve(device, torch.float64)
    mf, out = dfmp2_stage(dev)
    out.update(f12_stage(mf))
    cc, r = ccsd_stage(dev)
    out.update(r)
    for stage in (eom_stage, sf_stage, gf_stage):
        out.update(stage(cc))
    out["device"] = str(dev)
    print(json.dumps(out), flush=True)
    return out


def compare(out):
    """{key: (largest |value - pin|, tolerance)} of the pinned values in
    ``out`` (run's dict, or the union of some stages' dicts)."""
    return {k: (float(np.max(np.abs(np.asarray(out[k]) - PINS[k]))), TOL[k])
            for k in PINS if k in out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(torch.device(args.device))


if __name__ == "__main__":
    main()
