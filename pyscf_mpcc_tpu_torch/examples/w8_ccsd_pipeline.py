#!/usr/bin/env python
"""(H2O)8/cc-pVTZ CCSD(T) end to end through the user facade.

    python -m pyscf_mpcc_tpu_torch.examples.w8_ccsd_pipeline --full      # CUDA
    python -m pyscf_mpcc_tpu_torch.examples.w8_ccsd_pipeline --small --device cpu

The twin of the JAX package's examples/w8_ccsd_pipeline.py: gto.M ->
RHF(mol).density_fit(...) (conv_tol 1e-10) -> CCSD(mf, frozen=...) with
conv_tol 1e-7 (conv_tol_normt and max_cycle the facade's own) ->
.kernel() -> .ccsd_t(tile=8), the calls a user makes.  --small (the
default) is (H2O)2/cc-pVDZ, weigend fitting, 2 frozen; --full is
(H2O)8/cc-pVTZ, cc-pVTZ-JKFIT, 8 frozen, where J and K contract in fp64
on the device.  The geometries are w8_parity_certify's.  The facade's
integrals keep ovvv (cc/eris.make_eris_df's default) and its CCSD runs
on the host DIIS ring, as in JAX.  A CCSD that does not converge within
max_cycle is reported (converged=False) and the (T) runs all the same,
as in the JAX script.

stdout gets the JAX script's lines; the solver's cycles go to stderr.
``run`` returns the readings: seconds and device peak by stage (the DF
build, the SCF, the integral transform, the CCSD, the (T)), the CCSD's
cycles, final |dt|, converged and ladder tiles, and E_SCF, E_corr, E(T)
and the total.
"""

import argparse
import contextlib
import json
import time

import torch

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.cc.driver import CCSD
from pyscf_mpcc_tpu_torch.examples import campaign as cp
from pyscf_mpcc_tpu_torch.examples import w8_parity_certify as w8
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.scf import RHF
from pyscf_mpcc_tpu_torch.scf.hf import _JKDF

# (geometry, basis, auxiliary basis, frozen core)
SMALL = w8.SMALL
FULL = w8.FULL


def run(small=True, device=None, dtype=None):
    """The pipeline on ``device`` (default the card; lib/device.resolve
    raises without one) with the CCSD and (T) in ``dtype`` (fp32 on the
    card).  Returns the readings."""
    dev, dtype = _dev.resolve(device, dtype)
    geom, basis, auxbasis, frozen = SMALL if small else FULL
    out = dict(system=f"{basis}, {auxbasis} fitting, frozen {frozen}",
               device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"), dtype=str(dtype))
    t_all = time.perf_counter()

    def stamp():
        return f"[{time.perf_counter() - t_all:7.1f}s]"

    def stage(name, fn):
        cp.reset_peak(dev)
        t0 = time.perf_counter()
        r = fn()
        cp.sync(dev)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"peak_{name}_gib"] = cp.peak_gib(dev)
        return r

    mol = gto.M(atom=geom, basis=basis)
    print(f"{stamp()} mol built: nao={mol.nao}", flush=True)
    mf = RHF(mol).density_fit(auxbasis)
    stage("df", mf.with_df.build)
    out["naux"] = mf.with_df.get_naoaux()
    print(f"{stamp()} DF built: naux={out['naux']}", flush=True)
    if not small:
        # J/K in fp64 on the device: _JKDF(device=...) alone resolves to
        # fp32 on CUDA, and an fp32 J/K cannot reach the record's E_SCF
        mf._jk = _JKDF(mf.with_df.B_ao(), device=dev, dtype=torch.float64)
    mf.conv_tol = 1e-10
    stage("scf", mf.kernel)
    out.update(e_scf=mf.e_tot, scf_converged=bool(mf.converged))
    print(f"{stamp()} E(DF-RHF) = {mf.e_tot:.10f} "
          f"converged={mf.converged}", flush=True)

    cc = CCSD(mf, frozen=frozen, device=dev, dtype=dtype)
    cc.conv_tol = 1e-7
    er = stage("ao2mo", cc.ao2mo)
    # the ladder tiles the facade plans beside its integrals
    out.update(nocc=cc.nocc, nvir=cc.nmo - cc.nocc,
               ccsd_ntile=cc.ladder_ntile(er))
    cc.verbose = 5             # the cycles, to stderr through the tee
    log = cp.Tee()
    with contextlib.redirect_stdout(log):
        e, _, _ = stage("ccsd", cc.kernel)
    cyc = log.lines("E_corr(RCCSD)")
    out.update(e_corr=e, ccsd_converged=bool(cc.converged),
               ccsd_cycles=len(cyc), ccsd_normt=cp.last_norm(cyc, "|dt|"),
               conv_tol=cc.conv_tol, conv_tol_normt=cc.conv_tol_normt,
               max_cycle=cc.max_cycle)
    out["ccsd_s_per_cycle"] = out["ccsd_s"] / max(len(cyc), 1)
    print(f"{stamp()} E_corr(DF-CCSD) = {e:.10f} "
          f"converged={cc.converged}", flush=True)
    et = stage("triples", lambda: cc.ccsd_t(tile=8))
    out["e_t"] = et
    print(f"{stamp()} E(T) = {et:.10f}", flush=True)
    out["e_tot"] = mf.e_tot + e + et
    print(f"total E = {out['e_tot']:.10f}", flush=True)
    out["wall_s"] = time.perf_counter() - t_all
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--small", action="store_true", default=True,
                      help="(H2O)2/cc-pVDZ, weigend, 2 frozen (default)")
    size.add_argument("--full", dest="small", action="store_false",
                      help="(H2O)8/cc-pVTZ, cc-pVTZ-JKFIT, 8 frozen")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    args = ap.parse_args(argv)
    dtype = None if args.dtype is None else getattr(torch, args.dtype)
    out = run(args.small, torch.device(args.device), dtype)
    print("W8PIPELINE " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
