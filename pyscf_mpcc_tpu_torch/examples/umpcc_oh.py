#!/usr/bin/env python
"""Open-shell MP-CC on the OH(H2O)3 doublet radical cluster through the
port's entry points: the fragmented UMPCC workflow (per-spin Pipek-Mezey
localization, iterative UMP2 bath, one MPCCSD(4,2) solve per fragment
chained fragment to fragment) and UMPCC coupled to the DF active-space T3.

    python -m pyscf_mpcc_tpu_torch.examples.umpcc_oh        # CUDA, fp32
    python -m pyscf_mpcc_tpu_torch.examples.umpcc_oh --device cpu \
        --basis sto-3g --n-act 2

The twin of the JAX package's examples/mpcc_fragmented_chip.py (the chain:
an exact-integral UHF, incore integrals, fragments OH then each water,
bath conv 1e-8, fragment conv 1e-6) and examples/umpcc_t3_chip.py (the
T3: the DF-UHF of examples/openshell_certify.py, a baseline DF-UCCSD and
kernel_pert_df with model ccsdt-3 from its amplitudes, the top --n-act
occupied and lowest --n-act virtual orbitals of each spin active, conv
1e-6 / 2e-4).  The geometry is that of examples/uccsd_oh.py.  The last
line is one JSON object of the energies and the seconds of each stage.
"""

import argparse
import json
import time

import numpy as np
import torch

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.cc import uccsd
from pyscf_mpcc_tpu_torch.examples.uccsd_oh import GEOM, uhf
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.mp import ump2
from pyscf_mpcc_tpu_torch.mpcc import umpccsd, workflow
from pyscf_mpcc_tpu_torch.scf import UHF

# atom indices per fragment: the OH radical, then the three waters
FRAGMENTS = [[0, 1], [2, 3, 4], [5, 6, 7], [8, 9, 10]]
# MPCCSD(4,2): singles relax, doubles relax on the all-active block only
MPCC42 = dict(idx_s=[], idx_d=list(range(15)))
CHAIN_CONV = dict(mp2_conv=1e-8, cc_conv=1e-6)
CC_CONV = dict(conv_tol=1e-6, conv_tol_normt=2e-4, max_cycle=80)


def exact_uhf(basis="cc-pvdz"):
    """The UHF of the fragmented chain: exact integrals, conv_tol 1e-10."""
    mol = gto.M(atom=GEOM, basis=basis, spin=1)
    mf = UHF(mol)
    mf.conv_tol = 1e-10
    return mf.run()


def chain(mf, runs=("radical", "chain", "control"), eri_ao=None, *,
          device=None, dtype=None):
    """The fragmented UMPCC runs of the record on one exact UHF: 'radical'
    (the OH fragment only), 'chain' (all four fragments chained) and
    'control' (the four fragments with nothing frozen), beside the
    iterative UMP2 bath and the global UCCSD on the same localized
    integrals.  Returns {name: E_corr} and {name: seconds}."""
    device, dtype = _dev.resolve(device, dtype)
    mol = mf.mol
    if eri_ao is None:
        eri_ao = gto.intor_eri(mol)
    e, sec = {}, {}
    args = {"radical": (FRAGMENTS[:1], MPCC42),
            "chain": (FRAGMENTS, MPCC42),
            "control": (FRAGMENTS, dict(idx_s=[], idx_d=[]))}
    c_loc = None
    for name in runs:
        frags, idx = args[name]
        t0 = time.perf_counter()
        e[name], *_, c_loc, _ = workflow.fragmented_mpcc_unrestricted(
            mol, mf, frags, eri_ao=eri_ao, device=device, dtype=dtype,
            **idx, **CHAIN_CONV)
        sec[name] = time.perf_counter() - t0
    # the global references on the same localized integrals
    t0 = time.perf_counter()
    focka, fockb = np.asarray(mf.get_fock(mf.make_rdm1()))
    er = uccsd.make_eris_incore(eri_ao, c_loc[0], c_loc[1], focka, fockb,
                                *mol.nelec, dtype, device=device)
    e["mp2"], _, _ = ump2.iterative_kernel(er, conv_tol=1e-8, max_cycle=200)
    conv, e["uccsd"], *_ = uccsd.kernel(er, **CC_CONV)
    if not conv:
        raise RuntimeError("global UCCSD did not converge")
    sec["references"] = time.perf_counter() - t0
    return e, sec


def t3_coupling(mf, n_act, *, device=None, dtype=None):
    """Baseline DF-UCCSD and kernel_pert_df (ccsdt-3, nothing frozen) on a
    DF-UHF, the top n_act occupied and lowest n_act virtual orbitals of
    each spin active.  Returns (energies, seconds)."""
    device, dtype = _dev.resolve(device, dtype)
    na, nb = mf.mol.nelec
    mo = [torch.as_tensor(c, dtype=torch.float64, device=device)
          for c in mf.mo_coeff]
    fa, fb = uccsd.uhf_focks(mf)
    t0 = time.perf_counter()
    b_ao = mf.with_df.B_ao()
    er = uccsd.make_eris_df(b_ao, mf.mo_coeff[0], mf.mo_coeff[1], fa, fb,
                            na, nb, dtype, device=device)
    b64 = torch.as_tensor(b_ao, dtype=torch.float64, device=device)
    hc = torch.as_tensor(mf.get_hcore(), dtype=torch.float64, device=device)
    B = tuple(uccsd._half(b64, c, c).to(dtype) for c in mo)
    h = tuple((c.T @ hc @ c).to(dtype) for c in mo)
    del b64
    sec = {"integrals": time.perf_counter() - t0}
    t0 = time.perf_counter()
    conv0, e0, t1, t2 = uccsd.kernel(er, **CC_CONV)
    sec["uccsd"] = time.perf_counter() - t0
    act_hole = (list(range(na - n_act, na)), list(range(nb - n_act, nb)))
    act_particle = (list(range(n_act)), list(range(n_act)))
    t0 = time.perf_counter()
    conv, e, *_ = umpccsd.kernel_pert_df(er, B, h, act_hole, act_particle,
                                         [], [], model="ccsdt-3", t1=t1,
                                         t2=t2, **CC_CONV)
    sec["pert_df"] = time.perf_counter() - t0
    if not (conv0 and conv):
        raise RuntimeError(f"UCCSD / UMPCC+T3 converged {conv0} {conv}")
    return {"uccsd": e0, "uccsd_t3": e, "coupling": e - e0}, sec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--basis", default="cc-pvdz")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    ap.add_argument("--n-act", type=int, default=10)
    args = ap.parse_args(argv)
    kw = dict(device=torch.device(args.device),
              dtype=None if args.dtype is None else getattr(torch, args.dtype))

    t0 = time.perf_counter()
    mf = exact_uhf(args.basis)
    print(f"E(UHF)       = {mf.e_tot:.10f}  converged={mf.converged}  "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    e, sec = chain(mf, **kw)
    gap = e["uccsd"] - e["mp2"]
    for name in ("mp2", "radical", "chain", "control", "uccsd"):
        print(f"{name:8s} E_corr = {e[name]:.10f}  "
              f"{100 * (e[name] - e['mp2']) / gap:5.1f} % of the "
              "MP2 -> UCCSD gap", flush=True)
    mf_df = uhf(args.basis)
    et, sec_t = t3_coupling(mf_df, args.n_act, **kw)
    print(f"DF-UCCSD     E_corr = {et['uccsd']:.10f}", flush=True)
    print(f"UMPCC+T3     E_corr = {et['uccsd_t3']:.10f}  "
          f"(coupling {et['coupling']:+.3e} Ha, {args.n_act}+{args.n_act} "
          "active a spin)", flush=True)
    print(json.dumps({"basis": args.basis, "n_act": args.n_act,
                      "device": str(kw["device"]), "e_uhf": mf.e_tot,
                      "chain": e, "chain_sec": sec, "t3": et,
                      "t3_sec": sec_t,
                      "sec": time.perf_counter() - t0}))
    return e, et


if __name__ == "__main__":
    main()
