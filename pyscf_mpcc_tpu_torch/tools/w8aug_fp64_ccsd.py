"""The fp64 CCSD energy that the (H2O)8/aug-cc-pVTZ campaign's certified
energy is held to.  The JAX package never ran this campaign, so there is
no record; this converges an fp64 CCSD on the same integrals instead.

    python -m pyscf_mpcc_tpu_torch.tools.w8aug_fp64_ccsd [--e-lagr E]

The SCF is examples/w8aug_stream_certify.scf_stage (its scf.npz under
W8AUG_SCRATCH reused when it exists); the integrals its frozen-core DF
integrals in fp64 on the card, Lvv streamed from host memory (the
resident fp64 set does not fit beside the solve); rccsd.kernel to
conv_tol 1e-8 (conv_tol_normt 1e-6, 60 cycles at most) on a device DIIS
ring of 3 slots with fp32 errors (six fp64 slots would not fit beside
the solve) at ladder ntile 24: the planner's fp64 tile (14) leaves too
little beside the ring (the resident fp64 certification at 14 ran out of
the card's memory, and the streamed one peaked at 53.6 GiB).  --e-lagr: the campaign's certified E_corr,
printed beside its gap to this energy.  Prints one JSON line of readings.
"""

import argparse
import json
import time

import torch

from pyscf_mpcc_tpu_torch.examples import campaign as cp
from pyscf_mpcc_tpu_torch.examples import w8aug_stream_certify as w8aug
from pyscf_mpcc_tpu_torch.lib import device as _dev

TOL = dict(conv_tol=1e-8, conv_tol_normt=1e-6, max_cycle=60)
NTILE = 24


def run(device=None, e_lagr=None, scratch=None):
    dev, f64 = _dev.resolve(device, torch.float64)
    t_all = time.perf_counter()
    scf, out = w8aug.scf_stage(dev, scratch or w8aug.default_scratch())
    cp.reset_peak(dev)
    er, r = cp.make_eris(scf, w8aug.FROZEN, f64, dev, stream_vv=True)
    out.update(r, stream_vv=True, peak_eris_gib=cp.peak_gib(dev))
    nocc, nvir, naux = r["nocc"], r["nvir"], r["naux"]
    n = nocc * nvir + (nocc * nvir) ** 2
    kw = cp.plan_solver(n, nocc, nvir, naux, f64, cp.budget(dev),
                        space=3, err_dtype=torch.float32, ntile=NTILE)
    cp.log(f"fp64 CCSD {cp.settings(kw)}")
    _, _, r = cp.solve_ccsd(er, kw, **TOL)
    out.update(r, e_ccsd64=r["e32"], wall_s=time.perf_counter() - t_all)
    if e_lagr is not None:
        out.update(e_lagr=e_lagr, d_certified_vs_fp64=e_lagr - r["e32"])
    if not r["ccsd_converged"]:
        raise RuntimeError(f"the fp64 CCSD did not converge: {out}")
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--e-lagr", type=float, default=None,
                    help="the campaign's certified E_corr")
    args = ap.parse_args(argv)
    return run(torch.device(args.device), args.e_lagr)


if __name__ == "__main__":
    main()
