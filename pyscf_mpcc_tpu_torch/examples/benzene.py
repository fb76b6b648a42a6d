#!/usr/bin/env python
"""Benzene/cc-pVTZ all-electron DF-CCSD(T) on one card, certified: the
reference program's own headline benchmark (477.0 s for the CCSD solve
on 16 Xeon cores).

    python -m pyscf_mpcc_tpu_torch.examples.benzene --certify --triples
    python -m pyscf_mpcc_tpu_torch.examples.benzene --stage64
    python -m pyscf_mpcc_tpu_torch.examples.benzene --basis 6-31g --device cpu --certify --triples

The twin of the JAX package's examples/benzene_chip.py.  That script runs
its fp64 certification in a CPU subprocess because JAX fixes x64 per
process; torch holds both dtypes on one device, so here every stage runs
in one process, on the device the run is given:

1. The DF-RHF (weigend fitting, conv_tol 1e-10) through
   campaign.build_mf: J and K contract in fp64, on the card when the run
   is on CUDA (an fp32 J/K cannot reach a record at 1e-8), on the host
   otherwise.  The SCF is reused when its checkpoint file exists.
2. All-electron ovvv-free DF integrals (nocc = nelectron // 2) in the
   working dtype (fp32 with TF32 off on the card), DF-MP2
   (mp/mp2.df_kernel) and RCCSD to conv_tol 1e-8 and conv_tol_normt 1e-6
   (60 cycles at most), on the device DIIS ring by default.
3. --triples: cc/ccsd_t.kernel over every tile, the tile edge sized by
   lib/memory.plan_triples_tile (on the card the fused engine and the
   combine kernel; on the CPU, without config.MAX_MEMORY, tile 8).
4. --certify: Lambda to |dl| < 3e-6 (60 cycles at most), the amplitude
   checkpoint, and one lagrangian_energy in fp64 on the same device, on
   fp64 integrals rebuilt from the same B, mo and fock
   (campaign.certify).

The stages are examples/campaign.py's, which w8_parity_certify runs too.
The DIIS rings and the ladder tiles are campaign.plan_solver's (vjp=True
for Lambda).  The one knob is the JAX script's BENZENE_DIIS_BACKEND
(device or host, default device), the ring of both solves.

The checkpoint: ``np.savez`` files under .campaign/benzene/_torch (or
``scratch``): scf_<basis>.npz (mo, fock, B, e_scf, nelectron, the JAX
script's SCF cache) and amps_<basis>.npz (t1, t2, l1, l2, e32).
--stage64 certifies from these files alone and prints ``E_LAGR64 e``.

Progress goes to stderr; stdout gets one ``BENZENE {json}`` line: the
JAX script's keys and the port's own readings (nao, naux, cycles and
final |dt| and |dl|, seconds and peak GiB by stage, the (T) engine, tile
edge, tiles, launches and ms a tile, and the gaps to the JAX package's
pins and record).
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.cc import ccsd_t
from pyscf_mpcc_tpu_torch.examples import campaign as cp
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.lib import memory as _mem
from pyscf_mpcc_tpu_torch.mp import mp2
from pyscf_mpcc_tpu_torch.ops import triples_combine as tc

# benzene, experimental r(CC)=1.392 A, r(CH)=1.086 A, D6h
BENZENE = """
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

# reference benchmark table rows (doc_legacy/source/benchmark.rst:44-52):
# basis -> (CCSD total solve s, MP2 s) on the 16-core Xeon
_REFERENCE_ROWS = {
    "cc-pvtz": (477.0, 4.66),
    "6-31g**": (18.24, 0.21),
}

# cc-pVTZ pins, from the JAX package in fp64 on a CPU: gto.M(BENZENE,
# cc-pvtz), RHF(mol).density_fit() at conv_tol 1e-10, make_eris_df(...,
# keep_ovvv=False) and mp2.df_kernel, as benzene_chip.py's run_scf and
# main; and the certified E_corr of the JAX campaign (docs/PARITY.md:235)
PINS = dict(e_scf=-230.77797180559273, e_corr_mp2=-1.0351396017726135)
RECORD = dict(e_corr_certified=-1.065664516)

# the JAX script's tolerances
CCSD_TOL = dict(conv_tol=1e-8, conv_tol_normt=1e-6, max_cycle=60)
LAMBDA_TOL = dict(conv_tol=3e-6, max_cycle=60)
AUXBASIS = "weigend"


def reference_row(basis):
    """(CCSD s, MP2 s) of the reference's table for ``basis``; (None,
    None) with the JAX script's warning where it has no row."""
    if basis not in _REFERENCE_ROWS:
        print("WARNING: no reference benchmark row for basis %r -- "
              "speedup columns will be null" % basis, flush=True)
    return _REFERENCE_ROWS.get(basis, (None, None))


def default_scratch():
    return os.path.join(cp.ROOT, ".campaign", "benzene", "_torch")


def _paths(scratch, basis):
    tag = basis.replace("*", "s").replace("/", "")
    return (os.path.join(scratch, f"scf_{tag}.npz"),
            os.path.join(scratch, f"amps_{tag}.npz"))


def load_scf(path):
    """The SCF checkpoint as campaign's scf dict."""
    z = cp.npz(path)
    return dict(mo_full=z["mo"], fock_ao=z["fock"], B=z["B"],
                e_scf=z["e_scf"], nelectron=z["nelectron"])


def save_scf(path, scf):
    np.savez(path, mo=scf["mo_full"], fock=scf["fock_ao"], B=scf["B"],
             e_scf=scf["e_scf"], nelectron=scf["nelectron"])


def run_scf(device, basis, path):
    """The DF-RHF (build_mf; J/K in fp64 on ``device`` when it is the
    card), saved to the SCF checkpoint ``path``.  Returns (the scf dict,
    build_mf's readings)."""
    scf, r = cp.build_mf(BENZENE, basis, AUXBASIS,
                         jk_device=device if device.type == "cuda" else None)
    save_scf(path, scf)
    return scf, r


def load_checkpoint(basis="cc-pvtz", scratch=None):
    """(scf, amps) dicts of the checkpoint files of ``basis``."""
    scf_path, amps_path = _paths(scratch or default_scratch(), basis)
    return load_scf(scf_path), cp.npz(amps_path)


def certify_from_checkpoint(basis="cc-pvtz", device=None, scratch=None):
    """--stage64: the certified E_corr from the checkpoint files alone,
    on ``device`` (default the card).  Returns (e_lagr, readings of
    campaign.certify)."""
    dev, _ = _dev.resolve(device)
    return cp.certify(*load_checkpoint(basis, scratch), 0, dev)


def _stage(out, name, dev, t0):
    """Record stage ``name``'s seconds (since t0) and peak GiB."""
    cp.sync(dev)
    out["stage_s"][name] = time.perf_counter() - t0
    out["peak_gib"][name] = cp.peak_gib(dev)


def run(device=None, basis="cc-pvtz", certify=True, triples=True,
        scratch=None):
    """The campaign on ``device`` (default the card; lib/device.resolve
    raises without one) in its working dtype: the DF-RHF (reused from
    the checkpoint in ``scratch`` where it exists), DF-MP2, CCSD, and
    with ``triples`` the (T), with ``certify`` Lambda, the amplitude
    checkpoint and the fp64 certification.  Prints the BENZENE line and
    returns its dict."""
    dev, dtype = _dev.resolve(device)
    basis = basis.lower()
    ref_ccsd, ref_mp2 = reference_row(basis)
    scratch = scratch or default_scratch()
    os.makedirs(scratch, exist_ok=True)
    scf_path, amps_path = _paths(scratch, basis)
    out = dict(stage_s={}, peak_gib={})
    t_all = time.perf_counter()

    cp.reset_peak(dev)
    if os.path.exists(scf_path):
        scf = load_scf(scf_path)
        out.update(scf_reused=True, nao=scf["B"].shape[1],
                   naux=scf["B"].shape[0])
        cp.log(f"SCF reused: E = {float(scf['e_scf']):.10f}")
    else:
        scf, r = run_scf(dev, basis, scf_path)
        out.update(r, scf_reused=False)
    e_scf = float(scf["e_scf"])
    _stage(out, "scf", dev, t_all)

    t0 = time.perf_counter()            # all-electron
    cp.reset_peak(dev)
    er, r = cp.make_eris(scf, 0, dtype, dev)
    nocc, nvir, naux = r["nocc"], r["nvir"], r["naux"]
    _stage(out, "eris", dev, t0)

    t1_ = time.perf_counter()
    e_mp2, _ = mp2.df_kernel(er.mo_energy[:nocc], er.mo_energy[nocc:],
                             er.Lov)
    e_mp2 = float(e_mp2)
    _stage(out, "mp2", dev, t1_)
    cp.log(f"E_corr(MP2, {dtype}) = {e_mp2:.10f} "
           f"({out['stage_s']['mp2']:.2f} s; reference CPU: {ref_mp2} s)")

    n = nocc * nvir + (nocc * nvir) ** 2
    budget = cp.budget(dev)
    backend = os.environ.get("BENZENE_DIIS_BACKEND") or "device"
    kw = cp.plan_solver(n, nocc, nvir, naux, dtype, budget, backend)
    t1, t2, r = cp.solve_ccsd(er, kw, **CCSD_TOL)
    out["stage_s"]["ccsd"] = r["ccsd_s"]
    out["peak_gib"]["ccsd"] = r["peak_ccsd_gib"]
    t_ccsd = time.perf_counter() - t0
    e32, conv = r["e32"], r["ccsd_converged"]
    cp.log(f"E_corr(CCSD, {dtype}) = {e32:.10f} converged={conv} in "
           f"{r['ccsd_cycles']} cycles; CCSD wall = {t_ccsd:.1f} s "
           f"(reference 16-core CPU: {ref_ccsd} s)")
    out.update(
        system=f"benzene/{basis} all-electron DF-RCCSD", nocc=nocc,
        nvir=nvir, e_scf=e_scf, e_corr_fp32=e32, converged=conv,
        e_corr_mp2_fp32=e_mp2, mp2_sec=out["stage_s"]["mp2"],
        reference_mp2_sec=ref_mp2, ccsd_solve_sec=t_ccsd,
        scf_plus_integrals_sec=out["stage_s"]["scf"],
        reference_ccsd_sec=ref_ccsd,
        speedup_vs_reference=(round(ref_ccsd / t_ccsd, 1) if ref_ccsd
                              else None),
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        dtype=str(dtype), naux=naux, ccsd_diis=r["ccsd_diis"],
        ccsd_cycles=r["ccsd_cycles"], ccsd_normt=r["ccsd_normt"])
    if basis == "cc-pvtz":
        out.update(d_scf_vs_pin=e_scf - PINS["e_scf"],
                   d_mp2_vs_pin=e_mp2 - PINS["e_corr_mp2"])

    if triples:
        engine = ccsd_t.auto_engine(dev.type, nocc, dtype, "f32")
        tile = 8 if budget is None else _mem.plan_triples_tile(
            nocc, nvir, naux, dtype, device=dev, engine=engine)
        ntiles = len(ccsd_t._tile_triples(-(-nvir // tile)))
        n0 = tc.launch_count
        t1_ = time.perf_counter()
        cp.reset_peak(dev)
        et = ccsd_t.kernel(t1, t2, er, tile=tile)
        _stage(out, "triples", dev, t1_)
        sec = out["stage_s"]["triples"]
        out.update(e_t_fp32=et, triples_sec=sec, triples_engine=engine,
                   triples_tile=tile, triples_tiles=ntiles,
                   triples_launches=tc.launch_count - n0,
                   triples_ms_per_tile=sec / ntiles * 1e3)
        cp.log(f"E(T) = {et:.10f} ({sec:.1f} s; {engine}, {ntiles} "
               f"tiles of edge {tile}, {out['triples_launches']} "
               f"launches)")

    if certify:
        t0 = time.perf_counter()
        lkw = cp.plan_solver(n, nocc, nvir, naux, dtype, budget, backend,
                             fallback_space=2, vjp=True)
        l1, l2, r = cp.solve_lambda(t1, t2, er, lkw, **LAMBDA_TOL)
        out["stage_s"]["lambda"] = r["lambda_s"]
        out["peak_gib"]["lambda"] = r["peak_lambda_gib"]
        out.update(lambda_converged=r["lambda_converged"],
                   lambda_diis=r["lambda_diis"],
                   lambda_cycles=r["lambda_cycles"],
                   lambda_dl=r["lambda_dl"])
        t1_ = time.perf_counter()
        amps = cp.amplitudes(t1, t2, l1, l2, e32)
        np.savez(amps_path, **amps)
        out["stage_s"]["checkpoint"] = time.perf_counter() - t1_
        del er, t1, t2, l1, l2
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t1_ = time.perf_counter()
        e_l, r = cp.certify(scf, amps, 0, dev)
        _stage(out, "certify", dev, t1_)
        out.update(e_corr_fp64_lagrangian=e_l, fp32_raw_dE=abs(e32 - e_l),
                   ntile64=r["ntile64"],
                   lambda_plus_certify_sec=time.perf_counter() - t0)
        if basis == "cc-pvtz":
            out["d_certified_vs_record"] = (e_l
                                            - RECORD["e_corr_certified"])

    out["total_wall_sec"] = time.perf_counter() - t_all
    print("BENZENE " + json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--basis", default="cc-pvtz")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scratch", default=None,
                    help="checkpoint directory (default "
                         ".campaign/benzene/_torch)")
    ap.add_argument("--certify", action="store_true",
                    help="Lambda, the checkpoint and the fp64 E_L")
    ap.add_argument("--triples", action="store_true", help="the (T)")
    ap.add_argument("--scf-only", action="store_true",
                    help="the DF-RHF alone")
    ap.add_argument("--stage64", action="store_true",
                    help="certify from the checkpoint files alone")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    basis = args.basis.lower()
    if args.stage64:
        e_l, _ = certify_from_checkpoint(basis, dev, args.scratch)
        print(f"E_LAGR64 {e_l:.12f}", flush=True)
        return e_l
    if args.scf_only:
        dev, _ = _dev.resolve(dev)
        scratch = args.scratch or default_scratch()
        os.makedirs(scratch, exist_ok=True)
        scf, _ = run_scf(dev, basis, _paths(scratch, basis)[0])
        print("E(DF-RHF) = %.10f" % scf["e_scf"], flush=True)
        return float(scf["e_scf"])
    return run(dev, basis, certify=args.certify, triples=args.triples,
               scratch=args.scratch)


if __name__ == "__main__":
    main()
