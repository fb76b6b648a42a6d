#!/usr/bin/env python
"""Full (T) correction at (H2O)8/cc-pVTZ frozen core, every tile, on one
card, from the certified amplitude checkpoint.

    python -m pyscf_mpcc_tpu_torch.examples.w8_triples [runs] [tile]
    python -m pyscf_mpcc_tpu_torch.examples.w8_triples --dtype float64 fused:highest
    python -m pyscf_mpcc_tpu_torch.examples.w8_triples --small --device cpu xla,fused

The twin of the JAX package's examples/w8_triples_chip.py.  It runs the
complete perturbative-triples correction, every (a >= b >= c) tile of
the 424-virtual space (26,235 tiles of edge 8), through cc/ccsd_t.kernel.

Input.  The checkpoint that w8_parity_certify.run writes under
W8_SCRATCH (default .campaign/w8_parity/_torch, its ``small``
subdirectory with --small): scf.npz (B, mo_full, fock_ao, nelectron) and
amps.npz, of which only t1, t2 and e32 are read.  The JAX script reads
its own file, amps_t.npz.  The frozen core is what the checkpoint holds:
nelectron / 2 less the occupied rows of t1.  Each run rebuilds the
ovvv-free DF integrals on the device (cc/eris.make_eris_df(...,
keep_ovvv=False)) in the run's dtype and frees them after.

runs: a comma list of engine:precision specs (default fused:dot-high, as
the JAX script).  Engines: the JAX script's fused and xla, and the
port's resident and auto (cc/ccsd_t.auto_engine).  Precisions, the JAX
script's spellings: highest and dot-highest are full-precision dots
(dot_precision None), dot-high the bf16x3 tier ('high'), default the
single bf16 pass ('default'); a spec without one is highest.  An
unknown engine or precision raises before anything runs.  W8T_CHUNK
(default 1) is the tiles a kernel launch takes.  --dtype float64 runs
the integrals and the upcast amplitudes in fp64 (the bf16 tiers take
fp32 on the card and raise there).

Each run prints one ``W8TRIPLES {json}`` line: the JAX script's keys
(system, engine, tile, precision, e_ccsd_corr, e_t, wall_T_sec, device)
and the port's (engine_resolved, w1_mode, dtype, n_tiles, ms_per_tile
over the whole run, eris_s, peak_gib of the run, integrals included,
and plan_gib, what lib/memory.triples_tile_bytes counts for that engine
and tier).  A run that raises prints a line with an ``error`` key and
the next spec runs, as in the JAX script.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.cc import ccsd_t
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.examples import campaign as cp
from pyscf_mpcc_tpu_torch.examples import w8_parity_certify as w8
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.lib import memory as _mem
from pyscf_mpcc_tpu_torch.ops import triples_combine as tc

ENGINES = ("fused", "xla", "resident", "auto")
# the JAX script's precision spellings -> dot_precision
PRECISIONS = {"highest": None, "dot-highest": None, "dot-high": "high",
              "default": "default"}


def parse_specs(runs):
    """[(engine, precision, dot_precision)] of a comma list (or a list)
    of engine:precision specs; raises ValueError on an unknown one."""
    if isinstance(runs, str):
        runs = runs.split(",")
    out = []
    for spec in runs:
        engine, _, precision = spec.partition(":")
        precision = precision or "highest"
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} in {spec!r}; "
                             f"use one of {ENGINES}")
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r} in {spec!r}; "
                             f"use one of {tuple(PRECISIONS)}")
        out.append((engine, precision, PRECISIONS[precision]))
    return out


def load(scratch):
    """What the (T) needs of the checkpoint in ``scratch``: B, mo_full
    and fock_ao of scf.npz, t1, t2 and e32 of amps.npz, and the frozen
    core, nocc and system label they imply."""
    with np.load(os.path.join(scratch, "scf.npz")) as z:
        ck = {k: z[k] for k in ("B", "mo_full", "fock_ao")}
        nelectron = int(z["nelectron"])
    with np.load(os.path.join(scratch, "amps.npz")) as z:
        ck.update({k: z[k] for k in ("t1", "t2")})
        ck["e32"] = float(z["e32"])
    nocc, nvir = ck["t1"].shape
    ck.update(nocc=nocc, nvir=nvir, frozen=nelectron // 2 - nocc,
              naux=ck["B"].shape[0])
    ck["system"] = (f"(H2O){nelectron // 10} frozen-core "
                    f"(nocc {nocc}, nvir {nvir}, naux {ck['naux']})")
    return ck


def run_one(ck, engine, precision, dot, tile, dev, dtype, chunk=1):
    """One spec on the loaded checkpoint ck: the integrals built in
    dtype on dev, then ccsd_t.kernel over every tile.  Returns the
    W8TRIPLES dict (without the error handling of run)."""
    cp.reset_peak(dev)
    nocc, nvir, frozen = ck["nocc"], ck["nvir"], ck["frozen"]
    t0 = time.perf_counter()
    er = eris_mod.make_eris_df(ck["B"], ck["mo_full"][:, frozen:],
                               ck["fock_ao"], nocc, dtype=dtype,
                               keep_ovvv=False, device=dev)
    t1 = torch.as_tensor(ck["t1"]).to(dev, dtype)
    t2 = torch.as_tensor(ck["t2"]).to(dev, dtype)
    cp.sync(dev)
    eris_s = time.perf_counter() - t0
    mode = tc.w1_mode(dot)
    resolved = (ccsd_t.auto_engine(dev.type, nocc, dtype, mode)
                if engine == "auto" else engine)
    t0 = time.perf_counter()
    e_t = ccsd_t.kernel(t1, t2, er, tile=tile, engine=engine,
                        dot_precision=dot, chunk=chunk)
    cp.sync(dev)
    wall = time.perf_counter() - t0
    n_tiles = len(ccsd_t._tile_triples(-(-nvir // tile)))
    persistent, live = _mem.triples_tile_bytes(
        nocc, nvir, ck["naux"], tile, dtype, resolved, dot)
    return dict(
        system=ck["system"], engine=engine, tile=tile, precision=precision,
        e_ccsd_corr=ck["e32"], e_t=e_t, wall_T_sec=wall,
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        engine_resolved=resolved, w1_mode=mode, dtype=str(dtype),
        n_tiles=n_tiles, ms_per_tile=wall / n_tiles * 1e3, eris_s=eris_s,
        peak_gib=cp.peak_gib(dev), plan_gib=(persistent + live) / 2**30)


def run(specs="fused:dot-high", tile=8, device=None, dtype=None,
        scratch=None):
    """Every spec of ``specs`` (parse_specs) over every tile, on
    ``device`` (default the card; lib/device.resolve raises without one)
    in ``dtype`` (fp32 on the card), from the checkpoint in ``scratch``
    (default w8_parity_certify.default_scratch()).  Prints one W8TRIPLES
    line a spec and returns their dicts; a spec that raises gives a dict
    with an ``error`` key.  Each spec starts from an emptied allocator
    cache and a reset peak, so the one before leaves nothing behind."""
    dev, dtype = _dev.resolve(device, dtype)
    parsed = parse_specs(specs)
    ck = load(scratch or w8.default_scratch())
    chunk = int(os.environ.get("W8T_CHUNK", "1"))
    out = []
    for engine, precision, dot in parsed:
        try:
            r = run_one(ck, engine, precision, dot, tile, dev, dtype, chunk)
        except Exception as ex:    # the boundary: the next spec runs
            r = dict(engine=engine, precision=precision,
                     error=f"{type(ex).__name__}: {ex}")
        print("W8TRIPLES " + json.dumps(r), flush=True)
        out.append(r)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="?", default="fused:dot-high",
                    help="comma list of engine:precision")
    ap.add_argument("tile", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    ap.add_argument("--small", action="store_true",
                    help="the --small checkpoint of w8_parity_certify")
    args = ap.parse_args(argv)
    dtype = None if args.dtype is None else getattr(torch, args.dtype)
    return run(args.runs, args.tile, torch.device(args.device), dtype,
               scratch=w8.default_scratch(args.small))


if __name__ == "__main__":
    main()
