"""Time the pair-tiled DF ladder (cc/rccsd.pair_ladder_sym) over a range
of tile counts on the card: the readings that lib/memory.plan_ladder_tiles'
GEMM-shape bound (``MIN_TAU_OUTPUTS``) was set from.

For each shape and ``ntile`` it builds random fp32 factors Ld (naux, nvir,
nvir) and amplitudes tau (nocc, nocc, nvir, nvir) on the card and reports,
as one JSON line each:

- the forward sweep's seconds (CUDA events, the mean of ``--reps`` calls
  after one untimed call) and, with ``--vjp``, the seconds of the forward
  and its vjp with respect to tau and Ld (the Lambda step's ladder);
- the W elements the sweep builds over nvir^4 / 2 (``share``; 1.0 is the
  pair-symmetric minimum), the tau contraction's output elements of one
  pair (nocc^2 tsz^2) and the device peak in GiB;
- with ``--kernels``, one profiled forward call's device time split into
  GEMMs, copies and the rest, and its five longest kernels.

Usage (on the card):
    python -m pyscf_mpcc_tpu_torch.tools.ladder_tile_sweep \\
        --shape 21,243,360 --ntiles 1,2,3,4,6,9 [--vjp 2,3,4] [--kernels]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from pyscf_mpcc_tpu_torch.cc import rccsd


def _events_s(fn, reps):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def _kernels(fn):
    """Device seconds of one fn() call: ({gemm, copy, other}, its five
    longest kernels)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = dict(gemm=0.0, copy=0.0, other=0.0)
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t <= 0:
            continue
        name = ev.key.lower()
        kind = ("gemm" if "gemm" in name or "cutlass" in name else
                "copy" if "elementwise" in name or "copy" in name else
                "other")
        split[kind] += t * 1e-6
        rows.append((t * 1e-6, ev.key[:72]))
    rows.sort(reverse=True)
    return split, rows[:5]


def sweep(nocc, nvir, naux, ntiles, vjp_tiles, reps, kernels, seed=7):
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    Ld = torch.randn((naux, nvir, nvir), generator=g, device=dev) * 0.05
    tau = torch.randn((nocc, nocc, nvir, nvir), generator=g,
                      device=dev) * 0.01
    half = nvir ** 4 / 2
    for nt in sorted(set(ntiles) | set(vjp_tiles)):
        tsz = -(-nvir // nt)
        nvp = nt * tsz
        rec = dict(nocc=nocc, nvir=nvir, naux=naux, ntile=nt, tsz=tsz,
                   share=nt * (nt + 1) / 2 * tsz * tsz * nvp * nvp / half,
                   tau_outputs=nocc * nocc * tsz * tsz)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        if nt in ntiles:
            rec["fwd_s"] = _events_s(
                lambda: rccsd.pair_ladder_sym(tau, Ld, nt), reps)
            if kernels:
                split, top = _kernels(
                    lambda: rccsd.pair_ladder_sym(tau, Ld, nt))
                rec.update(fwd_split_s=split, fwd_top=top)
        if nt in vjp_tiles:
            Lg = Ld.detach().requires_grad_()
            tg = tau.detach().requires_grad_()
            ct = torch.randn_like(tau)

            def fwd_bwd():
                with torch.enable_grad():
                    out = rccsd.pair_ladder_sym(tg, Lg, nt)
                    torch.autograd.grad(out, (tg, Lg), ct)

            rec["vjp_s"] = _events_s(fwd_bwd, max(1, reps - 1))
            del Lg, tg, ct
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        print(json.dumps(rec), flush=True)


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--shape", required=True, help="nocc,nvir,naux")
    p.add_argument("--ntiles", type=_ints, required=True)
    p.add_argument("--vjp", type=_ints, default=[])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--kernels", action="store_true")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the sweep times the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    nocc, nvir, naux = _ints(a.shape)
    t0 = time.perf_counter()
    sweep(nocc, nvir, naux, a.ntiles, a.vjp, a.reps, a.kernels)
    print(json.dumps(dict(card=torch.cuda.get_device_name(0),
                          seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
