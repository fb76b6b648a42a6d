#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (pyscf_mpcc_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100 and nvcc:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ops/csrc (one nvcc process
each, started together), then runs:

  0. environment: versions, card, TF32 flags (asserted off), kernel builds
     and their register reports;
  1. the (T) epilogue kernel (triples_combine) against its plain PyTorch
     version on the card: random small problems in fp64 (staged and
     unstaged forms), and one tile at the (H2O)8 shape in fp32, with
     timings and the split of a cell's time by phase (the kernel's
     profile form);
  2. pinned H2O/cc-pVDZ energies in fp64 on the card (incore integrals):
     E(CCSD) and E(T), the latter through the CUDA kernel;
  3. the DF main path through the user entry points,
     RHF(mol).density_fit().run() -> CCSD(mf, device=cuda).run()
     -> .ccsd_t(), in fp32, against the same calls in fp64;
  4. the (H2O)8/cc-pVTZ frozen-core shape (nocc=32, nvir=424,
     naux=1216) with synthetic DF integrals: CCSD sweep time, rate and
     peak memory, an fp32-vs-fp64 sweep check, and a 64-tile (T) probe
     on the fused engine, and the same probe at chunk=4 (four tiles a
     launch of the epilogue kernel) with the kernel alone timed at K=4
     against K=1;
  5. the resident (T) engine (triples_resident, W1 dots in the kernel;
     modes split and bf16 on wgmma with operands split into bf16 once by
     the prep, mode f32 on FFMA): (a) the kernel against its plain
     version on random problems (fp64 mode f32, fp32 modes split and
     bf16), (b) one (H2O)8 tile in modes f32, split and bf16 through the
     prep of each mode: the kernel's time, its W1 share (its time less
     its time with F cut to one k-chunk of the mode) and W1 rate, the
     path's time, the one-time cost of splitting t2, beside the fused
     engine's path, (c) the pinned fp64 E(T) through engine='resident',
     (d) the 64-tile probe through engine='resident' in modes f32, split
     (through engine='auto', which routes dot_precision='high' there) and
     bf16, beside phase 4's;
  6. the (T) design probes (pyscf_mpcc_tpu_torch/tools): p1-p4 of
     triples_probe_v6 and the slab relayout at the JAX scripts' own
     shapes through their entry points, then each of their five kernels
     against its plain version (dispatch, smem and slab exact; dots rtol
     1e-5 on random inputs in each mode; stream fp64 sums rtol 1e-10),
     with its time, the plain version's, a library call's and the bound
     (the largest of bytes, operations and the launch floor, p1's
     graph-replayed empty kernel).  The dots kernel and its library calls
     are timed on operands made beforehand (bf16 for 'bf16' and 'split',
     the split pass timed apart), with the kernel's copy-only form and
     the L2 rate; the slab relayout and permute().contiguous() cold and
     warm.

Every phase raises on failure.  The last lines are the kernel record
(each kernel's launches on the full-width probe, its error against the
plain version, its time, the plain version's time and the least time the
card could take, from the peak rates below), the card's name and power
limit, and {"ok": true, "device": {...}}.
Without a CUDA device, or without the repository beside it, the script
exits non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# pinned reference values (the JAX package's tests/test_rccsd.py and
# tests/test_ccsd_t.py, from the reference's own pins)
E_CCSD_SYM = -0.2133432312951
E_T_TILT = -0.0033300722704016289
# (H2O)8/cc-pVTZ frozen core, the JAX package's production shape
NOCC, NVIR, NAUX, TILE = 32, 424, 1216, 8
NPROBE = 64
# fp64 kernel vs plain: identical inputs, only the summation order differs
RTOL_FP64 = 1e-10
# fp32 tile at the (H2O)8 shape: both sides round W, V and Z in fp32
# (unit roundoff 6e-8) along different summation orders; the tile energy
# is a sum of mostly same-signed terms, so its relative error stays near
# 1e-6; 1e-5 leaves a 10x margin
RTOL_TILE_FP32 = 1e-5
# fp32 vs fp64 CCSD sweep: relative t2 difference; true fp32 GEMMs give
# ~1e-6, a TF32 matmul ~1e-3, so 1e-4 separates the two
RTOL_SWEEP_FP32 = 1e-4
# fp32 vs fp64 main path (the issue's acceptance bound)
ATOL_MAIN_FP32 = 1e-6
# resident 'split' (bf16x3) vs 'f32' probe energy: the JAX package's own
# wiring bound for the mode (tests/test_triples_fused.py:145)
RTOL_SPLIT = 5e-4
# probe dots kernel vs plain, random inputs of both signs: both sum the
# same fp32 (or exact bf16) products over K = 424 in different orders;
# the atol is this times the largest plain value (cancellation)
RTOL_DOTS = 1e-5
# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W):
# bytes/s of HBM3 and FLOP/s per operand type, for the kernels' bounds
PEAK = {"bytes": 3.35e12, "fp32": 67e12, "fp64": 67e12, "bf16": 989e12}


def say(phase, msg, **kw):
    extra = " ".join(f"{k}={v}" for k, v in kw.items())
    print(f"[phase {phase}] {msg} {extra}".rstrip(), flush=True)


def nvidia_smi(query):
    """First line of nvidia-smi's csv answer to --query-gpu=query."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


# sampled beside the timed phases: a card below its clocks or power runs
# slower, and the timings are read against these
CLOCKS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def cuda_ms(torch, fn, n):
    """Mean device milliseconds of fn over n launches (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def trace_top(torch, fn, n, k=6):
    """Device time per call of the k costliest kernels of fn, from a
    torch.profiler trace over n calls: [(name, ms per call, calls)]."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            rows.append((ev.key[:48], round(us / n / 1e3, 4),
                         ev.count // n))
    return sorted(rows, key=lambda r: -r[1])[:k]


def nbytes(*xs):
    """Bytes of the tensors in xs (nested lists allowed; None skipped)."""
    tot = 0
    for x in xs:
        if isinstance(x, (list, tuple)):
            tot += nbytes(*x)
        elif x is not None:
            tot += x.numel() * x.element_size()
    return tot


def bound_ms(nbyte, flops):
    """Least milliseconds for nbyte of traffic and flops {type: count}:
    the larger of the byte time and the summed operation times."""
    t_b = nbyte / PEAK["bytes"]
    t_o = sum(n / PEAK[k] for k, n in flops.items())
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pyscf_mpcc_tpu_torch import config, testing
    from pyscf_mpcc_tpu_torch.gto import native
    from pyscf_mpcc_tpu_torch.cc import ccsd_t, rccsd
    from pyscf_mpcc_tpu_torch.cc.driver import CCSD
    from pyscf_mpcc_tpu_torch.cc.eris import RERIs
    from pyscf_mpcc_tpu_torch.lib import device as devpol
    from pyscf_mpcc_tpu_torch.lib import memory
    from pyscf_mpcc_tpu_torch.ops import _build
    from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
    from pyscf_mpcc_tpu_torch.ops import triples_resident as tr
    from pyscf_mpcc_tpu_torch.scf import RHF
    from pyscf_mpcc_tpu_torch.tools import slab_loop_probe as sp
    from pyscf_mpcc_tpu_torch.tools import triples_probe_v6 as pv

    f64, f32 = torch.float64, torch.float32
    dev = torch.device("cuda")

    # ---- phase 0: environment --------------------------------------------
    smi = nvidia_smi("name,power.limit").strip()
    devpol.set_fp32_precision()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    t0 = time.perf_counter()
    kernels = ("triples_combine", "triples_resident", "triples_probe",
               "slab_relayout")
    _build.load_all(kernels)
    build_s = time.perf_counter() - t0
    say(0, "env", torch=torch.__version__, cuda=torch.version.cuda,
        card=json.dumps(smi), gpus=torch.cuda.device_count(),
        native_integrals=native.available(),
        kernel_build_s=f"{build_s:.2f}")
    for name in kernels:
        for ln in _build.build_info[name]["log"].splitlines():
            if "registers" in ln or "spill" in ln or "wgmma" in ln:
                say(0, "ptxas", kernel=name, line=json.dumps(ln.strip()))
    say(0, "clocks", sm_max_power_temp=json.dumps(nvidia_smi(CLOCKS)))

    # ---- phase 1: kernel against its plain version -----------------------
    nchk = 0
    for nocc in (3, 5):
        for mode in (None, "exclude_active", "only_active"):
            for K in (1, 4):
                t1, t2, er = testing.triples_tensors(
                    *testing.random_triples_problem(
                        nocc, 7, 11 + nocc, naux=11 if K == 4 else None),
                    dev, f64)
                act = dict(act_hole=[0, 2], act_particle=[1, 3, 4]) \
                    if mode else dict(act_hole=None, act_particle=None)
                big = ccsd_t._prepare(t1, t2, er, 3, f64, act["act_hole"],
                                      act["act_particle"], 1.0, "fused")
                prep = ccsd_t.make_prep_fused(big)
                eijk, actocc = ccsd_t.fused_shared(big)
                trips = ccsd_t._tile_triples(big["nvp"] // 3)
                out = ccsd_t.stack_prep([prep(abc) for abc in trips[:K]])
                kw = dict(actv=out[10], actocc=actocc, act_mode=mode) \
                    if mode else {}
                args = (*out[:8], eijk, *out[8:10])
                e_k = tc.tile_energy_fused_chunk(*args, **kw)
                e_p = tc.tile_energy_fused_reference_chunk(*args, **kw)
                torch.cuda.synchronize()
                if not torch.isfinite(e_k).all():
                    raise RuntimeError("non-finite kernel energies")
                torch.testing.assert_close(e_k, e_p, rtol=RTOL_FP64,
                                           atol=1e-14)
                nchk += 1
    # fp64 at nocc=28, the top of the staged form (V-term inputs read from
    # device memory), and at 30, the unstaged form (W exceeds smem)
    for nocc in (28, 30):
        t1, t2, er = testing.triples_tensors(
            *testing.random_triples_problem(nocc, 4, 9), dev, f64)
        big = ccsd_t._prepare(t1, t2, er, 2, f64, None, None, 1.0, "fused")
        out = ccsd_t.make_prep_fused(big)((1, 1, 0))
        args = (*out[:8], ccsd_t.fused_shared(big)[0], *out[8:10])
        torch.testing.assert_close(tc.tile_energy_fused(*args),
                                   tc.tile_energy_fused_reference(*args),
                                   rtol=RTOL_FP64, atol=1e-14)
        nchk += 1
    say(1, "random problems fp64 ok", cases=nchk, rtol=RTOL_FP64)

    gen = torch.Generator(device=dev).manual_seed(0)
    beris = testing.synthetic_eris(NOCC, NVIR, NAUX, device=dev, dtype=f32,
                                   generator=gen, build_ovvv=False)
    _, bt1, bt2 = rccsd.init_amps(beris)
    big = ccsd_t._prepare(bt1, bt2, beris, TILE, f32, None, None, 1.0,
                          "fused")
    out = ccsd_t.make_prep_fused(big)((5, 3, 1))
    eijk, _ = ccsd_t.fused_shared(big)
    args = (*out[:8], eijk, *out[8:10])
    del big
    n0 = tc.launch_count
    e_k = float(tc.tile_energy_fused(*args))
    e_p = float(tc.tile_energy_fused_reference(*args))
    e_64 = float(tc.tile_energy_fused_reference(
        *[[w.double() for w in a] if isinstance(a, list)
          else (a.double() if a.is_floating_point() else a) for a in args]))
    tile_err = abs(e_k - e_p)
    if not (tile_err <= RTOL_TILE_FP32 * abs(e_p)):
        raise RuntimeError(f"fp32 tile: kernel {e_k!r} vs plain {e_p!r}")
    ms_k = cuda_ms(torch, lambda: tc.tile_energy_fused(*args), 20)
    ms_p = cuda_ms(torch, lambda: tc.tile_energy_fused_reference(*args), 5)
    # bound: read the six W1 streams and the slices once; the w2 dots,
    # 6 o^4 multiply-adds per cell of nonzero weight, in fp32
    ncell = int((ccsd_t._weights([5 * TILE, 3 * TILE, TILE], TILE, f64, dev)
                 != 0).sum())
    comb_bound = bound_ms(nbytes(args) + 8 * TILE ** 3,
                          {"fp32": 2 * 6 * ncell * NOCC ** 4})
    say(1, "bench tile fp32 ok", shape=f"o={NOCC},T={TILE},nvir={NVIR}",
        e_kernel=repr(e_k), e_plain=repr(e_p), e_fp64_plain=repr(e_64),
        abs_err=f"{tile_err:.3e}", rtol=RTOL_TILE_FP32,
        kernel_ms=f"{ms_k:.3f}", plain_ms=f"{ms_p:.3f}",
        bound_ms=f"{comb_bound[0]:.3f}", bound_by=comb_bound[1],
        launches=tc.launch_count - n0,
        share_of_bound=f"{comb_bound[0] / ms_k:.3f}")
    # where a cell's time goes: the kernel's profile form stamps the SM
    # clock at each phase boundary of every cell (a barrier before each
    # stamp); shares of the summed clocks of the cells of nonzero weight,
    # with the profile form's time per tile
    e_prof, cyc = tc.tile_energy_fused_profile(*args)
    if not abs(e_prof.item() - e_k) <= RTOL_TILE_FP32 * abs(e_p):
        raise RuntimeError(f"profile form: {e_prof.item()!r} vs kernel "
                           f"{e_k!r}")
    ms_prof = cuda_ms(torch, lambda: tc.tile_energy_fused_profile(*args), 10)
    tot = cyc[..., -1].sum().item()
    shares = {name: cyc[..., n].sum().item() / tot
              for n, name in enumerate(tc.PHASES)}
    busy = cyc[..., -1][cyc[..., -1] > 0].double()
    say(1, "bench tile phase split", profile_ms=f"{ms_prof:.4f}",
        shares=json.dumps({k: round(v, 4) for k, v in shares.items()}),
        ms_by_phase=json.dumps({k: round(v * ms_prof, 4)
                                for k, v in shares.items()}),
        cells=busy.numel(), clocks_per_cell_mean=f"{busy.mean():.0f}",
        clocks_per_cell_max=f"{busy.max():.0f}",
        abs_err=f"{abs(e_prof.item() - e_p):.3e}")
    del args, out

    # ---- phase 2: pinned fp64 energies on the card -----------------------
    def rhf(geom, df=False):
        mf = RHF(testing.mol_of(geom))
        if df:
            mf.density_fit()
        mf.conv_tol = 1e-13
        mf.conv_tol_grad = 1e-10
        return mf.run()

    t0 = time.perf_counter()
    cc = CCSD(rhf("sym"), device=dev, dtype=f64)
    cc.set(conv_tol=1e-10, conv_tol_normt=1e-8).run()
    d_ccsd = cc.e_corr - E_CCSD_SYM
    if not (cc.converged and abs(d_ccsd) < 1e-7):
        raise RuntimeError(f"E(CCSD) {cc.e_corr!r} off the pin by {d_ccsd}")
    tilt = CCSD(rhf("tilt"), device=dev, dtype=f64)
    tilt.set(conv_tol=1e-12, conv_tol_normt=1e-10, max_cycle=200).run()
    n0 = tc.launch_count
    e_t = tilt.ccsd_t()
    nl = tc.launch_count - n0
    d_t = e_t - E_T_TILT
    if not (tilt.converged and abs(d_t) < 1e-9 and nl > 0):
        raise RuntimeError(f"E(T) {e_t!r} off the pin by {d_t} "
                           f"({nl} kernel launches)")
    say(2, "pinned fp64 ok", e_ccsd_err=f"{d_ccsd:.2e}",
        e_t=repr(e_t), e_t_err=f"{d_t:.2e}", kernel_launches=nl,
        seconds=f"{time.perf_counter() - t0:.1f}")

    # ---- phase 3: the DF main path through the user entry points ---------
    t0 = time.perf_counter()
    mf = RHF(testing.mol_of("sym")).density_fit().run()
    tc.launch_count = 0
    cc32 = CCSD(mf, device=dev).run()
    et32 = cc32.ccsd_t()
    main_launches = tc.launch_count
    t_main = time.perf_counter() - t0
    cc64 = CCSD(mf, device=dev, dtype=f64).run()
    et64 = cc64.ccsd_t()
    de, dt = cc32.e_corr - cc64.e_corr, et32 - et64
    if not (cc32.converged and cc64.converged and main_launches > 0
            and abs(de) < ATOL_MAIN_FP32 and abs(dt) < ATOL_MAIN_FP32):
        raise RuntimeError(f"DF main path fp32 vs fp64: dE_corr={de}, "
                           f"dE(T)={dt}, launches={main_launches}")
    say(3, "DF main path ok", dtype=str(cc32.t2.dtype),
        e_corr=repr(cc32.e_corr), e_t=repr(et32), d_e_corr=f"{de:.2e}",
        d_e_t=f"{dt:.2e}", kernel_launches=main_launches,
        seconds_fp32=f"{t_main:.1f}")
    # the kernel against its plain version on one tile of this path's own
    # (T) inputs (nocc=5, padded virtuals), after the launch count was read
    big = ccsd_t._prepare(cc32.t1, cc32.t2, cc32.eris, TILE, f32, None,
                          None, 1.0, "fused")
    out = ccsd_t.make_prep_fused(big)((2, 1, 0))
    args = (*out[:8], ccsd_t.fused_shared(big)[0], *out[8:10])
    torch.testing.assert_close(tc.tile_energy_fused(*args),
                               tc.tile_energy_fused_reference(*args),
                               rtol=RTOL_TILE_FP32, atol=1e-12)
    say(3, "main-path tile ok", shape=f"o={big['o']},T={TILE}",
        nvir=cc32.t1.shape[1], rtol=RTOL_TILE_FP32)
    del cc32, cc64, big, out, args

    # ---- phase 4: the (H2O)8 shape ---------------------------------------
    torch.cuda.reset_peak_memory_stats()
    ntile = memory.plan_ladder_ntile(NOCC, NVIR, NAUX, f32, device=dev)
    rccsd.update_amps(bt1, bt2, beris, ntile=ntile)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        a1, a2 = rccsd.update_amps(bt1, bt2, beris, ntile=ntile)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sec = statistics.median(times)
    fl = rccsd.flops_per_update(NOCC, NVIR, NAUX)
    fl_exec = rccsd.flops_per_update(NOCC, NVIR, NAUX, ntile)
    peak = torch.cuda.max_memory_allocated()
    del a1
    if not torch.isfinite(a2).all():
        raise RuntimeError("non-finite fp32 sweep")
    say(4, "ccsd sweep fp32", ntile=ntile,
        sec=" ".join(f"{t:.4f}" for t in times), sec_median=f"{sec:.4f}",
        tflops_dense_equiv=f"{fl / sec / 1e12:.2f}",
        tflops_executed=f"{fl_exec / sec / 1e12:.2f}",
        peak_gib=f"{peak / 2**30:.2f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    e64 = RERIs(*(None if x is None else x.double() for x in beris))
    ntile64 = memory.plan_ladder_ntile(NOCC, NVIR, NAUX, f64, device=dev)
    t0 = time.perf_counter()
    _, b2 = rccsd.update_amps(bt1.double(), bt2.double(), e64,
                              ntile=ntile64)
    torch.cuda.synchronize()
    sec64 = time.perf_counter() - t0
    rel = float(torch.linalg.norm(a2.double() - b2) / torch.linalg.norm(b2))
    del e64, b2, a2
    if not rel < RTOL_SWEEP_FP32:
        raise RuntimeError(f"fp32 sweep deviates from fp64 by {rel}")
    say(4, "fp32 vs fp64 sweep ok", rel_t2_diff=f"{rel:.3e}",
        rtol=RTOL_SWEEP_FP32, ntile_fp64=ntile64, sec_fp64=f"{sec64:.3f}")

    def probe(engine, launches, **kw):
        """E(T) over the first NPROBE tiles through ccsd_t.kernel (the
        entry point) after a warm-up run; launches is the kernel module
        whose count is zeroed just before the timed run.  Returns
        (energy, ms per tile, launches in the timed run)."""
        orig = ccsd_t._tile_triples
        ccsd_t._tile_triples = lambda nvt: orig(nvt)[:NPROBE]
        try:
            ccsd_t.kernel(bt1, bt2, beris, tile=TILE, engine=engine, **kw)
            torch.cuda.synchronize()
            launches.launch_count = 0
            t0 = time.perf_counter()
            e = ccsd_t.kernel(bt1, bt2, beris, tile=TILE, engine=engine,
                              **kw)
            ms = (time.perf_counter() - t0) / NPROBE * 1e3
            n = launches.launch_count
        finally:
            ccsd_t._tile_triples = orig
        if not (e == e and abs(e) < float("inf")):
            raise RuntimeError(f"non-finite (T) probe energy {e}")
        return e, ms, n

    e_probe, probe_ms, comb_launches = probe("fused", tc)
    if comb_launches == 0:
        raise RuntimeError("the fused probe launched no combine kernel")
    say(4, "(T) probe", tiles=NPROBE, launches=comb_launches,
        ms_per_tile=f"{probe_ms:.3f}",
        kernel_ms_per_tile=f"{ms_k:.3f}", plain_ms_per_tile=f"{ms_p:.3f}",
        e_probe=repr(e_probe), clocks_after=json.dumps(nvidia_smi(CLOCKS)),
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        max_memory_mb=config.MAX_MEMORY)

    # the chunk form (tile_energy_fused_chunk): the probe at chunk=4, and
    # the kernel alone on four stacked tiles (K=4) against the same tiles
    # one launch each (K=1)
    e_c4, probe_ms_c4, c4_launches = probe("fused", tc, chunk=4)
    if not (abs(e_c4 - e_probe) <= RTOL_TILE_FP32 * abs(e_probe)
            and c4_launches > 0):
        raise RuntimeError(f"chunk=4 probe {e_c4!r} vs chunk=1 {e_probe!r} "
                           f"({c4_launches} launches)")
    bigc = ccsd_t._prepare(bt1, bt2, beris, TILE, f32, None, None, 1.0,
                           "fused")
    prepc = ccsd_t.make_prep_fused(bigc)
    eijk_c = ccsd_t.fused_shared(bigc)[0]
    trips4 = ccsd_t._tile_triples(bigc["nvp"] // TILE)[:4]
    outs = [prepc(abc) for abc in trips4]
    del bigc, prepc
    ncell4 = sum(int((ccsd_t._weights([a * TILE, b * TILE, c * TILE], TILE,
                                      f64, dev) != 0).sum())
                 for a, b, c in trips4)
    args1 = [(*x[:8], eijk_c, *x[8:10]) for x in outs]
    c4 = ccsd_t.stack_prep(outs)
    args4 = (*c4[:8], eijk_c, *c4[8:10])
    e_k4 = tc.tile_energy_fused_chunk(*args4)
    e_k1 = torch.stack([tc.tile_energy_fused(*a) for a in args1])
    torch.testing.assert_close(e_k4, e_k1, rtol=RTOL_FP64, atol=1e-14)
    chunk_err = float((e_k4 - tc.tile_energy_fused_reference_chunk(
        *args4)).abs().max())
    if not chunk_err <= RTOL_TILE_FP32 * float(e_k4.abs().max()):
        raise RuntimeError(f"chunk kernel vs plain: {chunk_err}")
    chunk_ms = cuda_ms(torch, lambda: tc.tile_energy_fused_chunk(*args4),
                       10) / 4
    single_ms = cuda_ms(torch, lambda: [tc.tile_energy_fused(*a)
                                         for a in args1], 10) / 4
    chunk_plain_ms = cuda_ms(
        torch, lambda: tc.tile_energy_fused_reference_chunk(*args4), 3) / 4
    chunk_bound = bound_ms(nbytes(args4) + 4 * 8 * TILE ** 3,
                           {"fp32": 2 * 6 * ncell4 * NOCC ** 4})
    say(4, "(T) probe chunk=4", tiles=NPROBE, launches=c4_launches,
        ms_per_tile=f"{probe_ms_c4:.3f}", ms_per_tile_chunk1=f"{probe_ms:.3f}",
        e_probe=repr(e_c4), kernel_ms_per_tile_k4=f"{chunk_ms:.3f}",
        kernel_ms_per_tile_k1=f"{single_ms:.3f}",
        plain_ms_per_tile_k4=f"{chunk_plain_ms:.3f}",
        bound_ms_per_tile=f"{chunk_bound[0] / 4:.3f}", cells=ncell4)
    del outs, args1, c4, args4

    # ---- phase 5: the resident (T) engine --------------------------------
    def resident_chunk(nocc, nvir, seed, dtype, tile, tiles, act, df,
                       mode="f32"):
        t1, t2, er = testing.triples_tensors(
            *testing.random_triples_problem(nocc, nvir, seed,
                                            naux=11 if df else None),
            dev, dtype)
        kw = dict(act_hole=[0, 2], act_particle=[1, 3, 4]) if act \
            else dict(act_hole=None, act_particle=None)
        big = ccsd_t._prepare(t1, t2, er, tile, dtype, kw["act_hole"],
                              kw["act_particle"], 1.0, "resident", mode)
        prep = ccsd_t.make_prep_resident(big)
        eijk, actocc = ccsd_t.fused_shared(big)
        trips = ccsd_t._tile_triples(big["nvp"] // tile)
        out = ccsd_t.stack_prep_resident([prep(trips[n]) for n in tiles])
        akw = dict(act3=out[9], actocc=actocc, act_mode=act) if act else {}
        return (*out[:7], eijk, *out[7:9]), akw

    def check_resident(args, akw, mode, rtol, atol):
        e_k = tr.tile_energy_resident_chunk(*args, mode=mode, **akw)
        e_p = tr.tile_energy_resident_reference_chunk(*args, mode=mode,
                                                      **akw)
        torch.cuda.synchronize()
        if not torch.isfinite(e_k).all():
            raise RuntimeError("non-finite resident kernel energies")
        torch.testing.assert_close(e_k, e_p, rtol=rtol, atol=atol)

    nchk = 0
    for nocc in (3, 5):
        for act in (None, "exclude_active", "only_active"):
            for K in (1, 4):
                check_resident(*resident_chunk(nocc, 7, 11 + nocc, f64, 3,
                                               range(K), act, K == 4),
                               "f32", RTOL_FP64, 1e-14)
                nchk += 1
    # odd tile: nvir=7 at tile 4 pads the virtuals (weight-zero cells)
    check_resident(*resident_chunk(4, 7, 9, f64, 4, range(4), None, False),
                   "f32", RTOL_FP64, 1e-14)
    nchk += 1
    for mode in ("split", "bf16"):
        for act in (None, "only_active"):
            check_resident(*resident_chunk(5, 9, 4, f32, 3, range(4), act,
                                           True, mode),
                           mode, RTOL_TILE_FP32, 1e-9)
            nchk += 1
    say(5, "random problems ok", cases=nchk, rtol_fp64_f32=RTOL_FP64,
        rtol_fp32_split_bf16=RTOL_TILE_FP32)

    # (b) one tile of the bench shape in each W1 mode, through the prep of
    # that mode (split, bf16: t2 split into bf16 once per call, each tile's
    # ov blocks once per tile)
    abc = (5, 3, 1)
    # k depth of one staged chunk of the kernel in each mode (f32:
    # ffma_bk<float> of triples_resident.cu); the W1 share is the kernel's
    # time less its time with F cut to one chunk
    kchunk = {"f32": 16, **tr.MMA_KC}
    bigf = ccsd_t._prepare(bt1, bt2, beris, TILE, f32, None, None, 1.0,
                           "fused")
    prep_f = ccsd_t.make_prep_fused(bigf)
    eijk = ccsd_t.fused_shared(bigf)[0]

    def fused_path():
        o = prep_f(abc)
        return tc.tile_energy_fused(*o[:8], eijk, *o[8:10])

    def to64(a):
        return [to64(x) for x in a] if isinstance(a, (list, tuple)) \
            else a.double()

    def cut_f(x, mode, axis):
        """A W1 operand (or (hi, lo) pair) with f cut to its first k-chunk:
        the f axis of a dense one, the chunk axis of a tiled one."""
        if isinstance(x, tuple):
            return tuple(cut_f(h, mode, axis) for h in x)
        if mode == "f32":
            return x.narrow(axis, 0, kchunk[mode]).contiguous()
        return x.narrow(axis, 0, 1).contiguous()

    res = {}
    w1_flops = 2 * 6 * ncell * NOCC ** 3 * NVIR
    for mode in ("f32", "split", "bf16"):
        bigr = ccsd_t._prepare(bt1, bt2, beris, TILE, f32, None, None, 1.0,
                               "resident", mode)
        split_ms = (cuda_ms(torch, lambda: tr.t2_operand(
            bigr["t2T"], mode), 3) if mode != "f32" else 0.0)
        prep_r = ccsd_t.make_prep_resident(bigr)
        out = prep_r(abc)
        rargs = (*out[:7], eijk, *out[7:9])
        if mode == "f32":
            e_r64 = float(tr.tile_energy_resident_reference(
                *to64(rargs), mode="f32"))

        def resident_path(prep_r=prep_r, mode=mode):
            o = prep_r(abc)
            return tr.tile_energy_resident(*o[:7], eijk, *o[7:9], mode=mode)

        kc = kchunk[mode]
        # t2: f is axis 1 dense, the chunk axis 1 tiled; ov: 3 and 2
        cargs = ([cut_f(x, mode, 1) for x in rargs[0]],
                 [cut_f(x, mode, 3 if mode == "f32" else 2)
                  for x in rargs[1]], *rargs[2:])
        e_k = float(tr.tile_energy_resident(*rargs, mode=mode))
        e_p = float(tr.tile_energy_resident_reference(*rargs, mode=mode))
        err = abs(e_k - e_p)
        if not err <= RTOL_TILE_FP32 * abs(e_p):
            raise RuntimeError(f"resident {mode} tile: kernel {e_k!r} vs "
                               f"plain {e_p!r}")
        ms_rk = cuda_ms(torch, lambda: tr.tile_energy_resident(
            *rargs, mode=mode), 10)
        ms_rp = cuda_ms(torch, lambda: tr.tile_energy_resident_reference(
            *rargs, mode=mode), 3)
        ms_path = cuda_ms(torch, resident_path, 10)
        ms_cut = cuda_ms(torch, lambda: tr.tile_energy_resident(
            *cargs, mode=mode), 10)
        ms_w1 = ms_rk - ms_cut
        nmma = 3 if mode == "split" else 1
        flops = ({"fp32": w1_flops} if mode == "f32"
                 else {"bf16": nmma * w1_flops})
        flops["fp32"] = flops.get("fp32", 0) + 2 * 6 * ncell * NOCC ** 4
        bnd = bound_ms(nbytes(rargs) + 8 * TILE ** 3, flops)
        res[mode] = dict(e=e_k, err=err, ms=ms_rk, plain_ms=ms_rp,
                         bound=bnd)
        say(5, f"bench tile {mode} ok", shape=f"o={NOCC},T={TILE},"
            f"nvir={NVIR}", e_kernel=repr(e_k), e_plain=repr(e_p),
            e_fp64_plain_f32=repr(e_r64),
            rel_err_vs_fp64=f"{abs(e_k - e_r64) / abs(e_r64):.3e}",
            abs_err=f"{err:.3e}", rtol=RTOL_TILE_FP32,
            kernel_ms=f"{ms_rk:.4f}", plain_ms=f"{ms_rp:.3f}",
            path_ms=f"{ms_path:.4f}", cut_f=kc,
            kernel_ms_cut=f"{ms_cut:.4f}", w1_ms=f"{ms_w1:.4f}",
            w1_tflops=f"{w1_flops / ms_w1 / 1e9:.1f}",
            w1_mma_tflops=f"{nmma * w1_flops / ms_w1 / 1e9:.1f}",
            t2_split_ms=f"{split_ms:.3f}",
            stages=tr._lib().triples_resident_stages(NOCC, 4,
                                                     tr.MODES[mode]),
            bound_ms=f"{bnd[0]:.3f}", bound_by=bnd[1])
        say(5, f"trace {mode} path", top=json.dumps(
            trace_top(torch, resident_path, 5)))
        if mode != "f32":
            hl = bigr["t2T_w1"]
            say(5, f"t2 {mode} operand", gib=f"{nbytes(hl) / 2**30:.3f}",
                t2T_fp32_gib=f"{nbytes(bigr['t2T']) / 2**30:.3f}")
        del bigr, prep_r, out, rargs, cargs, resident_path
    ms_fpath = cuda_ms(torch, fused_path, 10)
    say(5, "bench tile fused path (W1 GEMMs + epilogue kernel)",
        path_ms=f"{ms_fpath:.3f}", epilogue_kernel_ms=f"{ms_k:.3f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    say(5, "trace fused path", top=json.dumps(
        trace_top(torch, fused_path, 5)))
    del bigf, prep_f

    # (c) the pinned fp64 E(T) through the resident kernel
    tr.launch_count = 0
    e_t = ccsd_t.kernel(tilt.t1, tilt.t2, tilt.eris, tile=8,
                        engine="resident")
    nl = tr.launch_count
    d_t = e_t - E_T_TILT
    if not (abs(d_t) < 1e-9 and nl > 0):
        raise RuntimeError(f"resident E(T) {e_t!r} off the pin by {d_t} "
                           f"({nl} kernel launches)")
    say(5, "pinned fp64 ok", e_t=repr(e_t), e_t_err=f"{d_t:.2e}",
        kernel_launches=nl)

    # (d) the 64-tile probe through engine='resident', beside the fused
    # probe (fused, resident f32, split through engine='auto', bf16, fused
    # again)
    e_f32, pms_f32, f32_launches = probe("resident", tr)
    e_split, pms_split, res_launches = probe("auto", tr, dot_precision="high")
    e_bf16, pms_bf16, bf16_launches = probe("resident", tr,
                                            dot_precision="default")
    e_fused2, probe_ms2, _ = probe("fused", tc)
    d_fused = abs(e_f32 - e_probe) / abs(e_probe)
    d_split = abs(e_split - e_f32) / abs(e_f32)
    if not (d_fused <= RTOL_TILE_FP32 and d_split <= RTOL_SPLIT
            and min(f32_launches, res_launches, bf16_launches) > 0):
        raise RuntimeError(f"resident probe: f32 {e_f32!r}, split "
                           f"{e_split!r}, fused {e_probe!r}, launches "
                           f"{f32_launches} {res_launches} {bf16_launches}")
    say(5, "(T) probe", tiles=NPROBE, launches=res_launches,
        ms_per_tile_f32=f"{pms_f32:.3f}", ms_per_tile_split=f"{pms_split:.3f}",
        ms_per_tile_bf16=f"{pms_bf16:.3f}",
        ms_per_tile_fused=f"{probe_ms:.3f} {probe_ms2:.3f}",
        e_f32=repr(e_f32), e_split=repr(e_split), e_bf16=repr(e_bf16),
        e_fused=repr(e_probe),
        rel_f32_vs_fused=f"{d_fused:.3e}", rtol=RTOL_TILE_FP32,
        rel_split_vs_f32=f"{d_split:.3e}", rtol_split=RTOL_SPLIT,
        rel_bf16_vs_f32=f"{abs(e_bf16 - e_f32) / abs(e_f32):.3e}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)),
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")

    # ---- phase 6: the (T) design probes ----------------------------------
    # (a) the probes' entry points at the JAX scripts' shapes, each raising
    # if its value is off its closed form; the counts are read just after
    for k in pv.launch_count:
        pv.launch_count[k] = 0
    sp.launch_count = 0
    r1 = pv.p1_dispatch(dev)
    r2 = pv.p2_smem(dev)["cap"]
    r3 = pv.p3_dots(dev)
    r4 = pv.p4_stream(dev)["fetch"]
    r5 = sp.main(dev)
    probe_launches = dict(pv.launch_count, slab=sp.launch_count)
    if not all(probe_launches.values()):
        raise RuntimeError(f"a probe kernel was not launched: "
                           f"{probe_launches}")
    if r2["cap"] != r2["optin"]:
        raise RuntimeError(f"smem cap {r2['cap']} != optin {r2['optin']}")
    say(6, "probe entry points ok", launches=json.dumps(probe_launches),
        smem_cap=r2["cap"], smem_optin=r2["optin"],
        smem_blocks_per_sm=r2["blocks_per_sm"],
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))

    # (b) each kernel against its plain version on seeded random inputs;
    # the times of the plain versions and the library calls come from the
    # probes' own timer (pv.cuda_ms), which keeps the host's launch gaps out
    # of the span, as the probes' kernel times do
    gen6 = torch.Generator(device=dev).manual_seed(6)

    def rand(*shape):
        return torch.rand(shape, generator=gen6, device=dev) * 2 - 1

    # the launch floor: the empty kernel's graph-replayed time of (a); every
    # probe's bound is the largest of its bytes, its operations and it
    floor = r1[str((pv.T,))]["ms_graph"]

    def probe_bound(nbyte, flops):
        b = bound_ms(nbyte, flops)
        return (floor, "launch") if floor > b[0] else b

    rec = {}
    x = rand(1, 1)
    for grid in ((pv.T,), (pv.T, pv.T)):
        if not torch.equal(pv.dispatch(x, grid), pv.dispatch_reference(x)):
            raise RuntimeError(f"dispatch grid={grid} differs from plain")
    g1 = r1[str((pv.T,))]
    rec["dispatch"] = dict(
        err=0.0, ms=g1["ms_graph"],
        plain_ms=pv.cuda_ms(lambda: pv.dispatch_reference(x), 64, dev),
        bound=probe_bound(2 * 4, {}), library=None)
    g2 = r1[str((pv.T, pv.T))]
    say(6, "p1 dispatch ok (exact)",
        ms_stream_graph_grid_T=f"{g1['ms']:.5f}/{g1['ms_graph']:.5f}",
        ms_stream_graph_grid_TxT=f"{g2['ms']:.5f}/{g2['ms_graph']:.5f}",
        plain_ms=f"{rec['dispatch']['plain_ms']:.5f}",
        bound_ms=f"{rec['dispatch']['bound'][0]:.5f}",
        bound_by=rec["dispatch"]["bound"][1])

    x = rand(8, pv.OO)
    if not torch.equal(pv.smem_copy(x, r2["cap"]), pv.smem_copy_reference(x)):
        raise RuntimeError("smem kernel differs from plain")
    rec["smem"] = dict(
        err=0.0, ms=r2["ms"],
        plain_ms=pv.cuda_ms(lambda: pv.smem_copy_reference(x), 20, dev),
        bound=probe_bound(4 * pv.OO + 4, {}), library=None)
    say(6, "p2 smem ok (exact)", cap_bytes=r2["cap"],
        ms=f"{r2['ms']:.5f}", plain_ms=f"{rec['smem']['plain_ms']:.5f}",
        bound_ms=f"{rec['smem']['bound'][0]:.5f}",
        bound_by=rec["smem"]["bound"][1])

    # p3: the kernel's times (r3) are on operands made beforehand, and so
    # are the library calls': bf16 for 'bf16', the K-tripled bf16 pair
    # [a_hi | a_hi | a_lo] (M x 3K) . [b_hi; b_lo; b_hi] (3K x N) for
    # 'split' (one matmul, fp32 accumulation), fp32 for 'f32'; the split
    # pass (or a's transpose in 'f32') is timed apart
    reps = pv.REPS * pv.T
    err3 = 0.0
    for (M, K, N, tag) in pv.p3_shapes():
        a, b = rand(M, K), rand(K, N)
        (ah, al), (bh, bl) = tr.hilo(a), tr.hilo(b)
        a3 = torch.cat([ah, ah, al], 1)
        b3 = torch.cat([bh, bl, bh], 0)
        lib_ms = {
            "f32": pv.cuda_ms(lambda: [a @ b for _ in range(reps)], 3, dev),
            "bf16": pv.cuda_ms(lambda: [ah @ bh for _ in range(reps)], 3,
                               dev),
            "split": pv.cuda_ms(lambda: [a3 @ b3 for _ in range(reps)], 3,
                                dev)}
        del a3, b3
        for mode in ("bf16", "split", "f32"):
            out, cs = pv.dots(a, b, mode, reps)
            ref, rcs = pv.dots_reference(a, b, mode, reps)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            torch.testing.assert_close(out, ref, rtol=RTOL_DOTS,
                                       atol=RTOL_DOTS * scale)
            torch.testing.assert_close(
                cs, rcs, rtol=RTOL_DOTS,
                atol=RTOL_DOTS * rcs.abs().max().item())
            err = (out - ref).abs().max().item()
            err3 = max(err3, err)
            fl = 2.0 * M * K * N * reps
            bnd = probe_bound((M * K + K * N + M * pv.OUT_COLS) * 4
                              + cs.numel() * 8,
                              {"fp32": fl} if mode == "f32" else
                              {"bf16": fl * (3 if mode == "split" else 1)})
            plain = pv.cuda_ms(
                lambda: pv.dots_reference(a, b, mode, reps), 3, dev)
            r = r3[f"{tag}/{mode}"]
            lib = lib_ms[mode]
            if tag == "A" and mode == "bf16":
                rec["dots"] = dict(err=err3, ms=r["ms"], plain_ms=plain,
                                   bound=bnd, library=lib)
            feed = {} if r["feed_ms"] is None else dict(
                copy_only_ms=f"{r['feed_ms']:.4f}",
                copy_only_tbs=f"{r['feed_rate']:.2f}")
            say(6, f"p3 dots {tag} {mode} ok", shape=f"({M}x{K})x({K}x{N})",
                reps=reps, abs_err=f"{err:.2e}", scale=f"{scale:.3e}",
                rtol=RTOL_DOTS, ms=f"{r['ms']:.4f}",
                tflops=f"{r['rate']:.1f}", library_ms=f"{lib:.4f}",
                bound_ms=f"{bnd[0]:.4f}", bound_by=bnd[1],
                split_pass_ms=f"{r['split_ms']:.4f}",
                gb_streamed=f"{r['bytes_read'] / 1e9:.3f}",
                l2_tbs=f"{r['l2_rate']:.2f}", **feed,
                plain_ms=f"{plain:.4f}")
    rec["dots"]["err"] = err3

    t2r, ovr = (rand(*x.shape) for x in pv.p4_inputs(dev, f32))
    v_k, part = pv.stream_sum(t2r, ovr)
    v_p, tot = pv.stream_sum_reference(t2r, ovr)
    torch.cuda.synchronize()
    err4 = abs(part.sum().item() - tot.sum().item())
    if not (err4 <= RTOL_FP64 * abs(tot.sum().item())
            and abs(v_k.item() - v_p.item()) <= 1e-6 * abs(v_p.item())):
        raise RuntimeError(f"stream: {part.sum().item()!r} vs "
                           f"{tot.sum().item()!r}, value {v_k.item()!r} vs "
                           f"{v_p.item()!r}")
    flush = torch.empty(pv.FLUSH_BYTES // 4, device=dev)
    cold = dict(before=lambda: flush.sum())
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    rec["stream"] = dict(
        err=err4, ms=r4["ms"],
        plain_ms=pv.cuda_ms(lambda: pv.stream_sum_reference(t2r, ovr), 10,
                            dev, **cold),
        bound=probe_bound(r4["bytes"] + 8 * 4 * nsm + 4, {}),
        library=pv.cuda_ms(lambda: t2r.sum() + ovr.sum(), 10, dev, **cold))
    del t2r, ovr
    say(6, "p4 stream ok", bytes=r4["bytes"], abs_err=f"{err4:.2e}",
        rtol=RTOL_FP64, ms_cold=f"{r4['ms']:.4f}",
        gbs_cold=f"{r4['rate']:.0f}", ms_warm=f"{r4['ms_warm']:.4f}",
        gbs_warm=f"{r4['rate_warm']:.0f}",
        bound_ms=f"{rec['stream']['bound'][0]:.4f}",
        plain_ms_cold=f"{rec['stream']['plain_ms']:.4f}",
        library_ms_cold=f"{rec['stream']['library']:.4f}")

    # the slab relayout: kernel and permute().contiguous(), cold (L2
    # flushed before each launch) and warm
    w = rand(sp.T, sp.o, sp.T, sp.o * sp.o)
    out = sp.relayout(w)
    w5 = w.view(sp.T, sp.o, sp.T, sp.o, sp.o)
    if not (torch.equal(out, sp.relayout_reference(w)) and torch.equal(
            sp.probe_value(out), w5[0, 0, 0, 0, 0] + w5[1, 1, 1, 1, 1])):
        raise RuntimeError("slab relayout differs from plain")

    def permute():
        return w5.permute(0, 2, 3, 1, 4).contiguous()

    rec["slab"] = dict(
        err=0.0, ms=r5["ms"],
        plain_ms=pv.cuda_ms(lambda: sp.relayout_reference(w), 20, dev,
                            **cold),
        bound=probe_bound(r5["bytes"], {}),
        library=pv.cuda_ms(permute, 20, dev, **cold))
    lib_warm = pv.cuda_ms(permute, 20, dev)
    # the floor of the cold timing: the empty kernel, timed as the slab is
    x = rand(1, 1)
    empty_cold = pv.cuda_ms(lambda: pv.dispatch(x, (pv.T,)), 20, dev, **cold)
    del w, out, w5, flush
    say(6, "slab relayout ok (bitwise)", bytes=r5["bytes"],
        ms_cold=f"{r5['ms']:.5f}", ms_warm=f"{r5['ms_warm']:.5f}",
        gbs_cold=f"{r5['rate']:.0f}",
        bound_ms=f"{rec['slab']['bound'][0]:.5f}",
        bound_by=rec["slab"]["bound"][1],
        share_of_bound_cold=f"{rec['slab']['bound'][0] / r5['ms']:.3f}",
        plain_ms_cold=f"{rec['slab']['plain_ms']:.5f}",
        library_ms_cold=f"{rec['slab']['library']:.5f}",
        library_ms_warm=f"{lib_warm:.5f}",
        empty_kernel_ms_cold=f"{empty_cold:.5f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))

    probe_src = "pyscf_mpcc_tpu_torch/ops/csrc/triples_probe.cu"
    probe_rows = [
        ("dispatch", probe_src, "tools/triples_probe_v6.py:53"),
        ("smem", probe_src, "tools/triples_probe_v6.py:79"),
        ("dots", probe_src, "tools/triples_probe_v6.py:123"),
        ("stream", probe_src, "tools/triples_probe_v6.py:154"),
        ("slab", "pyscf_mpcc_tpu_torch/ops/csrc/slab_relayout.cu",
         "tools/slab_loop_probe.py:39")]
    # the resident row: mode split, the mode that engine='auto' runs on
    # the resident kernel (dot_precision='high')
    rf = res["split"]
    print(json.dumps({"kernels": [{
        "name": "triples_combine", "route": "cuda",
        "source": "pyscf_mpcc_tpu_torch/ops/csrc/triples_combine.cu",
        "replaces": "pyscf_mpcc_tpu/ops/triples_combine.py:129",
        "launches": comb_launches, "max_abs_err": tile_err,
        "ms": ms_k, "plain_ms": ms_p, "bound_ms": comb_bound[0],
        "bound_by": comb_bound[1], "library_ms": None}, {
        "name": "triples_combine_chunk", "route": "cuda",
        "source": "pyscf_mpcc_tpu_torch/ops/csrc/triples_combine.cu",
        "replaces": "pyscf_mpcc_tpu/ops/triples_combine.py:561",
        "launches": c4_launches, "max_abs_err": chunk_err,
        "ms": chunk_ms, "plain_ms": chunk_plain_ms,
        "bound_ms": chunk_bound[0] / 4, "bound_by": chunk_bound[1],
        "library_ms": None}, {
        "name": "triples_resident", "route": "cuda",
        "source": "pyscf_mpcc_tpu_torch/ops/csrc/triples_resident.cu",
        "replaces": "pyscf_mpcc_tpu/ops/triples_resident.py:238",
        "launches": res_launches, "max_abs_err": rf["err"],
        "ms": rf["ms"], "plain_ms": rf["plain_ms"],
        "bound_ms": rf["bound"][0], "bound_by": rf["bound"][1],
        "library_ms": None}] + [{
        "name": f"probe_{name}", "route": "cuda", "source": src,
        "replaces": rep, "launches": probe_launches[name],
        "max_abs_err": rec[name]["err"], "ms": rec[name]["ms"],
        "plain_ms": rec[name]["plain_ms"], "bound_ms": rec[name]["bound"][0],
        "bound_by": rec[name]["bound"][1],
        "library_ms": rec[name]["library"]}
        for name, src, rep in probe_rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
