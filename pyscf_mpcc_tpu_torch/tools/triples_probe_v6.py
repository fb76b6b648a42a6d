"""Micro-probes of the resident (T) design on the card.

Port of the JAX package's ``tools/triples_probe_v6.py``.  Each Pallas
kernel there is a hand-written CUDA kernel of ``ops/csrc/triples_probe.cu``
(built for sm_90a at first use, see ``ops/_build``), with a plain PyTorch
version beside it; the wrappers run the plain version only for CPU
tensors, and for CUDA tensors launch the kernel or raise.

  p1  launch cost: an empty kernel on grids (T,) and (T, T), 64 launches
      back to back on the current stream and the same 64 replayed from a
      CUDA graph (the JAX script chained them inside one jit)
  p2  shared-memory capacity: bisect the dynamic shared-memory bytes a
      block launches with, against cudaDevAttrMaxSharedMemoryPerBlockOptin
  p3  in-kernel dot rate at the design's shapes, (256,424)x(424,8192),
      (2048,424)x(424,1024) and (256,424)x(424,1024), 6 dots x T repeats,
      in modes 'bf16' (the JAX probe's DEFAULT precision), 'split' (bf16x3)
      on wgmma with the operands split into bf16 once a call, and 'f32'
      on FFMA; the split pass, and the kernel's copy-only form, timed apart
  p4  input fetch rate: one kernel reading all 62.5 MB of t2 and ov, cold
      (L2 flushed before each launch) and warm

Each ``pN_*`` takes ``device=None`` (CUDA unless the caller passes the
CPU), prints a line in the JAX script's form and returns
``{case: {"value", "expect", "ms", "rate", "unit", ...}}``; it raises if a
value differs from the probe's closed form.  On the CPU no time is
measured (``ms`` and ``rate`` are None).

Usage: python -m pyscf_mpcc_tpu_torch.tools.triples_probe_v6 [p1 p2 p3 p4]
"""

from __future__ import annotations

import ctypes
import functools
import sys
import time

import torch

from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.ops.triples_resident import (
    MMA_KC, MODES, hilo, ov_operand, t2_operand)

o, T, F, OO = 32, 8, 424, 1024
REPS = 6          # dots per grid step in p3 (the per-A perm set)
NCHAIN = 64       # chained launches in p1
# output tile (rows, columns) of a block of the dots kernel in each mode
# (probe_dots_geometry in csrc/triples_probe.cu, checked when it is used)
DOT_TILES = {"f32": (128, 128), "split": (128, 256), "bf16": (128, 256)}
CS_TILE = 128     # edge of a checksum tile (rows and columns)
OUT_COLS = 128    # columns of the p3 accumulator (the TPU kernel's w[:, :128])
FLUSH_BYTES = 128 * 2**20   # more than twice the 50 MB L2, for cold p4 runs
# cycles a second the timer's spin assumes: the H100's SM clock is at most
# 1.98 GHz, so the spin lasts at least as long as asked
SPIN_HZ = 2.0e9
# CUDA errors that mean "too much shared memory" in the p2 bisect:
# cudaErrorInvalidValue, cudaErrorLaunchOutOfResources
_TOO_LARGE = (1, 701)

# kernel launches made by the wrappers (CUDA tensors only)
launch_count = {"dispatch": 0, "smem": 0, "dots": 0, "stream": 0}


@functools.cache
def _lib():
    from pyscf_mpcc_tpu_torch.ops import _build
    lib = _build.load("triples_probe")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pint = ctypes.POINTER(ctypes.c_int)
    for name, args in (
            ("probe_dispatch", [p, p, i, i, p]),
            ("probe_smem", [p, i, i, p, p]),
            ("probe_smem_occupancy", [i, pint]),
            ("probe_smem_optin", [pint]),
            ("probe_dots_geometry", [i, pint]),
            ("probe_dots", [i, i, p, p, p, p, i, i, i, i, i, p, p, p]),
            ("probe_stream", [p, ll, p, ll, i, i, i, p, p, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _check_cuda(*xs):
    dev = xs[0].device
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, not {x.dtype}")
        if x.device != dev:
            raise ValueError(f"tensors on {x.device} and {dev}")
        if not x.is_contiguous():
            raise ValueError("non-contiguous input")


# --------------------------------------------------------------------------
# p1: dispatch
# --------------------------------------------------------------------------

def dispatch_reference(x):
    """Plain version of the empty kernel: x[0, 0], as (1, 1)."""
    return x[:1, :1].clone()


def dispatch(x, grid, out=None):
    """Launch the empty kernel on ``grid`` (one or two dims); block 0
    writes out[0, 0] = x[0, 0].  Returns out ((1, 1), allocated if None)."""
    if x.device.type == "cpu":
        ref = dispatch_reference(x)
        return ref if out is None else out.copy_(ref)
    if out is None:
        out = torch.empty((1, 1), dtype=x.dtype, device=x.device)
    _check_cuda(x, out)
    gx, gy = (tuple(grid) + (1,))[:2]
    _raise(_lib().probe_dispatch(x.data_ptr(), out.data_ptr(), gx, gy,
                                 _stream(x.device)), "dispatch")
    launch_count["dispatch"] += 1
    return out


# --------------------------------------------------------------------------
# p2: shared-memory capacity
# --------------------------------------------------------------------------

def smem_copy_reference(x):
    """Plain version of the shared-memory kernel: x[0, 0], as (1,)."""
    return x[0, :1].clone()


def _smem_try(x, nbytes, out):
    """Launch the kernel with nbytes of dynamic shared memory: True if it
    launched, False if the card refused the size; other errors raise."""
    n = min(x.shape[1], nbytes // 4)
    err = _lib().probe_smem(x.data_ptr(), n, nbytes, out.data_ptr(),
                            _stream(x.device))
    if err == 0:
        launch_count["smem"] += 1
        return True
    if err in _TOO_LARGE:
        return False
    _raise(err, "smem")


def smem_copy(x, nbytes):
    """Copy row 0 of x into nbytes of dynamic shared memory and return
    scr[0] as (1,); raises if the card refuses the size."""
    if x.device.type == "cpu":
        return smem_copy_reference(x)
    _check_cuda(x)
    out = torch.empty(1, dtype=x.dtype, device=x.device)
    if not _smem_try(x, nbytes, out):
        raise RuntimeError(f"{nbytes} bytes of dynamic shared memory refused")
    return out


def smem_cap(x):
    """Largest dynamic shared-memory size (bytes) the kernel launches with,
    by bisection in [4 KiB, 1 MiB), and the kernel's output at that size."""
    _check_cuda(x)
    lo, hi = 4096, 2**20
    out = torch.empty(1, dtype=x.dtype, device=x.device)
    if not _smem_try(x, lo, out) or _smem_try(x, hi, out):
        raise RuntimeError(f"the cap is not in [{lo}, {hi})")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _smem_try(x, mid, out):
            lo = mid
        else:
            hi = mid
    _smem_try(x, lo, out)
    return lo, out


def smem_limits(nbytes):
    """(cudaDevAttrMaxSharedMemoryPerBlockOptin of the current device,
    blocks of the kernel an SM holds at nbytes)."""
    lib = _lib()
    optin, blocks = ctypes.c_int(0), ctypes.c_int(0)
    _raise(lib.probe_smem_optin(ctypes.byref(optin)), "smem optin")
    _raise(lib.probe_smem_occupancy(nbytes, ctypes.byref(blocks)),
           "smem occupancy")
    return optin.value, blocks.value


# --------------------------------------------------------------------------
# p3: dots
# --------------------------------------------------------------------------

def _dot(a, b, mode):
    """a @ b in the precision mode, in the operands' dtype."""
    if mode == "f32":
        return a @ b
    ah, al = (x.to(a.dtype) for x in hilo(a))
    bh, bl = (x.to(b.dtype) for x in hilo(b))
    if mode == "bf16":
        return ah @ bh
    return ah @ bh + ah @ bl + al @ bh


def dots_reference(a, b, mode, reps):
    """Plain version of the dots kernel: (out, checksum).

    out (M, 128): the first 128 columns of a @ b summed over reps, in the
    dtype; checksum (ceil(M/128), ceil(N/128)) fp64: the sum of each
    128 x 128 output tile, times reps."""
    _check_mode(mode)
    w = _dot(a, b, mode)
    r = torch.zeros_like(w[:, :OUT_COLS])
    for _ in range(reps):
        r = r + w[:, :OUT_COLS]
    M, N = w.shape
    mt, nt = -(-M // CS_TILE), -(-N // CS_TILE)
    wp = torch.nn.functional.pad(w.double(), (0, nt * CS_TILE - N,
                                              0, mt * CS_TILE - M))
    cs = wp.reshape(mt, CS_TILE, nt, CS_TILE).sum((1, 3)) * reps
    return r, cs


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; use 'f32', 'split' or "
                         "'bf16'")


def dots_grid(M, N, mode, reps, slots):
    """(ntile, nsplit) of the dots kernel: its output tiles
    (``DOT_TILES[mode]``) and the repeat groups.  Where the tiles are fewer
    than ``slots``, the blocks the card holds at once, the repeats are split
    over nsplit groups (at most reps), so that ntile * nsplit blocks fill
    the card; block x takes tile x % ntile (row tile tile % (M/bm), column
    tile tile // (M/bm)) and group g = x // ntile, the repeats
    [g reps // nsplit, (g + 1) reps // nsplit)."""
    bm, bn = DOT_TILES[mode]
    ntile = (M // bm) * -(-N // bn)
    return ntile, max(1, min(reps, slots // ntile))


def dots_operands(a, b, mode):
    """The dots kernel's operands, made once a call from a (M, K) and b
    (K, N): 'f32' (a^T, b) in the dtype; 'split' ((a_hi, a_lo),
    (b_hi, b_lo)) and 'bf16' (a_hi, b_hi), split into bf16 and tiled in
    the order of the kernel's stages, a K-major by ``ov_operand`` and b
    MN-major by ``t2_operand`` (K zero-padded to a multiple of
    ``MMA_KC[mode]``; ``ov_dense``, ``t2_dense`` give them back)."""
    _check_mode(mode)
    if mode == "f32":
        return a.t().contiguous(), b.contiguous()
    return ov_operand(a, mode), t2_operand(b[None], mode)


def _parts(x):
    return x if isinstance(x, tuple) else (x, None)


@functools.cache
def _geometry(mode):
    """(rows, columns, stage k depth, blocks an SM holds) of the kernel."""
    g = (ctypes.c_int * 4)()
    _raise(_lib().probe_dots_geometry(MODES[mode], g), "dots geometry")
    if (tuple(g[:2]) != DOT_TILES[mode]
            or (mode != "f32" and g[2] != MMA_KC[mode])):
        raise RuntimeError(f"dots kernel geometry {tuple(g)} differs from "
                           f"DOT_TILES / MMA_KC ({mode})")
    return tuple(g)


def _check_ops(ah, al, bh, bl, M, kk, N, mode):
    """Raise unless the parts are what the kernel takes in the mode."""
    if mode == "f32":
        shapes, dtype = [(kk, M), (kk, N)], torch.float32
    else:
        kc = MMA_KC[mode]
        shapes = [(kk // kc, M // 8, kc // 8, 8, 8),
                  (1, kk // kc, N // 8, kc // 8, 8, 8)]
        dtype = torch.bfloat16
    if (al is None) != (mode != "split") or (bl is None) != (al is None):
        raise ValueError(f"mode {mode!r} takes lo parts only in 'split'")
    for x, shape in ((ah, shapes[0]), (al, shapes[0]), (bh, shapes[1]),
                     (bl, shapes[1])):
        if x is None:
            continue
        if x.device != ah.device or x.device.type != "cuda":
            raise ValueError(f"dots operands on {x.device} and {ah.device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"dots operand {x.dtype} {tuple(x.shape)}, "
                             f"the kernel takes {dtype} {shape} ({mode})")
        if not x.is_contiguous():
            raise ValueError("non-contiguous dots operand")


def dots_run(ops, M, K, N, mode, reps, feed=False):
    """The dots kernel on operands of ``dots_operands`` (CUDA): returns
    (out, checksum) as dots_reference does, the groups' partials summed
    over the group axis by one reduction (no atomics, deterministic).
    feed (modes 'split' and 'bf16'): the kernel's copy-only form, which
    streams the stages and multiplies nothing; returns None."""
    (ah, al), (bh, bl) = (_parts(x) for x in ops)
    dev = ah.device
    kk = K if mode == "f32" else ah.shape[0] * MMA_KC[mode]
    _check_ops(ah, al, bh, bl, M, kk, N, mode)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    _, nsplit = dots_grid(M, N, mode, reps, nsm * _geometry(mode)[3])
    outp = torch.empty((nsplit, M, OUT_COLS), dtype=torch.float32,
                       device=dev)
    csp = torch.empty((nsplit, M // CS_TILE, N // CS_TILE),
                      dtype=torch.float64, device=dev)
    _raise(_lib().probe_dots(
        MODES[mode], int(feed), ah.data_ptr(), 0 if al is None else
        al.data_ptr(), bh.data_ptr(), 0 if bl is None else bl.data_ptr(),
        M, kk, N, reps, nsplit, outp.data_ptr(), csp.data_ptr(),
        _stream(dev)), "dots")
    launch_count["dots"] += 1
    if feed:
        return None
    return outp.sum(0), csp.sum(0)


def dots(a, b, mode, reps):
    """The dots kernel: a @ b recomputed reps times; returns (out,
    checksum) as dots_reference does.  The kernel takes fp32, M and N
    multiples of 128, K a multiple of 4 and reps >= 1; the operands are
    made once a call (``dots_operands``)."""
    _check_mode(mode)
    if a.device.type == "cpu":
        return dots_reference(a, b, mode, reps)
    _check_cuda(a, b)
    (M, K), (K2, N) = a.shape, b.shape
    if K2 != K or M % CS_TILE or N % CS_TILE or K % 4 or N < OUT_COLS:
        raise ValueError(f"dots takes M, N multiples of {CS_TILE} and K of "
                         f"4, got ({M}x{K})x({K2}x{N})")
    if reps < 1:
        raise ValueError(f"dots takes reps >= 1, got {reps}")
    return dots_run(dots_operands(a, b, mode), M, K, N, mode, reps)


def dots_bytes(M, K, N, reps, mode):
    """Bytes the dots kernel streams per call: every block reads its a rows
    and b columns through the k-loop once per repeat, in the operand form
    of the mode (fp32; bf16, hi and lo in 'split', K padded to the
    stage's k depth)."""
    bm, bn = DOT_TILES[mode]
    ntile = -(-M // bm) * -(-N // bn)
    if mode == "f32":
        return reps * ntile * (bm + bn) * K * 4
    kp = -(-K // MMA_KC[mode]) * MMA_KC[mode]
    nbyte = 2 * (2 if mode == "split" else 1)
    return reps * ntile * (bm + bn) * kp * nbyte


# --------------------------------------------------------------------------
# p4: stream
# --------------------------------------------------------------------------

def stream_sum_reference(t2, ov):
    """Plain version of the stream kernel: (value, partial).

    value: sum(t2 row 0) + sum(ov row 0), each summed in fp64 and rounded
    to the dtype; partial (1,) fp64: the sum of every element of both."""
    def row(x):
        return x.reshape(-1)[:x.shape[-1]].sum(dtype=torch.float64).to(
            x.dtype)
    total = t2.sum(dtype=torch.float64) + ov.sum(dtype=torch.float64)
    return row(t2) + row(ov), total.reshape(1)


def stream_sum(t2, ov):
    """The stream kernel: reads every element of t2 and ov once; returns
    (value, partial) with one fp64 partial per streaming block, four
    blocks per SM (their sum is stream_sum_reference's)."""
    if t2.device.type == "cpu":
        return stream_sum_reference(t2, ov)
    _check_cuda(t2, ov)
    if t2.numel() % 4 or ov.numel() % 4:
        raise ValueError("stream takes sizes that are multiples of 4")
    nblocks = 4 * torch.cuda.get_device_properties(
        t2.device).multi_processor_count
    partial = torch.empty(nblocks, dtype=torch.float64, device=t2.device)
    value = torch.empty((), dtype=torch.float32, device=t2.device)
    _raise(_lib().probe_stream(t2.data_ptr(), t2.numel(), ov.data_ptr(),
                               ov.numel(), t2.shape[-1], ov.shape[-1],
                               nblocks, partial.data_ptr(), value.data_ptr(),
                               _stream(t2.device)), "stream")
    launch_count["stream"] += 1
    return value, partial


# --------------------------------------------------------------------------
# the probes
# --------------------------------------------------------------------------

def cuda_ms(fn, n, dev, before=None, hide_host=True):
    """Mean device milliseconds of fn over n calls after one warm-up, from
    CUDA events; None off the card (no device time is measured there).

    before(), if given, runs ahead of each call outside the timed span,
    right before it (after the spin kernel), so that the card does not
    idle between the two.
    hide_host: a spin kernel ahead of the first event keeps the card busy
    while the host enqueues the calls, so that the span holds the device's
    work and not the host's gaps between launches (a launch through a
    Python wrapper costs tens of microseconds of host time, more than
    many of these kernels take); False times what the host lets through."""
    if dev.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(dev)
    h0 = time.perf_counter()
    fn()
    host = time.perf_counter() - h0
    torch.cuda.synchronize(dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)

    def spin(calls):
        if hide_host:
            torch.cuda._sleep(int((2 * calls * host + 1e-4) * SPIN_HZ))

    if before is None:
        spin(n)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize(dev)
        return t0.elapsed_time(t1) / n
    tot = 0.0
    for _ in range(n):
        spin(1)
        before()
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize(dev)
        tot += t0.elapsed_time(t1)
    return tot / n


def _fmt(x, nd=3):
    return "not measured" if x is None else f"{x:.{nd}f}"


def _expect(tag, value, expect):
    if value != expect:
        raise RuntimeError(f"{tag}: value {value!r}, expected {expect!r}")


def p1_dispatch(device=None):
    """Empty kernel, grid (T,) then (T, T); NCHAIN launches chained."""
    dev, dtype = _dev.resolve(device)
    x = torch.ones((1, 1), dtype=dtype, device=dev)
    res = {}
    for grid in [(T,), (T, T)]:
        bufs = [torch.empty_like(x), torch.empty_like(x)]

        def chain(grid=grid, bufs=bufs):
            y = x
            for n in range(NCHAIN):
                y = dispatch(y, grid, out=bufs[n % 2])
            return y

        value = float(chain()[0, 0])
        _expect(f"P1 grid={grid}", value, 1.0)
        # on the stream as the port launches today: the host's cost shows
        ms = cuda_ms(chain, 5, dev, hide_host=False)
        ms = None if ms is None else ms / NCHAIN
        ms_graph = None
        if dev.type == "cuda":
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                yg = chain()
            ms_graph = cuda_ms(g.replay, 20, dev) / NCHAIN
            _expect(f"P1 graph grid={grid}", float(yg[0, 0]), 1.0)
        res[str(grid)] = dict(
            value=value, expect=1.0, ms=ms, ms_graph=ms_graph,
            rate=None if ms_graph is None else 1e3 / ms_graph,
            unit="launches/s (graph)")
        print(f"P1 dispatch grid={grid}: {_fmt(ms, 4)} ms/call on the "
              f"stream, {_fmt(ms_graph, 4)} ms/call from a graph",
              flush=True)
    return res


def p2_smem(device=None):
    """Bisect the largest dynamic shared memory a block launches with."""
    dev, dtype = _dev.resolve(device)
    x = torch.ones((8, OO), dtype=dtype, device=dev)
    if dev.type == "cpu":
        value = float(smem_copy(x, 4 * OO)[0])
        _expect("P2", value, 1.0)
        print("P2 smem cap: not measured (the plain version has no cap)",
              flush=True)
        return {"cap": dict(value=value, expect=1.0, ms=None, rate=None,
                            unit=None, cap=None, optin=None,
                            blocks_per_sm=None)}
    cap, out = smem_cap(x)
    value = float(out[0])
    _expect("P2", value, 1.0)
    optin, blocks = smem_limits(cap)
    _expect("P2 cap against the optin attribute", cap, optin)
    ms = cuda_ms(lambda: smem_copy(x, cap), 20, dev)
    print(f"P2 smem cap: {cap} bytes ({cap / 1024:.1f} KiB), optin "
          f"attribute {optin}, {blocks} block(s)/SM, {_fmt(ms, 4)} ms/launch",
          flush=True)
    return {"cap": dict(value=value, expect=1.0, ms=ms, rate=None,
                        unit=None, cap=cap, optin=optin,
                        blocks_per_sm=blocks)}


def p3_shapes():
    """(M, K, N, tag) of the three dot shapes."""
    # shape A: (T*o, F) x (F, T*OO)  [cases x/y==a at fixed A]
    # shape B: (T*T*o, F) x (F, OO)  [case z==a]
    return [(T * o, F, T * OO, "A"), (T * T * o, F, OO, "B"),
            (T * o, F, OO, "A1")]


def p3_dots(device=None):
    """In-kernel dot rates at the design's shapes, 6 dots x T repeats, in
    each mode.  ``ms`` is the kernel on operands made beforehand (the
    split into bf16, or the transpose of a in 'f32', is timed apart as
    ``split_ms``); in 'split' and 'bf16' ``feed_ms`` times the kernel's
    copy-only form, and ``l2_rate`` is the bytes it streams over ``ms``."""
    dev, dtype = _dev.resolve(device)
    reps = REPS * T
    res = {}
    for (M, K, N, tag) in p3_shapes():
        a = torch.ones((M, K), dtype=dtype, device=dev)
        b = torch.ones((K, N), dtype=dtype, device=dev)
        for mode in MODES:
            out, cs = dots(a, b, mode, reps)
            value = float(out[0, 0])
            _expect(f"P3 {tag} {mode}", value, float(reps * K))
            _expect(f"P3 {tag} {mode} checksum", float(cs.sum()),
                    float(reps * M * K * N))
            fl = 2.0 * M * K * N * reps
            nread = dots_bytes(M, K, N, reps, mode)
            ms = split_ms = feed_ms = None
            if dev.type == "cuda":
                ops = dots_operands(a, b, mode)
                ms = cuda_ms(lambda: dots_run(ops, M, K, N, mode, reps), 10,
                             dev)
                split_ms = cuda_ms(lambda: dots_operands(a, b, mode), 10,
                                   dev)
                if mode != "f32":
                    feed_ms = cuda_ms(lambda: dots_run(
                        ops, M, K, N, mode, reps, feed=True), 10, dev)
                del ops
            tf = None if ms is None else fl / ms / 1e9
            l2 = None if ms is None else nread / ms / 1e9
            feed = None if feed_ms is None else nread / feed_ms / 1e9
            res[f"{tag}/{mode}"] = dict(
                value=value, expect=float(reps * K), ms=ms, rate=tf,
                unit="TFLOP/s", flops=fl, bytes_read=nread,
                bytes_unique=(M * K + K * N) * a.element_size(),
                split_ms=split_ms, feed_ms=feed_ms, l2_rate=l2,
                feed_rate=feed)
            print(f"P3 dot {tag} ({M}x{K})x({K}x{N}) x{REPS} x{T} [{mode}]: "
                  f"{_fmt(ms, 4)} ms = {_fmt(tf, 1)} TFLOP/s, "
                  f"{nread / 1e9:.2f} GB streamed = {_fmt(l2, 2)} TB/s; "
                  f"split pass {_fmt(split_ms, 4)} ms; copy-only "
                  f"{_fmt(feed_ms, 4)} ms = {_fmt(feed, 2)} TB/s", flush=True)
    return res


def p4_inputs(dev, dtype):
    """The p4 arrays, ones: t2 (3, T, F, OO) and ov (6, T, T, o, F)."""
    return (torch.ones((3, T, F, OO), dtype=dtype, device=dev),
            torch.ones((6, T, T, o, F), dtype=dtype, device=dev))


def p4_stream(device=None):
    """One launch reading all of t2 and ov (62.5 MB), cold and warm."""
    dev, dtype = _dev.resolve(device)
    t2, ov = p4_inputs(dev, dtype)
    value, partial = stream_sum(t2, ov)
    _expect("P4", float(value), float(OO + F))
    _expect("P4 total", float(partial.sum()), float(t2.numel() + ov.numel()))
    nbyte = (t2.numel() + ov.numel()) * t2.element_size()
    ms = ms_warm = None
    if dev.type == "cuda":
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                            device=dev)
        ms = cuda_ms(lambda: stream_sum(t2, ov), 10, dev,
                     before=lambda: flush.sum())
        ms_warm = cuda_ms(lambda: stream_sum(t2, ov), 20, dev)
        del flush
    gbs = None if ms is None else nbyte / ms / 1e6
    gbs_warm = None if ms_warm is None else nbyte / ms_warm / 1e6
    print(f"P4 resident fetch {nbyte / 2**20:.0f} MB: cold {_fmt(ms, 4)} ms "
          f"= {_fmt(gbs, 0)} GB/s, warm {_fmt(ms_warm, 4)} ms = "
          f"{_fmt(gbs_warm, 0)} GB/s", flush=True)
    return {"fetch": dict(value=float(value), expect=float(OO + F), ms=ms,
                          rate=gbs, unit="GB/s (cold)", ms_warm=ms_warm,
                          rate_warm=gbs_warm, bytes=nbyte)}


PROBES = {"p1": p1_dispatch, "p2": p2_smem, "p3": p3_dots, "p4": p4_stream}


def main(argv):
    which = argv or list(PROBES)
    dev, _ = _dev.resolve(None)
    print(f"device={torch.cuda.get_device_name(dev)}", flush=True)
    return {w: PROBES[w](dev) for w in which}


if __name__ == "__main__":
    main(sys.argv[1:])
