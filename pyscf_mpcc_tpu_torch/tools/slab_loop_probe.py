"""Slab relayout of the resident (T) design on the card.

Port of the JAX package's ``tools/slab_loop_probe.py``.  There the Pallas
kernel checked that Mosaic could run the relayout of a W block as a rolled
loop; here the relayout

    out[a, b, j, i, k] = w[a, i, b, j*o + k],   w (T, o, T, o*o),
    out (T, T, o, o, o)

is the hand-written CUDA kernel ``ops/csrc/slab_relayout.cu`` (built for
sm_90a at first use), with ``relayout_reference`` (a permute) beside it;
``relayout`` runs the plain version only for CPU tensors, and for CUDA
tensors launches the kernel or raises.  The kernel is a row gather: output
row (a, b, j, i) is the contiguous input run w[a, i, b, j*o:(j+1)*o], moved
by o/4 lanes with 16-byte loads and stores, ``PIECES`` pieces in flight a
thread and ``THREADS * PIECES`` consecutive output pieces a block.

Usage: python -m pyscf_mpcc_tpu_torch.tools.slab_loop_probe
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.tools.triples_probe_v6 import (FLUSH_BYTES, _fmt,
                                                        cuda_ms)

o, T = 32, 8
# block of the kernel: threads, and 16-byte pieces a thread moves
# (slab_relayout_block in csrc/slab_relayout.cu, checked when it is loaded)
THREADS, PIECES = 256, 4

# kernel launches made by relayout (CUDA tensors only)
launch_count = 0


def relayout_reference(w):
    """Plain version: w (T, o, T, o*o) -> (T, T, o, o, o)."""
    nt, no = w.shape[0], w.shape[1]
    return w.view(nt, no, nt, no, no).permute(0, 2, 3, 1, 4).contiguous()


@functools.cache
def _lib():
    from pyscf_mpcc_tpu_torch.ops import _build
    lib = _build.load("slab_relayout")
    lib.slab_relayout.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.slab_relayout.restype = ctypes.c_int
    pint = ctypes.POINTER(ctypes.c_int)
    lib.slab_relayout_block.argtypes = [pint, pint]
    lib.slab_relayout_block.restype = ctypes.c_int
    threads, pieces = ctypes.c_int(0), ctypes.c_int(0)
    lib.slab_relayout_block(ctypes.byref(threads), ctypes.byref(pieces))
    if (threads.value, pieces.value) != (THREADS, PIECES):
        raise RuntimeError("slab kernel block differs from THREADS, PIECES")
    return lib


def relayout(w):
    """out[a, b, j, i, k] = w[a, i, b, j*o + k] by the CUDA kernel (a row
    gather; fp32, o a multiple of 4)."""
    global launch_count
    if w.device.type == "cpu":
        return relayout_reference(w)
    nt, no = w.shape[0], w.shape[1]
    if w.dtype != torch.float32 or not w.is_contiguous():
        raise TypeError("relayout takes a contiguous float32 tensor")
    if tuple(w.shape) != (nt, no, nt, no * no) or no % 4:
        raise ValueError(f"w must be (T, o, T, o*o) with o a multiple of 4, "
                         f"got {tuple(w.shape)}")
    out = torch.empty((nt, nt, no, no, no), dtype=w.dtype, device=w.device)
    err = _lib().slab_relayout(w.data_ptr(), out.data_ptr(), nt, no,
                               torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slab_relayout kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return out


def probe_value(out):
    """The JAX probe's scalar: out[0,0,0,0,0] + out[1,1,1,1,1]."""
    return out[0, 0, 0, 0, 0] + out[1, 1, 1, 1, 1]


def probe_input(dev, dtype):
    """The JAX probe's w: arange(T*o*T*o*o) * 1e-6, as (T, o, T, o*o)."""
    return torch.arange(T * o * T * o * o, dtype=dtype, device=dev).reshape(
        T, o, T, o * o) * 1e-6


def main(device=None):
    """Relayout the probe's w once, check the scalar, time the kernel cold
    (L2 flushed before each launch) and warm; returns {"value", "expect",
    "ms" (cold), "ms_warm", "rate", "unit", "bytes"} (no time off the
    card)."""
    dev, dtype = _dev.resolve(device)
    w = probe_input(dev, dtype)
    value = float(probe_value(relayout(w)))
    wv = w.reshape(T, o, T, o, o)
    expect = float(wv[0, 0, 0, 0, 0] + wv[1, 1, 1, 1, 1])
    if value != expect:
        raise RuntimeError(f"slab value {value!r}, expected {expect!r}")
    ms = ms_warm = None
    if dev.type == "cuda":
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                            device=dev)
        ms = cuda_ms(lambda: relayout(w), 20, dev,
                     before=lambda: flush.sum())
        ms_warm = cuda_ms(lambda: relayout(w), 20, dev)
        del flush
    nbyte = 2 * w.numel() * w.element_size()
    gbs = None if ms is None else nbyte / ms / 1e6
    print(f"OK value={value:.6f} ms={_fmt(ms, 5)} (cold), "
          f"{_fmt(ms_warm, 5)} (warm) GB/s={_fmt(gbs, 0)} (cold)", flush=True)
    print(f"expected={expect:.6f}", flush=True)
    return dict(value=value, expect=expect, ms=ms, ms_warm=ms_warm,
                rate=gbs, unit="GB/s (read + write, cold)", bytes=nbyte)


if __name__ == "__main__":
    main()
