"""Build a CUDA source of ``ops/csrc`` into a shared library and load it.

The library has a plain C interface and is bound with ctypes, so nvcc
compiles it in seconds (no PyTorch headers).  It is built at first use
into ``build/torch_kernels/`` at the root of the checkout, under a file
name keyed on a hash of the source, the headers of ``csrc``, the flags and
the compiler, so a stale build is never reused.  ``load_all`` builds
several sources at once, one nvcc process each.  The compiler writes to a temporary name
that is renamed into place, so parallel processes cannot race on it.
Nothing is printed unless the build fails, which raises with nvcc's
stderr.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_kernels")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_locks = {}
_libs = {}
# per source: {"seconds": build wall time (0.0 when reused), "path": ...,
# "log": nvcc's stderr, including the -Xptxas -v register report}
build_info = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load(name):
    """ctypes handle of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(_CSRC, name + ".cu")
        nvcc = _nvcc()
        h = hashlib.sha256()
        for path in [src] + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(FLAGS).encode())
        h.update(nvcc.encode())
        path = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
        t0 = time.perf_counter()
        log = ""
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run([nvcc, *FLAGS, "-o", tmp, src],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src} (rc={proc.returncode}):\n"
                        f"{proc.stderr}")
                log = proc.stderr
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(path)
        build_info[name] = dict(seconds=time.perf_counter() - t0, path=path,
                                log=log)
        _libs[name] = lib
        return lib


def load_all(names):
    """Build and load several sources, one nvcc process each, all started
    together; returns their handles in order."""
    with ThreadPoolExecutor(max(1, len(names))) as ex:
        return list(ex.map(load, names))
