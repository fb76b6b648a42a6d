"""Global configuration with environment and config-file overrides.

TPU-native analog of the reference's ``pyscf/__config__.py:22-32`` pattern:
module-level defaults, overridable (in priority order) by

  1. ``PYSCF_MPCC_TPU_<NAME>`` environment variables,
  2. a user config file (``$PYSCF_MPCC_TPU_CONFIG_FILE``, else
     ``./.pyscf_mpcc_tpu_conf.py``, else ``~/.pyscf_mpcc_tpu_conf.py``)
     executed in this module's namespace,
  3. the hard-coded defaults below.

Consumers read values via :func:`getattr_cfg` (mirroring the reference's
``getattr(__config__, 'name', default)`` idiom) so a method-local default
is always available even for keys not declared here.
"""

from __future__ import annotations

import os

# ---------------------------------------------------------------- defaults
DEBUG = False
VERBOSE = 3                     # default logger level (lib.logger NOTE)
UNIT = "angstrom"

# device-memory budget in MB for the memory governor (lib/memory.py);
# 0 = query the CUDA device at runtime (torch.cuda.mem_get_info); a CPU
# device has nothing to query and needs this set or an explicit budget.
MAX_MEMORY = 0

# default matmul precision class for fp32 device runs: 'default' (1-pass
# bf16), 'high' (3-pass bf16 — near-fp32 accuracy at ~3x the speed of
# 'highest' on the MXU), 'highest' (full fp32). Production correlation
# drivers use 'high' unless overridden.
MATMUL_PRECISION = "high"

# CCSD(T) tile edge (0 = let the memory governor choose)
CCSD_T_TILE = 0
# DF vvvv-ladder tile count (0 = memory governor)
CCSD_LADDER_NTILE = 0

# persistent XLA compilation cache directory (lib/compile_cache.py):
# compiled executables are serialized here so repeat processes start
# warm (PES scanners, fragment loops, preemption restarts, small jobs).
# "" disables.  Enabled lazily by the correlation drivers.
COMPILATION_CACHE_DIR = os.path.join(
    os.environ.get("HOME", "."), ".cache", "pyscf_mpcc_tpu", "xla")

# basis library search path (gto/basis.py also honors this)
BASIS_PATH = os.environ.get("PYSCF_MPCC_TPU_BASIS_PATH", "")

# scf / cc convergence defaults (reference __config__ exposes the same
# family of knobs, e.g. scf_hf_SCF_conv_tol)
SCF_CONV_TOL = 1e-10
CC_CONV_TOL = 1e-8
CC_CONV_TOL_NORMT = 1e-6

# ------------------------------------------------------- file override (2)
_conf_file = None
for _cand in (os.environ.get("PYSCF_MPCC_TPU_CONFIG_FILE"),
              os.path.join(os.path.abspath("."), ".pyscf_mpcc_tpu_conf.py"),
              os.path.join(os.environ.get("HOME", "."),
                           ".pyscf_mpcc_tpu_conf.py")):
    if _cand and os.path.isfile(_cand):
        _conf_file = _cand
        break
if _conf_file:
    with open(_conf_file) as _f:
        exec(_f.read())

# -------------------------------------------------------- env override (1)
def _coerce(cur, raw):
    if isinstance(cur, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(cur, int):
        return int(raw)
    if isinstance(cur, float):
        return float(raw)
    return raw


for _name, _val in list(globals().items()):
    if _name.isupper():
        _raw = os.environ.get("PYSCF_MPCC_TPU_" + _name)
        if _raw is not None:
            globals()[_name] = _coerce(_val, _raw)


def getattr_cfg(name, default=None):
    """Config lookup with a caller-side default (reference getattr idiom)."""
    import sys
    return getattr(sys.modules[__name__], name, default)
