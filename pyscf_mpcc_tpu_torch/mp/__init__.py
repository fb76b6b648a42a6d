"""Closed-shell MP2: ``mp2`` (canonical, SCS split, DF, the non-canonical
iterative solver) and the DF-MP2 drivers with relaxed densities.

The open-shell and generalized MP2 modules and MP2-F12 (``ump2``,
``dfump2``, ``gmp2``, ``dfgmp2``, ``mp2f12``) are ROADMAP A10b, not ported
yet: asking this package for one raises NotImplementedError.
"""

from pyscf_mpcc_tpu_torch.mp import mp2  # noqa: F401
from pyscf_mpcc_tpu_torch.mp.dfmp2 import DFRMP2, SCSDFRMP2  # noqa: F401

_NOT_PORTED = ("ump2", "dfump2", "gmp2", "dfgmp2", "mp2f12", "GMP2")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"mp.{name} is ROADMAP A10b, not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
