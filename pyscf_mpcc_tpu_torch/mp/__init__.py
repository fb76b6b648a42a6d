"""MP2: ``mp2`` (canonical, SCS split, DF, the non-canonical iterative
solver), ``ump2`` (its unrestricted counterpart), and the DF-MP2 drivers
with relaxed densities (``DFRMP2``, ``SCSDFRMP2``, ``dfump2.DFUMP2``).

The generalized MP2 modules and MP2-F12 (``gmp2``, ``dfgmp2``,
``mp2f12``) are ROADMAP A10b, not ported yet: asking this package for one
raises NotImplementedError.
"""

from pyscf_mpcc_tpu_torch.mp import dfump2, mp2, ump2  # noqa: F401
from pyscf_mpcc_tpu_torch.mp.dfmp2 import DFRMP2, SCSDFRMP2  # noqa: F401
from pyscf_mpcc_tpu_torch.mp.dfump2 import DFUMP2  # noqa: F401

_NOT_PORTED = ("gmp2", "dfgmp2", "mp2f12", "GMP2")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"mp.{name} is ROADMAP A10b, not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
