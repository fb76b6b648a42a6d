"""Restricted MP-CC: the block masks, the masked CCSD solver (``rmpccsd``),
the DF screened-CC2 low-level solver (``lowlevel``), the fragmented
workflow and the ``MPCC(mf)`` facade.

The open-shell modules (``umpccsd``, ``oomp2``) are ROADMAP A15b: asking
this package for one raises NotImplementedError.
"""

from pyscf_mpcc_tpu_torch.mpcc import (  # noqa: F401
    lowlevel, masks, rmpccsd, workflow)
from pyscf_mpcc_tpu_torch.mpcc.facade import MPCC  # noqa: F401

_NOT_PORTED = ("umpccsd", "oomp2")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"mpcc.{name} is ROADMAP A15b, not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
