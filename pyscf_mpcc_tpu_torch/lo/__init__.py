"""Orbital localization and active-space selection (host NumPy): copies
of the JAX package's ``lo.pm`` and ``lo.avas``."""

from pyscf_mpcc_tpu_torch.lo.avas import avas  # noqa: F401
from pyscf_mpcc_tpu_torch.lo.pm import (  # noqa: F401
    PipekMezey, lowdin_populations, pm_localize)
