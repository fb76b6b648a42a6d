"""Orbital localization (host NumPy): a copy of the JAX package's
``lo.pm``.  ``lo.avas`` is ROADMAP A15b, not ported yet."""

from pyscf_mpcc_tpu_torch.lo.pm import (  # noqa: F401
    PipekMezey, lowdin_populations, pm_localize)
