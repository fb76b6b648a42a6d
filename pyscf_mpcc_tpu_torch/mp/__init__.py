"""MP2: ``mp2`` (canonical, SCS split, DF, the non-canonical iterative
solver), ``ump2`` (its unrestricted counterpart), the DF-MP2 drivers with
relaxed densities (``DFRMP2``, ``SCSDFRMP2``, ``dfump2.DFUMP2``), the
generalized (spin-orbital) MP2 (``gmp2.GMP2``, ``dfgmp2.DFGMP2``) and
MP2-F12 (``mp2f12``, host NumPy over the native integral engine).
"""

from pyscf_mpcc_tpu_torch.mp import (dfgmp2, dfump2, gmp2, mp2,  # noqa: F401
                                     mp2f12, ump2)
from pyscf_mpcc_tpu_torch.mp.dfmp2 import DFRMP2, SCSDFRMP2  # noqa: F401
from pyscf_mpcc_tpu_torch.mp.dfump2 import DFUMP2  # noqa: F401
from pyscf_mpcc_tpu_torch.mp.gmp2 import GMP2  # noqa: F401
