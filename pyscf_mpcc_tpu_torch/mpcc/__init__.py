"""MP-CC: the block masks, the masked CCSD solvers (``rmpccsd``,
``umpccsd``), the OO-MP2 bath updates (``oomp2``), the DF screened-CC2
low-level solver (``lowlevel``), the fragmented workflows and the
``MPCC(mf)`` facade."""

from pyscf_mpcc_tpu_torch.mpcc import (  # noqa: F401
    lowlevel, masks, oomp2, rmpccsd, umpccsd, workflow)
from pyscf_mpcc_tpu_torch.mpcc.facade import MPCC  # noqa: F401
