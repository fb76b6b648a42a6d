from pyscf_mpcc_tpu_torch.scf.ghf import GHF, convert_to_ghf  # noqa: F401
from pyscf_mpcc_tpu_torch.scf.hf import RHF, ROHF, UHF, convert_to_uhf  # noqa: F401
