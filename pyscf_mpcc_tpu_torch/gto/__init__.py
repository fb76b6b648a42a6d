from pyscf_mpcc_tpu_torch.gto.mole import M, Mole
from pyscf_mpcc_tpu_torch.gto import basis, intor
from pyscf_mpcc_tpu_torch.gto.intor import (
    intor_ovlp, intor_kin, intor_nuc, intor_ovlp_kin,
    intor_eri, intor_3c2e, intor_2c2e,
)
