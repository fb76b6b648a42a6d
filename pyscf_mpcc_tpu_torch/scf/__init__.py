from pyscf_mpcc_tpu_torch.scf.hf import RHF, ROHF, UHF, convert_to_uhf  # noqa: F401
