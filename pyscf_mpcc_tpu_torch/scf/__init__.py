from pyscf_mpcc_tpu_torch.scf.hf import RHF, ROHF, UHF  # noqa: F401
