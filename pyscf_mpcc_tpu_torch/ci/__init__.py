from pyscf_mpcc_tpu_torch.ci import fci_slow  # noqa: F401
