from pyscf_mpcc_tpu_torch.ao2mo.incore import full, general  # noqa: F401
