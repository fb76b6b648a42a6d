"""Runnable examples of the port (``python -m pyscf_mpcc_tpu_torch.examples.<name>``)."""
