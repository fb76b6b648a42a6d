from pyscf_mpcc_tpu_torch.utils.profiling import (  # noqa: F401
    count, session, span, trace)
