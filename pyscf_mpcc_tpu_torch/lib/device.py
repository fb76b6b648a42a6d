"""Device and dtype policy of the port.

- CPU: float64 (the parity tests hold the port to the JAX package in fp64).
- CUDA: float32 by default, in true fp32: TF32 is switched off for matmuls
  and cuDNN and the float32 matmul precision is "highest".  A TF32 matmul
  carries about three decimal digits, the same class of error as a
  single-pass TPU dot (3.6e-7 Ha in E(T) at (H2O)8), so the flags are set
  and asserted rather than left at their defaults.  float64 on CUDA is the
  native fp64 path used to check pinned energies on the card.

Entry points run on the CUDA device unless the caller passes a CPU device:
``resolve(None)`` means ``torch.device("cuda")`` and raises when no card is
present.  There is no silent CPU fallback.
"""

from __future__ import annotations

import torch


def set_fp32_precision():
    """Switch TF32 off everywhere and assert that it is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("TF32 is still enabled; float32 results would "
                           "carry ~1e-3 relative matmul error")


def resolve(device, dtype=None):
    """(device, dtype) under the policy above: device None means CUDA;
    float64 on the CPU, float32 on CUDA unless dtype is given.  On CUDA
    the TF32 flags are set and asserted as a side effect."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device=torch.device('cpu') "
            "to run on the CPU")
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    if device.type == "cuda":
        set_fp32_precision()
    return device, dtype
