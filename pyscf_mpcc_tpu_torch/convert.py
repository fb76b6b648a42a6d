"""State carried across from the JAX package, as numpy arrays.

The parity tests build a state once in the JAX package, turn it into numpy
and hand the same arrays to both packages:

    fields = {k: None if v is None else np.asarray(v)
              for k, v in jax_eris._asdict().items()}
    eris = eris_from_numpy(fields, device, dtype)

and ``ueris_from_numpy`` does the same for the unrestricted container,
``geris_from_numpy`` for the spin-orbital one (the nine antisymmetrized
blocks and the spinor Fock of cc/gccsd.GERIs).
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.cc.eris import RERIs
from pyscf_mpcc_tpu_torch.cc.uccsd import UERIs
from pyscf_mpcc_tpu_torch.lib import device as _dev


def _tensor(x, device, dtype):
    return torch.tensor(np.asarray(x), device=device, dtype=dtype)


def eris_from_numpy(fields, device, dtype=None):
    """The port's RERIs from ``{name: np.ndarray | None}``.

    Unknown field names raise.  A streamed container (stream_vv) gives
    ``Lvv_stream`` as the (naux, nvir, nvir) host array of the JAX
    package's store (``hoststore.get(handle)``); it becomes a
    lib/hoststore.HostStore on ``device``."""
    from pyscf_mpcc_tpu_torch.lib.hoststore import HostStore
    device, dtype = _dev.resolve(device, dtype)
    unknown = set(fields) - set(RERIs._fields)
    if unknown:
        raise ValueError(f"unknown RERIs fields {sorted(unknown)}")
    out = {k: (None if fields.get(k) is None
               else _tensor(fields[k], device, dtype))
           for k in RERIs._fields if k != "Lvv_stream"}
    lvv = fields.get("Lvv_stream")
    if lvv is not None:
        out["Lvv_stream"] = HostStore.from_tensor(np.asarray(lvv), device,
                                                  dtype)
    return RERIs(**out)


def ueris_from_numpy(fields, device, dtype=None):
    """The port's UERIs from ``{name: np.ndarray | int | None}`` (the
    JAX package's UERIs fields as numpy arrays; nocca/noccb as ints).
    Unknown field names raise."""
    device, dtype = _dev.resolve(device, dtype)
    unknown = set(fields) - set(UERIs._fields)
    if unknown:
        raise ValueError(f"unknown UERIs fields {sorted(unknown)}")
    out = {}
    for k in UERIs._fields:
        v = fields.get(k)
        if k in ("nocca", "noccb"):
            out[k] = int(v)
        else:
            out[k] = None if v is None else _tensor(v, device, dtype)
    return UERIs(**out)


def geris_from_numpy(blocks, fock, nocc, device, dtype=None):
    """The port's spin-orbital GERIs from ``{block: np.ndarray}`` (the
    JAX package's GERIs.b as numpy), the spinor Fock and nocc.  Unknown or
    missing block names raise."""
    from pyscf_mpcc_tpu_torch.cc.gccsd import GERIs
    if set(blocks) != set(GERIs.BLOCKS):
        raise ValueError(f"GERIs takes the blocks {GERIs.BLOCKS}, got "
                         f"{sorted(blocks)}")
    return GERIs(blocks, fock, nocc, device=device, dtype=dtype)


def amps_from_numpy(t1, t2, device, dtype=None):
    """(t1, t2) tensors from numpy amplitudes (an MP-CC bath, Lambda
    multipliers, EOM tangents too)."""
    return tensors_from_numpy(t1, t2, device=device, dtype=dtype)


def uamps_from_numpy(t1, t2, device, dtype=None):
    """Unrestricted ((t1a, t1b), (t2aa, t2ab, t2bb)) tensors from numpy
    (amplitudes, multipliers or EOM tangents)."""
    out = tensors_from_numpy(*t1, *t2, device=device, dtype=dtype)
    return out[:2], out[2:]


def tensors_from_numpy(*arrays, device, dtype=None):
    """A tuple of tensors on ``device``: boolean arrays (the MP-CC block
    masks) as torch.bool, the rest in the working dtype (DF factors and
    fock_mo, amplitudes, the DF-MP2 inputs B_ao, C0 and h_ao)."""
    device, dtype = _dev.resolve(device, dtype)
    return tuple(
        torch.tensor(np.asarray(x), device=device, dtype=torch.bool)
        if np.asarray(x).dtype == np.bool_ else _tensor(x, device, dtype)
        for x in arrays)


def t3_from_numpy(canon, device, dtype=None):
    """The canonical t3 block dict of the JAX package's cc.ccsdt_act /
    cc.ccsdt_env (``{signature: np.ndarray}``) as tensors.  Signatures
    outside ccsdt_act.T3_CANONICAL raise."""
    from pyscf_mpcc_tpu_torch.cc.ccsdt_act import T3_CANONICAL
    device, dtype = _dev.resolve(device, dtype)
    unknown = set(canon) - set(T3_CANONICAL)
    if unknown:
        raise ValueError(f"unknown t3 signatures {sorted(unknown)}")
    return {k: _tensor(v, device, dtype) for k, v in canon.items()}


def to_numpy(x):
    """numpy copy of a tensor on any device (``np.asarray`` is not safe on
    a CUDA tensor)."""
    return x.detach().cpu().numpy()
