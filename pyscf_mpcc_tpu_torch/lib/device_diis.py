"""Pulay DIIS with its history on the device.

Port of ``pyscf_mpcc_tpu/lib/device_diis.py``.  The ring of the last
``space`` vectors and their errors lives on the device as two stacked
tensors; each update writes one slot in place (``index_copy_``), so no
second ring is ever made, and the slot index and the count of stored
vectors stay on the device too.  The Gram matrix of the errors is a few
hundred bytes; :func:`update_hostsolve` moves only it to the host, solves
the augmented B system there in fp64 and extrapolates on the device, so
amplitude-sized data never leaves the card.

The Gram products run over chunks of the vector: an upcast of the whole
error ring (bf16 -> fp32) would be a transient of ``space`` times the
amplitudes (6 x 0.74 GB at the (H2O)8 shape).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.utils.profiling import span

# elements of the vector per Gram chunk: 64 MB of fp32 per ring row
_CHUNK = 1 << 24


class DIISState(NamedTuple):
    xs: torch.Tensor      # (space, n)
    errs: torch.Tensor    # (space, n)
    count: torch.Tensor   # () int64, total vectors stored so far


def init(n, space=6, dtype=torch.float32, err_dtype=None, *, device):
    """An empty ring on ``device``.  err_dtype=torch.bfloat16 halves the
    error ring (errors enter only through the Gram matrix, which is
    accumulated in fp32 and solved in fp64 on the host); xs keeps the
    working dtype."""
    device = torch.device(device)
    return DIISState(
        xs=torch.zeros((space, n), dtype=dtype, device=device),
        errs=torch.zeros((space, n), dtype=err_dtype or dtype, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
    )


def _store(state, x, err):
    """Write (x, err) into the next slot in place; return the valid-slot
    mask (space,) after the write, in xs' dtype."""
    space = state.xs.shape[0]
    slot = torch.remainder(state.count, space).reshape(1)
    state.xs.index_copy_(0, slot, x.reshape(1, -1).to(state.xs.dtype))
    state.errs.index_copy_(0, slot, err.reshape(1, -1).to(state.errs.dtype))
    state.count.add_(1)
    idx = torch.arange(space, device=state.xs.device)
    return (idx < torch.clamp(state.count, max=space)).to(state.xs.dtype)


def _gram(errs, valid, out_dtype, mesh=None):
    """(space, space) Gram matrix of the error rows, invalid rows and
    columns zero.  Accumulated in fp32 (fp64 where the ring or the output
    is fp64; an fp32 matmul of bf16 rows is the JAX package's
    preferred_element_type), chunk by chunk over the vector.  With a mesh
    (parallel/mesh) the rows are this rank's shard of the vectors and
    the partial dots are summed over the ranks, in the accumulation
    dtype, before the result is rounded."""
    acc = (torch.float64 if torch.float64 in (errs.dtype, out_dtype)
           else torch.float32)
    space, n = errs.shape
    g = torch.zeros((space, space), dtype=acc, device=errs.device)
    for s in range(0, n, _CHUNK):
        e = errs[:, s:s + _CHUNK].to(acc)
        g += e @ e.T
        del e
    if mesh is not None:
        g = mesh.psum(g)
    v = valid.to(acc)
    return (g * v[:, None] * v[None, :]).to(out_dtype)


def push(state: DIISState, x, err, mesh=None):
    """Store (x, err); return (state, G), G the float32 (space, space)
    Gram matrix of the valid error history (invalid rows zero).  On an
    fp64 ring G is accumulated in fp64 and rounded to fp32, as the JAX
    package's push returns it.  With a mesh, x and err are this rank's
    shards and G is the whole vectors' (see _gram)."""
    valid = _store(state, x, err)
    return state, _gram(state.errs, valid, torch.float32, mesh)


def extrapolate(state: DIISState, coef):
    """coef @ xs: the extrapolated vector from solved coefficients."""
    return coef @ state.xs


def update_hostsolve(state: DIISState, x, err, mesh=None):
    """Pulay update with the ring and the Gram products on the device and
    the small augmented B system solved on the host in fp64
    (lib/diis.solve_diis_b): an fp32 solve on the device stalls the
    iteration near |dt| ~ 1e-5, the host solve does not.  Only G (and the
    coefficients) cross to the host.

    mesh (parallel/mesh): the ring holds this rank's shard of the vectors
    (init with the shard's length), x and err are shards, and the result
    is the extrapolated shard.  Only the partial Gram dots are summed
    over the ranks; every rank then solves the same G, and the
    extrapolation and the history stay on the rank."""
    from pyscf_mpcc_tpu_torch.lib.diis import solve_diis_b

    state, G = push(state, x, err, mesh)
    space = state.xs.shape[0]
    with span("sync.diis_count"):
        nd = min(int(state.count), space)
    with span("sync.gram"):
        Gh = G.cpu().numpy().astype(np.float64)[:nd, :nd]
    coef = np.zeros(space)
    coef[:nd] = solve_diis_b(Gh)
    coef = torch.tensor(coef, dtype=state.xs.dtype, device=state.xs.device)
    return state, extrapolate(state, coef)
