"""Device-memory planner: size the tiled loops from available memory.

Port of ``pyscf_mpcc_tpu/lib/memory.py``.  The planners are the JAX
package's shape arithmetic, copied unchanged; only the budget query is
new: ``torch.cuda.mem_get_info`` plus what PyTorch's caching allocator
holds but does not use.  ``config.MAX_MEMORY`` (MB) still wins.  A CPU
device has no device memory to query, so there the caller passes an
explicit ``budget`` or sets ``config.MAX_MEMORY`` instead of a guess.
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch import config

_MB = 1024 * 1024


def hbm_budget_bytes(device=None, headroom=0.85):
    """Usable device memory in bytes (``config.MAX_MEMORY`` MB if set)."""
    if config.MAX_MEMORY:
        return int(config.MAX_MEMORY) * _MB
    if device is None or torch.device(device).type != "cuda":
        raise ValueError(
            f"no device memory to query on device={device!r}: pass an "
            "explicit budget or set pyscf_mpcc_tpu_torch.config.MAX_MEMORY (MB)")
    device = torch.device(device)
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int((free + cached) * headroom)


def _itemsize(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def plan_ladder_ntile(nocc, nvir, naux, dtype="float32", budget=None,
                      vjp=False, device=None):
    """Tile count per virtual axis for the pair-tiled DF vvvv ladder
    (cc/rccsd._ladder_df).

    Working set per tile PAIR beyond the persistent tensors: the dressed
    4-index W block (tsz, nvir, tsz, nvir) plus its relayout copy for
    the tau contraction (factor 2).  Returns the smallest ntile whose
    per-pair block fits in half of what remains after the persistent
    tensors; tsz is kept >= 16 where possible.  vjp=True plans for a
    backward sweep (2x the block set, more t2-sized cotangents)."""
    isz = _itemsize(dtype)
    budget = budget if budget is not None else hbm_budget_bytes(device)
    n_t2like = 7 if vjp else 4
    persistent = (naux * nvir * nvir + naux * nocc * nvir
                  + n_t2like * nocc * nocc * nvir * nvir) * isz
    avail = max(budget - persistent, budget // 8)
    live = 4 if vjp else 2
    for ntile in range(1, nvir + 1):
        tsz = -(-nvir // ntile)
        per_pair = tsz * tsz * nvir * nvir * isz * live
        if per_pair <= avail // 2:
            return ntile
        if tsz <= 16:
            break
    return -(-nvir // 16)


def ccsd_working_set_bytes(nocc, nvir, naux, ntile=1, dtype="float32",
                           ndev=1, stream_vv=False):
    """Model of the DF-CCSD update working set (bytes) on one device,
    the JAX package's model unchanged.

    ndev=1: the single-device footprint: persistent DF factors + the
    four-index ERI blocks + amplitudes (t, t_new, DIIS extrapolant) + the
    ladder tile block.  ndev>1: the per-device footprint with Lvv/Lov/Loo
    split over naux and the t2-likes over the first occupied axis, the
    small four-index blocks replicated.  The capacity tests use it to
    show that a problem exceeds one device's budget while its split or
    streamed layout fits.

    stream_vv=True models the out-of-core mode (cc/stream_ladder): Lvv
    stays in host memory, and what the device holds of it is two row
    tiles (the fetched tile and the next one, prefetched)."""
    isz = _itemsize(dtype)
    o2v2 = nocc * nocc * nvir * nvir
    tsz = -(-nvir // max(ntile, 1))
    lvv = naux * nvir * nvir * isz
    if stream_vv:
        lvv = 2 * naux * tsz * nvir * isz      # fetched tile + prefetch
    df = lvv + (naux * nocc * nvir
                + naux * nocc * nocc) * isz    # (Lvv) + Lov + Loo
    eris4 = 4 * o2v2 * isz                     # ovov + oovv + ovvo + ovoo~
    t2likes = 3 * o2v2 * isz                   # t2, t2new, tau
    tile = tsz * tsz * nvir * nvir * isz * 2
    if ndev == 1:
        return df + eris4 + t2likes + tile
    return df // ndev + eris4 + t2likes // ndev + tile


def plan_triples_tile(nocc, nvir, naux, dtype="float32", budget=None,
                      max_tile=8, device=None, engine="fused"):
    """Tile edge for the CCSD(T) engines (cc/ccsd_t.kernel).

    Per-tile live set: six W dot outputs of (T^3 * nocc^3) elements each
    (factor 4 for the dot workspace and the stacked prep), the six ov
    blocks, and the persistent t2T/t2Ts/oovv_T/L tensors.  engine
    'resident' adds the W1 operand that its prep makes of t2
    (ops.triples_resident.t2_operand): a copy of t2T zero-padded on its
    contracted axis to the MMA depth (at most 32) and on (j,k) to a
    multiple of 8, in t2's dtype, whose bf16 parts (as many bytes in
    'split') stay through the tile loop; while it is split, the copy, hi,
    hi upcast and x - hi are live at once, 3.5 copies.  Picks the largest
    even T <= max_tile that fits; minimum 4."""
    isz = _itemsize(dtype)
    budget = budget if budget is not None else hbm_budget_bytes(device)
    persistent = (3 * nvir * nvir * nocc * nocc      # t2T + t2Ts + oovv_T
                  + naux * nvir * nvir + naux * nocc * nvir) * isz
    avail = max(budget - persistent, budget // 8)
    best = 4
    for T in range(4, max_tile + 1, 2):
        live = (6 * T**3 * nocc**3 + 6 * T * T * nocc * nvir) * isz * 4
        if engine == "resident":
            nvp = -(-nvir // T) * T
            opnd = (nvp * (-(-nvp // 32) * 32)
                    * (-(-nocc * nocc // 8) * 8) * isz)
            live = max(live + opnd, 7 * opnd // 2)
        if live <= avail:
            best = T
    return best
