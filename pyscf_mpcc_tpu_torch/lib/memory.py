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
    """The memory floor of the tile count per virtual axis for the
    pair-tiled DF vvvv ladder (cc/rccsd._ladder_df): the fewest tiles
    that fit, the JAX package's rule.  plan_ladder_tiles picks the count
    the solvers run at, at or above it.

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


# The tau contraction of one ladder pair is one fp32 GEMM of nocc^2 x
# tsz^2 outputs over K = nvp^2.  On an H100 the sweep's GEMMs held 42-53
# TFLOP/s from 2.6e7 outputs a pair down to 3.2e5, benzene/cc-pVTZ's
# fastest sweep, at 9 tiles (tools/ladder_tile_sweep at the benzene and
# (H2O)8 cc-pVTZ shapes).  Below it benzene's 12 tiles (1.9e5) swept 18 %
# slower and nothing finer was timed, so the planner goes no finer.
MIN_TAU_OUTPUTS = 300_000

# the card of the sweep model: the fp32 GEMMs' FLOP/s and the bytes/s of
# the W relayout's copy, as the same sweeps read them on an H100
_GEMM_FLOPS, _MOVE_BYTES = 5.0e13, 9.0e11


def ladder_sweep_model_s(nocc, nvir, naux, ntile, dtype="float32"):
    """Modelled seconds of one pair-tiled ladder sweep (rccsd.mirrored_sweep)
    at ``ntile``: each of its nt(nt+1)/2 pairs builds a W block of tsz^2
    nvp^2 elements (nvir padded to nvp = nt tsz) by a GEMM over naux and
    contracts it with tau over nvp^2, 2 (naux + nocc^2) FLOP an element;
    the relayout reads and writes the block, beside one read of tau and
    of the pair's two Ld tiles."""
    isz = _itemsize(dtype)
    tsz = -(-nvir // ntile)
    nvp = ntile * tsz
    w = tsz * tsz * nvp * nvp
    flops = 2.0 * w * (naux + nocc * nocc)
    moved = (2 * w + nocc * nocc * nvp * nvp + 2 * naux * tsz * nvp) * isz
    return ntile * (ntile + 1) / 2 * (flops / _GEMM_FLOPS
                                      + moved / _MOVE_BYTES)


def plan_ladder_tiles(nocc, nvir, naux, dtype="float32", budget=None,
                      vjp=False, device=None):
    """Tile count per virtual axis the pair-tiled DF ladder runs at: of the
    counts at or above the memory floor (plan_ladder_ntile, ``vjp``
    included), the one with the least modelled sweep time
    (ladder_sweep_model_s) whose tau contraction keeps at least
    MIN_TAU_OUTPUTS outputs a pair.  A finer tiling halves fewer diagonal
    blocks, so it builds less of W: (nt+1)/(2 nt) of the dense nvir^4 at
    nvir divisible by nt.  The floor is returned where no finer count
    qualifies."""
    floor = plan_ladder_ntile(nocc, nvir, naux, dtype, budget, vjp, device)
    best, best_s = floor, ladder_sweep_model_s(nocc, nvir, naux, floor,
                                               dtype)
    for ntile in range(floor + 1, nvir + 1):
        tsz = -(-nvir // ntile)
        if nocc * nocc * tsz * tsz < MIN_TAU_OUTPUTS:
            break
        t = ladder_sweep_model_s(nocc, nvir, naux, ntile, dtype)
        if t < best_s:
            best, best_s = ntile, t
    return best


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


def triples_tile_bytes(nocc, nvir, naux, T, dtype="float32",
                       engine="fused", dot_precision=None):
    """(persistent, live) bytes of the CCSD(T) engines (cc/ccsd_t.kernel)
    at tile edge T: the model that plan_triples_tile sizes the tile by.

    Per-tile live set: six W dot outputs of (T^3 * nocc^3) elements each
    (factor 4 for the dot workspace and the stacked prep), the six ov
    blocks, and the persistent t2T/t2Ts/oovv_T/L tensors.  engine
    'resident' adds the W1 operand that its prep makes of t2
    (ops.triples_resident.t2_operand): a copy of t2T zero-padded on its
    contracted axis to the MMA depth (at most 32) and on (j,k) to a
    multiple of 8, in t2's dtype, whose bf16 parts (as many bytes in
    'split') stay through the tile loop; while it is split, the copy, hi,
    hi upcast and x - hi are live at once, 3.5 copies.  engine 'fused' at
    a bf16 dot_precision ('high', 'default') keeps the bf16 parts of t2T
    and t2Ts (ops.triples_combine.w1_t2: hi and lo in 'high', hi in
    'default'; in 'high' one fp32 copy's bytes a layout) and drops the
    fp32 t2Ts: t2T, the parts and oovv_T through the loop, t2T, t2Ts and
    the parts while t2Ts is split (oovv_T is made after), plus the split's
    f-chunk temporaries (hi upcast and x - hi); a tile adds the split ov
    blocks (tc.w1_ov, K = 3F in 'high') and up to four t2 slices
    (tc.w1_t2_slice).  Any other engine ('xla') is counted as 'fused' at
    full precision."""
    from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
    isz = _itemsize(dtype)
    o2v2 = nvir * nvir * nocc * nocc
    mode = tc.w1_mode(dot_precision)
    bf16_fused = engine == "fused" and mode != "f32"
    if bf16_fused:
        nparts = 2 if mode == "split" else 1
        t2like = (2 * isz + 2 * nparts * 2 + 2 * isz / tc.T2_SPLIT_CHUNKS)
    else:
        t2like = 3 * isz                               # t2T + t2Ts + oovv_T
    persistent = (t2like * o2v2
                  + (naux * nvir * nvir + naux * nocc * nvir) * isz)
    live = (6 * T**3 * nocc**3 + 6 * T * T * nocc * nvir) * isz * 4
    nvp = -(-nvir // T) * T
    if engine == "resident":
        opnd = (nvp * (-(-nvp // 32) * 32)
                * (-(-nocc * nocc // 8) * 8) * isz)
        live = max(live + opnd, 7 * opnd // 2)
    if bf16_fused:
        k = 3 if mode == "split" else 1
        live += (6 * T * T * nocc + 4 * T * nocc * nocc) * k * nvp * 2
    return persistent, live


def plan_triples_tile(nocc, nvir, naux, dtype="float32", budget=None,
                      max_tile=8, device=None, engine="fused",
                      dot_precision=None):
    """Tile edge for the CCSD(T) engines (cc/ccsd_t.kernel): the largest
    even T <= max_tile whose live set (triples_tile_bytes) fits in what
    the persistent tensors leave of the budget; minimum 4."""
    budget = budget if budget is not None else hbm_budget_bytes(device)
    persistent, _ = triples_tile_bytes(nocc, nvir, naux, 4, dtype, engine,
                                       dot_precision)
    avail = max(budget - persistent, budget // 8)
    best = 4
    for T in range(4, max_tile + 1, 2):
        if triples_tile_bytes(nocc, nvir, naux, T, dtype, engine,
                              dot_precision)[1] <= avail:
            best = T
    return best
