"""Host-memory store of the DF factor Lvv for the out-of-core ladder.

Port of the capability of ``pyscf_mpcc_tpu/lib/hoststore.py``: the
(naux, nvir, nvir) factor Lvv, the largest persistent tensor of a DF-CCSD
solve, stays in host memory and only row tiles of it reach the device
(cc/stream_ladder).  The JAX package kept a registry of int handles
because jitted code can only pass arrays; here ``RERIs.Lvv_stream`` holds
the store itself.

Layout: tile-major, ``(ntile, naux, tsz, nvir)``, rows zero-padded to
``ntile * tsz``, so each row tile is one contiguous block.  (A row slice
``Lvv[:, s:s+tsz, :]`` of the (naux, nvir, nvir) layout is strided, and
PyTorch copies a strided pinned view to the device through an unpinned
contiguous host copy: synchronously and slowly.)  On a CUDA store the
host tensor is pinned, tiles are copied on a side CUDA stream with an
event, and ``fetch_rows`` starts the copy of the tile the caller names
next while the caller computes with the current one (double buffering).
Each fetched tile is a fresh device tensor owned by the caller; the
store keeps at most the one prefetched tile.  On a CPU store a fetch is
a slice copy.
"""

from __future__ import annotations

import torch

from pyscf_mpcc_tpu_torch.lib import device as _dev

# tiling a store is built with; consumers retile to theirs on first use
DEFAULT_NTILE = 8


class HostStore:
    """Lvv in host memory, tile-major; see the module note.

    naux, nvir: the factor's shape (naux, nvir, nvir); dtype: the working
    dtype; device: where the tiles are fetched to."""

    def __init__(self, naux, nvir, dtype, device, ntile=DEFAULT_NTILE):
        self.naux, self.nvir, self.dtype = naux, nvir, dtype
        self.device = _dev.resolve(device, dtype)[0]
        self.bytes_moved = 0          # host -> device bytes of all fetches
        self._stream = None
        self._pending = None          # (tile, device tensor, event)
        self._alloc(ntile)

    @classmethod
    def from_tensor(cls, lvv, device, dtype=None, ntile=DEFAULT_NTILE):
        """A store holding ``lvv`` (naux, nvir, nvir), a tensor or array
        on any device, in ``dtype`` (default: its own); device None means
        the card (lib/device.resolve)."""
        lvv = torch.as_tensor(lvv)
        store = cls(lvv.shape[0], lvv.shape[1], dtype or lvv.dtype, device,
                    ntile)
        for a in range(store.ntile):
            store.set_tile(a, lvv[:, a * store.tsz:(a + 1) * store.tsz])
        return store

    def _alloc(self, ntile):
        self.ntile = max(1, min(int(ntile), self.nvir))
        self.tsz = -(-self.nvir // self.ntile)
        self.tiles = torch.zeros(
            (self.ntile, self.naux, self.tsz, self.nvir), dtype=self.dtype,
            pin_memory=self.device.type == "cuda")

    @property
    def nbytes(self):
        return self.tiles.numel() * self.tiles.element_size()

    def set_tile(self, a, rows):
        """Write rows [a*tsz, a*tsz + rows.shape[1]) (naux, n, nvir)."""
        self.tiles[a, :, :rows.shape[1]].copy_(rows)

    def to_dense(self):
        """The (naux, nvir, nvir) factor, on the host."""
        full = self.tiles.permute(1, 0, 2, 3).reshape(
            self.naux, self.ntile * self.tsz, self.nvir)
        return full[:, :self.nvir].contiguous()

    def retile(self, ntile):
        """Re-lay the store out in ``ntile`` row tiles (a host copy; a
        no-op at the current tiling)."""
        ntile = max(1, min(int(ntile), self.nvir))
        if ntile == self.ntile:
            return
        dense = self.to_dense()
        self._pending = None
        self._alloc(ntile)
        for a in range(self.ntile):
            self.set_tile(a, dense[:, a * self.tsz:(a + 1) * self.tsz])

    def _copy(self, a):
        """Start the copy of tile a to the device on the side stream:
        (device tensor, event)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            t = self.tiles[a].to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self.bytes_moved += t.numel() * t.element_size()
        return t, ev


def fetch_rows(store, a, prefetch=None):
    """Row tile ``a`` of the store, (naux, tsz, nvir) on its device.

    ``prefetch``: the tile the caller needs next; its copy starts now and
    the next call for it takes it without waiting.  The caller's stream
    waits on the copy's event, and the tile is recorded on that stream,
    so the allocator does not hand its memory out before the caller's
    queued work has read it."""
    if store.device.type != "cuda":
        out = store.tiles[a].clone()
        store.bytes_moved += out.numel() * out.element_size()
        return out
    pend, store._pending = store._pending, None
    if pend is not None and pend[0] == a:
        t, ev = pend[1], pend[2]
    else:
        # no prefetch or another tile: a stale prefetch is dropped (its
        # memory was taken on the side stream, after which it is reused)
        t, ev = store._copy(a)
    cur = torch.cuda.current_stream(store.device)
    cur.wait_event(ev)
    t.record_stream(cur)
    if prefetch is not None and prefetch != a:
        store._pending = (prefetch, *store._copy(prefetch))
    return t
