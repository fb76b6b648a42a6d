"""Host-streamed DF particle-particle ladder and ovvv-class terms
(single-device out-of-core).

Port of ``pyscf_mpcc_tpu/cc/stream_ladder.py``.  The ladder's 3-center
factor Lvv (naux, nvir, nvir) is the largest persistent tensor of a
DF-CCSD solve; in this mode it stays in host memory (lib/hoststore) and
every consumer pulls row tiles of it to the device one at a time:

- ``pair_ladder_sym``: the mirrored A >= B pair sweep of
  cc/rccsd.pair_ladder_sym (``mirrored_sweep``) with both dressed row
  tiles, Ld = Lvv_tile - t1_tile^T Lov, made from fetched tiles;
- ``StreamedOvvv``: the five DF-mode methods of cc/rccsd._OvvvOps, one
  pass over the row tiles each.

Gradients.  The JAX package needs a hand-derived custom_vjp because its
host fetch (io_callback) is opaque to its AD.  Here a fetched tile is a
constant of the differentiation, and autograd through the dressing is
exact, so no backward is written by hand.  What matters is where the
fetch happens: inside the function that rccsd._remat checkpoints, never
passed to it as an argument.  A non-reentrant checkpoint keeps references
to its arguments until the backward pass, so a tile passed in would stay
alive, one per pair, and rebuild Lvv on the device; fetched inside, each
tile is freed with its block and fetched again when the backward pass
recomputes the block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pyscf_mpcc_tpu_torch.cc.rccsd import _remat, mirrored_sweep
from pyscf_mpcc_tpu_torch.lib.hoststore import fetch_rows

einsum = torch.einsum


def _dress(store, a, t1p, Lovp, prefetch):
    """Dressed row tile Ld[L, a in tile, c] (naux, tsz, nvp) of the
    padded factor."""
    lvv = fetch_rows(store, a, prefetch)
    pad = Lovp.shape[2] - lvv.shape[2]
    if pad:
        lvv = F.pad(lvv, (0, pad))
    t1t = t1p[:, a * store.tsz:(a + 1) * store.tsz]
    return lvv - einsum("ka,Lkc->Lac", t1t, Lovp)


def _pair_block(tau, t1p, Lovp, store, a, b, nxt):
    """One A >= B block: w[(a,c),(b,d)] = sum_L Ld[L,a,c] Ld[L,b,d]
    from two fetched tiles, contracted with tau."""
    naux, tsz, nvp = Lovp.shape[0], store.tsz, tau.shape[-1]
    la = _dress(store, a, t1p, Lovp, nxt if a == b else b)
    lb = la if a == b else _dress(store, b, t1p, Lovp, nxt)
    w = (la.reshape(naux, tsz * nvp).T
         @ lb.reshape(naux, tsz * nvp)).view(tsz, nvp, tsz, nvp)
    return einsum("acbd,ijcd->ijab", w, tau)


def pair_ladder_sym(tau, t1, Lov, store, ntile):
    """out[ijab] = sum_{L,c,d} Ld[L,a,c] Ld[L,b,d] tau[i,j,c,d] with
    Ld = Lvv - t1^T Lov and Lvv streamed from ``store`` in ``ntile`` row
    tiles: rccsd.mirrored_sweep with blocks from fetched tiles, each pair
    prefetching the next pair's first tile while it computes."""
    store.retile(ntile)
    nvp = store.ntile * store.tsz
    pad = nvp - t1.shape[1]
    if pad:
        t1 = F.pad(t1, (0, pad))
        Lov = F.pad(Lov, (0, pad))
    return mirrored_sweep(
        tau, store.ntile, store.tsz,
        lambda tau, a, b, nxt: _remat(_pair_block, tau, t1, Lov, store, a,
                                      b, nxt))


def _tile_call(body, store, a, nxt, *args):
    return body(fetch_rows(store, a, nxt), a, *args)


class StreamedOvvv:
    """Streamed twins of cc/rccsd._OvvvOps' DF-mode methods, with Lvv
    fetched tile-wise from a lib/hoststore store.

    Each method is one pass over the row tiles; each tile's body is
    checkpointed with its fetch inside (see the module note) and takes
    the tensors it differentiates as arguments, so rccsd._remat sees
    them.  Per-tile outputs are disjoint row blocks, concatenated; the
    one row-reduction (t2_vvov_t1) sums its partials."""

    def __init__(self, store, Lov, nvir, ntile):
        store.retile(ntile)
        self.store, self.Lov, self.nvir = store, Lov, nvir
        self.nocc = Lov.shape[1]

    def _map(self, body, *args):
        n = self.store.ntile
        return [_remat(_tile_call, body, self.store, a,
                       a + 1 if a + 1 < n else None, *args)
                for a in range(n)]

    def t1_t2_terms(self, t2):
        """2*(kd|ac) t2[ikcd] - (kc|ad) t2[ikcd] -> [ia]"""
        x = einsum("Lkd,ikcd->Lic", self.Lov, t2)
        y = einsum("Lkc,ikcd->Lid", self.Lov, t2)

        def body(lvv, a, x, y):               # lvv (L, a-tile, c)
            return (2.0 * einsum("Lic,Lac->ia", x, lvv)
                    - einsum("Lid,Lad->ia", y, lvv))

        return torch.cat(self._map(body, x, y), dim=1)[:, :self.nvir]

    def lvv_t1(self, t1):
        """2*(kd|ac) t1[kd] - (kc|ad) t1[kd] -> [ac].

        t1 is contracted into the tile first, (ad) t1[kd] -> y[L,a,k],
        where the resident method forms x[L,c,d] = (kc) t1[kd]: x has
        Lvv's size, and its cotangent would come back whole from every
        tile, so the backward pass would hold two Lvv-sized tensors."""
        z = einsum("Lkd,kd->L", self.Lov, t1)

        def body(lvv, a, z, t1, Lov):
            y = einsum("Lad,kd->Lak", lvv, t1)
            return (2.0 * einsum("L,Lac->ac", z, lvv)
                    - einsum("Lak,Lkc->ac", y, Lov))

        return torch.cat(self._map(body, z, t1, self.Lov),
                         dim=0)[:self.nvir]

    def wvoov_t1(self, t1):
        """(kc|ad) t1[id] -> [akic]"""
        def body(lvv, a, t1, Lov):
            xt = einsum("Lad,id->Lai", lvv, t1)
            return einsum("Lai,Lkc->akic", xt, Lov)

        return torch.cat(self._map(body, t1, self.Lov), dim=0)[:self.nvir]

    def wvovo_t1(self, t1):
        """(kd|ac) t1[id] -> [akci]"""
        x = einsum("Lkd,id->Lki", self.Lov, t1)

        def body(lvv, a, x):
            return einsum("Lki,Lac->akci", x, lvv)

        return torch.cat(self._map(body, x), dim=0)[:self.nvir]

    def t2_vvov_t1(self, t1):
        """sum_c (ia|cb) t1[jc] -> [ijab]; the one row-REDUCTION op:
        the Lvv row axis is contracted, so per-tile partials are summed."""
        tsz = self.store.tsz
        pad = self.store.ntile * tsz - self.nvir
        t1p = F.pad(t1, (0, pad)) if pad else t1

        def body(lvv, a, t1p):                # rows c in tile
            return einsum("Lcb,jc->Ljb", lvv,
                          t1p[:, a * tsz:(a + 1) * tsz])

        x = sum(self._map(body, t1p))         # (L, j, b)
        return einsum("Lia,Ljb->ijab", self.Lov, x)
