"""MO integral containers for the CC stack.

Port of ``pyscf_mpcc_tpu/cc/eris.py``: a NamedTuple of dense chemists'-
notation MO blocks (torch tensors on one device).  The AO -> MO transforms
run in float64 on the target device (the H100 has native fp64, which is
what the JAX package emulated with its int8 "ozaki" backend) and the
blocks are stored in the working dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.lib import device as _dev


class RERIs(NamedTuple):
    """Dense chemists' MO blocks for restricted CC.  All torch tensors.

    Naming: block[p,q,r,s] = (pq|rs) with o=occupied, v=virtual slots.
    """
    fock: torch.Tensor        # (nmo, nmo) MO-basis Fock
    mo_energy: torch.Tensor   # (nmo,) = diag(fock) for canonical orbitals
    oooo: torch.Tensor        # (ij|kl)
    ovoo: torch.Tensor        # (ia|jk)
    ovov: torch.Tensor        # (ia|jb)
    oovv: torch.Tensor        # (ij|ab)
    ovvo: Optional[torch.Tensor]  # (ia|bj); None -> derived from ovov
    ovvv: Optional[torch.Tensor]  # (ia|bc); None -> factorized through L
    vvvv: Optional[torch.Tensor]  # (ab|cd); None in DF mode
    Lvv: Optional[torch.Tensor] = None   # (naux, a, b) DF factor, DF mode
    Lov: Optional[torch.Tensor] = None   # (naux, i, a)
    Loo: Optional[torch.Tensor] = None   # (naux, i, j)
    # out-of-core mode (stream_vv=True, cc/stream_ladder): Lvv stays in
    # host memory in this lib/hoststore.HostStore and Lvv is None
    Lvv_stream: Optional[object] = None
    # sharded mode (parallel/mesh.shard_eris): the parallel.mesh.Mesh
    # whose ranks each hold an aux shard of Lvv/Lov/Loo and an occupied-row
    # shard of ovvv; the update sums their partial contractions
    mesh: Optional[object] = None

    @property
    def nocc(self):
        return self.oooo.shape[0]

    @property
    def nvir(self):
        return self.fock.shape[0] - self.oooo.shape[0]

    def get_ovvo(self):
        """(ia|bj).  For real orbitals (ia|bj) = (ia|jb), so DF mode
        stores no ovvo block: this returns a transposed view of ovov."""
        if self.ovvo is not None:
            return self.ovvo
        return self.ovov.permute(0, 1, 3, 2)


def _fp64(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float64)
    return torch.tensor(np.asarray(x), dtype=torch.float64, device=device)


def make_eris_incore(eri_ao, mo_coeff, fock_ao, nocc, dtype=None, *,
                     device):
    """Full-ERI container (parity/testing path)."""
    from pyscf_mpcc_tpu_torch import ao2mo
    device, dtype = _dev.resolve(device, dtype)
    mo = _fp64(mo_coeff, device)
    mo_eri = ao2mo.full(_fp64(eri_ao, device), mo).to(dtype)
    o = slice(0, nocc)
    v = slice(nocc, mo.shape[1])
    fock = (mo.T @ _fp64(fock_ao, device) @ mo).to(dtype)

    def blk(a, b, c, d):
        return mo_eri[a, b, c, d].contiguous()

    return RERIs(
        fock=fock,
        mo_energy=torch.diagonal(fock).clone(),
        oooo=blk(o, o, o, o),
        ovoo=blk(o, v, o, o),
        ovov=blk(o, v, o, v),
        oovv=blk(o, o, v, v),
        ovvo=blk(o, v, v, o),
        ovvv=blk(o, v, v, v),
        vvvv=blk(v, v, v, v),
    )


def _pair(La, Lb):
    """(pq|rs) = sum_L La[L,p,q] Lb[L,r,s] as one matmul."""
    naux = La.shape[0]
    out = La.reshape(naux, -1).T @ Lb.reshape(naux, -1)
    return out.reshape(La.shape[1:] + Lb.shape[1:])


def df_factors(b_ao, mo_coeff, nocc, dtype=None, *, device):
    """(Loo, Lov, Lvv): the MO blocks of the 3-center factors, transformed
    in fp64 on the device and stored in the working dtype.

    b_ao: (naux, nao, nao) factors (host array or tensor)."""
    device, dtype = _dev.resolve(device, dtype)
    mo = _fp64(mo_coeff, device)
    co, cv = mo[:, :nocc], mo[:, nocc:]
    B = _fp64(b_ao, device)
    Lo = torch.einsum("Lpq,pi->Liq", B, co)
    Loo = torch.einsum("Liq,qj->Lij", Lo, co).to(dtype)
    Lov = torch.einsum("Liq,qa->Lia", Lo, cv).to(dtype)
    del Lo
    Lv = torch.einsum("Lpq,pa->Laq", B, cv)
    del B
    Lvv = torch.einsum("Laq,qb->Lab", Lv, cv).to(dtype)
    return Loo, Lov, Lvv


def make_eris_df(b_ao, mo_coeff, fock_ao, nocc, dtype=None, keep_ovvv=True,
                 stream_vv=False, transform_backend=None, *, device):
    """DF container: all blocks from B factors; vvvv left implicit.

    b_ao: (naux, nao, nao) 3-center factors (host array or tensor).
    keep_ovvv=False factorizes every ovvv contraction through Lov/Lvv
    (production path: (ia|bc) is 9.7 GB in fp32 at (H2O)8/cc-pVTZ).
    stream_vv=True is the out-of-core mode (cc/stream_ladder): Lvv stays
    in host memory (``Lvv_stream``, pinned on CUDA) and only its row
    tiles reach the device; implies keep_ovvv=False."""
    if transform_backend == "ozaki":
        raise NotImplementedError(
            "transform_backend='ozaki' is not ported: the transforms run in "
            "native fp64 (ROADMAP north star, rule 3)")
    device, dtype = _dev.resolve(device, dtype)
    if stream_vv:
        Loo, Lov, Lvv_stream, oovv = _df_factors_streamed(
            b_ao, mo_coeff, nocc, dtype, device)
        Lvv = ovvv = None
    else:
        Loo, Lov, Lvv = df_factors(b_ao, mo_coeff, nocc, dtype,
                                   device=device)
        oovv = _pair(Loo, Lvv)
        ovvv = _pair(Lov, Lvv) if keep_ovvv else None
        Lvv_stream = None
    mo = _fp64(mo_coeff, device)
    fock = (mo.T @ _fp64(fock_ao, device) @ mo).to(dtype)
    return RERIs(
        fock=fock,
        mo_energy=torch.diagonal(fock).clone(),
        oooo=_pair(Loo, Loo),
        ovoo=_pair(Lov, Loo),
        ovov=_pair(Lov, Lov),
        oovv=oovv,
        ovvo=None,               # == ovov.permute(0,1,3,2); derived lazily
        ovvv=ovvv,
        vvvv=None,
        Lvv=Lvv, Lov=Lov, Loo=Loo, Lvv_stream=Lvv_stream,
    )


def _df_factors_streamed(b_ao, mo_coeff, nocc, dtype, device):
    """(Loo, Lov, store, oovv) with Lvv built in fp64 on the device one
    row tile at a time, stored in the working dtype into a host store
    (lib/hoststore), and its oovv rows formed from each tile: the whole
    Lvv never sits on the device."""
    from pyscf_mpcc_tpu_torch.lib.hoststore import HostStore
    mo = _fp64(mo_coeff, device)
    cv = mo[:, nocc:]
    B = _fp64(b_ao, device)
    Lo = torch.einsum("Lpq,pi->Liq", B, mo[:, :nocc])
    Loo = torch.einsum("Liq,qj->Lij", Lo, mo[:, :nocc]).to(dtype)
    Lov = torch.einsum("Liq,qa->Lia", Lo, cv).to(dtype)
    del Lo
    naux, nvir = B.shape[0], cv.shape[1]
    store = HostStore(naux, nvir, dtype, device)
    oovv = torch.empty((nocc, nocc, nvir, nvir), dtype=dtype, device=device)
    for a in range(store.ntile):
        sl = slice(a * store.tsz, (a + 1) * store.tsz)
        Lv = torch.einsum("Lpq,pa->Laq", B, cv[:, sl])
        rows = torch.einsum("Laq,qb->Lab", Lv, cv).to(dtype)
        del Lv
        store.set_tile(a, rows)
        oovv[:, :, sl] = _pair(Loo, rows)
        del rows
    return Loo, Lov, store, oovv
