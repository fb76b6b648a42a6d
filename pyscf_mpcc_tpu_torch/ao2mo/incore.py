"""AO -> MO integral transformation (O(N^5) quarter transforms).

Port of ``pyscf_mpcc_tpu/ao2mo/incore.py``: each quarter transform is one
(nao, nao^3) x (nao, nmo) matmul on whatever device the tensors live on.
"""

from __future__ import annotations

import torch


def general(eri_ao, mo_coeffs):
    """(pq|rs) -> (ij|kl) with four independent MO coefficient sets.

    eri_ao: (nao,nao,nao,nao) chemists' AO integrals.
    mo_coeffs: tuple of four (nao, n_i) matrices for the i, j, k, l slots.
    """
    ci, cj, ck, cl = mo_coeffs
    out = torch.tensordot(ci, eri_ao, dims=([0], [0]))      # (i, q, r, s)
    out = torch.tensordot(cj, out, dims=([0], [1]))         # (j, i, r, s)
    out = out.permute(1, 0, 2, 3)
    out = torch.tensordot(out, ck, dims=([2], [0]))         # (i, j, s, k)
    out = torch.tensordot(out, cl, dims=([2], [0]))         # (i, j, k, l)
    return out


def full(eri_ao, mo_coeff):
    return general(eri_ao, (mo_coeff,) * 4)
