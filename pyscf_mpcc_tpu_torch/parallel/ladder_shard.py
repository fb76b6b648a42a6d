"""Explicitly sharded particle-particle ladder (aux shards + all_reduce).

Port of ``pyscf_mpcc_tpu/parallel/ladder_shard.py``.  The DF ladder
sum_L Ld[L,ac] Ld[L,bd] tau[ijcd] distributes over the auxiliary axis:
each rank holds an naux shard of the dressed factor, builds its partial
W tiles, contracts them with the replicated tau, and the partial results
are summed over the ranks.  The counterpart of the reference's MPI tile
slicing (lib/cc/ccsd_t.c:856 MPICCsd_t_contract).
"""

from __future__ import annotations

import torch

from pyscf_mpcc_tpu_torch.cc.rccsd import pair_ladder_sym


def ladder_sharded(tau, ld, mesh, ntile=1, mirrored=False):
    """sum_{L,cd} Ld[L,a,c] Ld[L,b,d] tau[i,j,c,d] with L sharded.

    tau replicated, ld this rank's aux shard; returns the replicated
    result [i,j,a,b].  mirrored=False contracts ntile row tiles of ld
    against the whole factor (the JAX function); mirrored=True runs
    rccsd.pair_ladder_sym on the shard, the A >= B pair sweep with tau
    symmetrized on entry, which is what the CCSD update computes."""
    if mirrored:
        out = pair_ladder_sym(tau, ld, ntile)
    else:
        nvir = ld.shape[1]
        ta = -(-nvir // ntile)
        out = torch.cat([
            torch.einsum("abcd,ijcd->ijab",
                         torch.einsum("Lac,Lbd->abcd", ld[:, a0:a0 + ta], ld),
                         tau)
            for a0 in range(0, nvir, ta)], dim=2)
    return mesh.psum(out)
