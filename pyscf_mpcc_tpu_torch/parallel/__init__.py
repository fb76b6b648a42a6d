"""Multi-device layer of the port: ``torch.distributed``, one rank per
process (port of ``pyscf_mpcc_tpu/parallel``)."""

from pyscf_mpcc_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, shard_eris, shard_amps, sharded_update_amps,
    shard_ueris, shard_uamps, sharded_uccsd_update,
)
