"""Multi-process start-up: one rank per process under ``torch.distributed``.

Port of ``pyscf_mpcc_tpu/parallel/distributed.py`` (there
``jax.distributed`` joins the hosts of a pod into one job).  A multi-card
job starts one process per card, for instance

    torchrun --nproc-per-node 4 script.py

where the script calls ``initialize()`` and then ``global_mesh()``; every
sharded path of the port (parallel.mesh, parallel.ladder_shard,
parallel.ccsd_shard, the mesh (T)) then runs over NCCL.  The counterpart
of the reference's external MPI hook (lib/cc/ccsd_t.c:856
MPICCsd_t_contract, driven by mpi4pyscf).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from pyscf_mpcc_tpu_torch.lib import device as _dev


def launch_env(init_method=None, world_size=None, rank=None):
    """(init_method, world_size, rank, local_rank): the arguments given,
    else torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT); a one-process job when neither says otherwise."""
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1) if world_size is None
                     else world_size)
    rank = int(env.get("RANK", 0) if rank is None else rank)
    if init_method is None and "MASTER_ADDR" in env:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    return init_method, world_size, rank, int(env.get("LOCAL_RANK", 0))


def initialize(init_method=None, world_size=None, rank=None, device=None,
               backend=None):
    """Join this process to the job's default process group.

    The arguments default to torchrun's environment (``launch_env``).
    device None means CUDA (and raises where there is no card): the card
    is LOCAL_RANK's, set as the current device before the group is made;
    a CPU device takes gloo.  backend None is NCCL on CUDA and gloo on the
    CPU; gloo with a CUDA device (ranks sharing a card) moves tensors
    through host memory.  Returns False, and does nothing, when the job
    has one process and no group is asked for (no init_method or
    world_size given); True once the group is made."""
    device, _ = _dev.resolve(device)
    asked = init_method is not None or world_size is not None
    init_method, world_size, rank, local = launch_env(init_method,
                                                      world_size, rank)
    if world_size <= 1 and not asked:
        return False
    if init_method is None:
        raise ValueError("no rendezvous: pass init_method or set "
                         "MASTER_ADDR and MASTER_PORT")
    kw = {}
    if device.type == "cuda":
        device = torch.device("cuda", local if device.index is None
                              else device.index)
        torch.cuda.set_device(device)
        backend = backend or "nccl"
        if backend == "nccl":
            kw["device_id"] = device
    else:
        backend = backend or "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return True


def global_mesh(axis_name="dp", device=None):
    """The 1-D mesh over every rank of the job (parallel.mesh.make_mesh)."""
    from pyscf_mpcc_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(None, axis_name, device)
