"""Device-mesh parallelism for the CC stack over ``torch.distributed``.

Port of ``pyscf_mpcc_tpu/parallel/mesh.py``.  The JAX package runs one
controller over many devices and lets XLA's SPMD partitioner insert the
collectives.  Here a mesh is one rank per process (``torch.distributed``,
NCCL between cards), the tensors a rank holds are its own shards, and
every collective is written out: :class:`Mesh` carries the process group
and issues them.  A mesh of one rank still goes through its process
group; nothing skips a collective because the size is 1.

Layout (one mesh axis ``dp``, as in the JAX package):

- the DF factors Lvv, Lov, Loo are sharded over the auxiliary axis (naux
  zero-padded to a multiple of the mesh size; zero rows contract to
  nothing); materialized ovvv over its first occupied axis;
- t2 is sharded over its first occupied axis, t1 is replicated;
- everything else (fock, oooo, ovoo, ovov, oovv, vvvv) is replicated.

``sharded_update_amps`` runs cc/rccsd.update_amps on these shards through
the routing hook that rccsd keeps for a factor that is not one resident
tensor (``RERIs.mesh``; the streamed Lvv takes the same hook): every Lvv
contraction runs on the rank's aux shard and its partial L-sum is summed
over the ranks (``all_reduce``), the ovvv contractions on the rank's
occupied rows are summed (contracted rows) or gathered (output rows), and
the ladder goes through parallel/ladder_shard.ladder_sharded.  What a rank
gathers: t2 whole, for the sweep (GSPMD gathers it the same way), and the
o^2 v^2 intermediates are replicated.  Lvv is never whole on one rank.
parallel/ccsd_shard is the layout that gathers no o^2 v^2 tensor either.

The transport follows the group's backend (``dist.get_backend``): NCCL
moves CUDA tensors where they lie; gloo moves host tensors, and a CUDA
tensor crosses through host memory explicitly (two ranks sharing one
card).  Row shards are equal: nocc must be a multiple of the mesh size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pyscf_mpcc_tpu_torch.cc import rccsd
from pyscf_mpcc_tpu_torch.lib import device as _dev

einsum = torch.einsum


class Mesh:
    """A 1-D mesh: this process's rank in a ``torch.distributed`` group,
    the group's size and the rank's device, with the collectives the CC
    layers use.  Each collective is called by every rank of the group in
    the same order, on tensors of equal shape."""

    def __init__(self, group, device, axis_name="dp"):
        self.group = group
        self.device = torch.device(device)
        self.axis_name = axis_name
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL group moves CUDA tensors: give the "
                             "mesh a CUDA device")
        # gloo moves host tensors: a CUDA tensor goes through host memory
        self._host = self.backend == "gloo" and self.device.type == "cuda"

    def _send(self, x):
        """x contiguous on the transport's device."""
        return (x.cpu() if self._host else x).contiguous()

    def _back(self, y, like):
        return y.to(like.device) if self._host else y

    def _peer(self, r):
        return dist.get_global_rank(self.group, r % self.size)

    def rows(self, x, dim=0):
        """This rank's block of x along dim (equal blocks)."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"axis of length {n} does not split evenly "
                             f"over a mesh of {self.size}")
        size = n // self.size
        return x.narrow(dim, self.rank * size, size)

    def psum(self, x):
        """Sum of x over the ranks (``all_reduce``).  x is summed in place
        when it is contiguous and on the transport's device: pass a tensor
        that the caller owns."""
        y = self._send(x)
        dist.all_reduce(y, group=self.group)
        return self._back(y, x)

    def psum_many(self, *xs):
        """The sums of several tensors through one ``all_reduce`` of their
        packed copy."""
        flat = self.psum(torch.cat([x.reshape(-1) for x in xs]))
        out, p = [], 0
        for x in xs:
            out.append(flat[p:p + x.numel()].view(x.shape))
            p += x.numel()
        return out

    def all_gather(self, x, dim=0):
        """The ranks' x concatenated along dim in rank order
        (``all_gather_into_tensor``; JAX's all_gather with tiled=True)."""
        xt = self._send(x.movedim(dim, 0))
        out = torch.empty((self.size * xt.shape[0],) + xt.shape[1:],
                          dtype=xt.dtype, device=xt.device)
        dist.all_gather_into_tensor(out, xt, group=self.group)
        return self._back(out, x).movedim(0, dim)

    def all_to_all(self, x):
        """Block e of x's first axis goes to rank e; the blocks received
        are concatenated along the first axis in rank order
        (``all_to_all_single``)."""
        xt = self._send(x)
        out = torch.empty_like(xt)
        dist.all_to_all_single(out, xt, group=self.group)
        return self._back(out, x)

    def ring_shift(self, x):
        """x sent to the next rank, the previous rank's x received (JAX's
        ppermute with perm [(i, i + 1 mod N)]): one batch of a send and a
        receive."""
        xt = self._send(x)
        out = torch.empty_like(xt)
        ops = [dist.P2POp(dist.isend, xt, self._peer(self.rank + 1),
                          self.group),
               dist.P2POp(dist.irecv, out, self._peer(self.rank - 1),
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._back(out, x)

    def broadcast(self, x, src=0):
        """x of rank src on every rank; x gives the shape and dtype on the
        others."""
        xt = self._send(x)
        dist.broadcast(xt, self._peer(src), group=self.group)
        return self._back(xt, x)


def _mesh_device(device):
    """The rank's device: None means the current CUDA device (raises where
    there is no card)."""
    device, _ = _dev.resolve(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices=None, axis_name="dp", device=None):
    """A 1-D mesh over the first n_devices ranks of the default process
    group (all of them when None), on this rank's ``device`` (None: the
    current CUDA device).  A sub-mesh is a new group (``dist.new_group``,
    which every rank of the default group must call); a rank outside it
    gets None."""
    device = _mesh_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.distributed.initialize first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a job of {world}")
    if n == world:
        return Mesh(dist.group.WORLD, device, axis_name)
    group = dist.new_group(list(range(n)))
    if dist.get_rank() >= n:
        return None
    return Mesh(group, device, axis_name)


def _aux_shard(x, mesh):
    """The rank's block of x's aux axis, zero-padded to a mesh multiple."""
    if x is None:
        return None
    pad = (-x.shape[0]) % mesh.size
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    return mesh.rows(x).contiguous()


def _put(x, mesh):
    return None if x is None else x.to(mesh.device)


def shard_eris(eris, mesh):
    """This rank's part of an RERIs container on ``mesh.device``: Lvv, Lov
    and Loo aux shards, ovvv occupied rows, everything else replicated;
    ``mesh`` set, so that rccsd routes the sharded contractions."""
    if eris.Lvv_stream is not None:
        raise ValueError("a streamed container (stream_vv) is not sharded")
    eris = eris._replace(**{f: _put(getattr(eris, f), mesh)
                            for f in eris._fields
                            if f not in ("Lvv_stream", "mesh")})
    return eris._replace(
        Lvv=_aux_shard(eris.Lvv, mesh), Lov=_aux_shard(eris.Lov, mesh),
        Loo=_aux_shard(eris.Loo, mesh),
        ovvv=None if eris.ovvv is None else mesh.rows(eris.ovvv).contiguous(),
        mesh=mesh)


def shard_amps(t1, t2, mesh):
    """t1 replicated; t2's block of occupied rows, on ``mesh.device``."""
    return (t1.to(mesh.device),
            mesh.rows(t2.to(mesh.device)).contiguous())


def sharded_update_amps(mesh, ntile=1):
    """``update(t1, t2_rows, eris_sharded, level_shift=0.0,
    variant='ccsd')``: rccsd.update_amps on the shards of shard_amps and
    shard_eris, returning (t1new replicated, t2new's rows).  t2 is gathered
    whole for the sweep; the DF and ovvv terms run on the shards (see the
    module docstring)."""
    def update(t1, t2, eris, level_shift=0.0, variant="ccsd"):
        if eris.mesh is not mesh:
            raise ValueError("eris is not sharded over this mesh: build it "
                             "with shard_eris(eris, mesh)")
        t1n, t2n = rccsd.update_amps(t1, mesh.all_gather(t2), eris,
                                     level_shift, ntile=ntile,
                                     variant=variant)
        return t1n, mesh.rows(t2n).clone()

    return update


class ShardedOvvv:
    """rccsd._OvvvOps' five contractions on a rank's shards: with DF
    factors each is rccsd's on the aux shard, summed over the ranks; with
    materialized ovvv (occupied rows k of this rank) a contraction over k
    is summed and one that keeps k is gathered along it."""

    def __init__(self, eris, ntile=1):
        self.mesh = mesh = eris.mesh
        if eris.ovvv is None:
            self.local = rccsd._OvvvOps(eris._replace(mesh=None), ntile)
        else:
            self.local = None
            self.ovvv = eris.ovvv
            self.k0, self.nk = mesh.rank * eris.ovvv.shape[0], \
                eris.ovvv.shape[0]

    def _k(self, x, dim=0):
        return x.narrow(dim, self.k0, self.nk)

    def t1_t2_terms(self, t2):
        if self.local is not None:
            return self.mesh.psum(self.local.t1_t2_terms(t2))
        ov, t2k = self.ovvv, self._k(t2, 1)
        return self.mesh.psum(2.0 * einsum("kdac,ikcd->ia", ov, t2k)
                              - einsum("kcad,ikcd->ia", ov, t2k))

    def lvv_t1(self, t1):
        if self.local is not None:
            return self.mesh.psum(self.local.lvv_t1(t1))
        ov, t1k = self.ovvv, self._k(t1)
        return self.mesh.psum(2.0 * einsum("kdac,kd->ac", ov, t1k)
                              - einsum("kcad,kd->ac", ov, t1k))

    def wvoov_t1(self, t1):
        if self.local is not None:
            return self.mesh.psum(self.local.wvoov_t1(t1))
        return self.mesh.all_gather(
            einsum("kcad,id->akic", self.ovvv, t1), dim=1)

    def wvovo_t1(self, t1):
        if self.local is not None:
            return self.mesh.psum(self.local.wvovo_t1(t1))
        return self.mesh.all_gather(
            einsum("kdac,id->akci", self.ovvv, t1), dim=1)

    def t2_vvov_t1(self, t1):
        if self.local is not None:
            return self.mesh.psum(self.local.t2_vvov_t1(t1))
        tmp2 = self.ovvv.permute(1, 3, 0, 2)
        return self.mesh.all_gather(einsum("abic,jc->ijab", tmp2, t1))


def ladder_vvvv(tau, t1, eris):
    """rccsd._ladder_vvvv with ovvv in occupied-row shards: the replicated
    vvvv part plus the ranks' summed t1-dressing parts."""
    mesh = eris.mesh
    t1k = t1.narrow(0, mesh.rank * eris.ovvv.shape[0], eris.ovvv.shape[0])
    w = einsum("kdac,kb->abcd", eris.ovvv, t1k)
    w = w + einsum("kcbd,ka->abcd", eris.ovvv, t1k)
    w = eris.vvvv.permute(0, 2, 1, 3) - mesh.psum(w)
    return einsum("abcd,ijcd->ijab", w, tau)


# ------------------------------------------------------------ UCCSD
_UROWS = ("ovvv", "OVVV", "ovVV", "OVvv")
_UAUX = ("Lov_a", "Lvv_a", "Lov_b", "Lvv_b")


def shard_ueris(ueris, mesh):
    """This rank's part of a UERIs container on ``mesh.device``: the
    per-spin DF factors aux shards, materialized three-virtual blocks
    their occupied rows, the o^2 v^2-class blocks replicated; ``mesh``
    set, so that cc/uccsd sums the partial L-sums."""
    kw = {f: _put(getattr(ueris, f), mesh) if torch.is_tensor(
        getattr(ueris, f)) else getattr(ueris, f)
        for f in ueris._fields if f != "mesh"}
    for f in _UAUX:
        kw[f] = _aux_shard(kw[f], mesh)
    for f in _UROWS:
        if kw[f] is not None:
            kw[f] = mesh.rows(kw[f]).contiguous()
    return type(ueris)(**kw, mesh=mesh)


def shard_uamps(t1, t2, mesh):
    """(t1a, t1b) replicated; each of (t2aa, t2ab, t2bb) its block of
    first-axis occupied rows."""
    return (tuple(x.to(mesh.device) for x in t1),
            tuple(mesh.rows(x.to(mesh.device)).contiguous() for x in t2))


def sharded_uccsd_update(mesh, ntile=1):
    """``update(t1, t2_rows, ueris_sharded, level_shift=0.0)``:
    cc/uccsd.update_amps on the shards of shard_uamps and shard_ueris,
    returning (t1 replicated, the t2 triple's rows).  The t2 blocks (and
    materialized three-virtual blocks, the small-system path) are
    gathered for the sweep; the DF terms run on the aux shards."""
    from pyscf_mpcc_tpu_torch.cc import uccsd

    def update(t1, t2, eris, level_shift=0.0):
        if eris.mesh is not mesh:
            raise ValueError("eris is not sharded over this mesh: build it "
                             "with shard_ueris(eris, mesh)")
        rows = {f: mesh.all_gather(getattr(eris, f)) for f in _UROWS
                if getattr(eris, f) is not None}
        t1n, t2n = uccsd.update_amps(
            t1, tuple(mesh.all_gather(x) for x in t2),
            eris._replace(**rows), level_shift, ntile=ntile)
        return t1n, tuple(mesh.rows(x).clone() for x in t2n)

    return update
