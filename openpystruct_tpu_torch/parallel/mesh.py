"""Process-group meshes and row sharding (port of ``parallel/mesh.py``).

The JAX package's mesh is one process holding several devices, with XLA
inserting the collectives.  The port follows the torch idiom instead: one
process per device.  A mesh is the group of ranks that ``torchrun`` (or
``parallel.spawn``) started, each rank on its own device (``cuda:LOCAL_RANK``
by default), and the size of its data axis is the world size.  A batch
sharded over the data axis is, on each rank, that rank's contiguous rows of
the global batch, in rank order; a replicated value is a broadcast from
rank 0.  The collectives are ``parallel.collectives``'.

Importing this module starts no process group.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from openpystruct_tpu_torch.device import resolve_device
from openpystruct_tpu_torch.parallel import collectives

#: torchrun's variables; all four present means a cluster environment.
_CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def mesh_shape(n: int, axis_names: Sequence[str]) -> dict:
    """{axis name: size} of a mesh over ``n`` devices: one axis takes all
    ``n``; two fold into a near-square grid whose first axis is the largest
    divisor of ``n`` at most sqrt(n) (the JAX package's rule)."""
    axis_names = tuple(axis_names)
    if len(axis_names) == 1:
        return {axis_names[0]: n}
    if len(axis_names) != 2:
        raise ValueError("only 1- or 2-axis default meshes are supported")
    d1 = math.isqrt(n)
    while n % d1:
        d1 -= 1
    return {axis_names[0]: d1, axis_names[1]: n // d1}


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """The ranks of a run as a mesh: ``shape`` maps each axis name to its
    size (their product is the world size), ``rank`` is this process's place
    in row-major order, ``device`` its device, and ``group`` the process
    group (None when no group was initialised: one process, and every
    collective is the identity)."""

    shape: dict
    rank: int
    world_size: int
    device: torch.device
    group: Optional[object] = None

    def shards(self, axis: str = "data") -> int:
        """The shard count of ``axis``.  The port shards rows over one axis
        that spans every rank; a mesh whose other axes hold more than one
        rank (replicas) raises."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}: {self.shape}")
        if self.shape[axis] != self.world_size:
            raise ValueError(
                f"axis {axis!r} has {self.shape[axis]} of the "
                f"{self.world_size} ranks ({self.shape}): the port shards "
                "rows over one axis spanning every rank")
        return self.world_size


def _local_card(world: int) -> torch.device:
    """This rank's card: ``cuda:LOCAL_RANK``, torchrun's index of the rank
    on its node (0 for a lone process).  More ranks on the node
    (``LOCAL_WORLD_SIZE``) than visible cards raises rather than putting
    two ranks on one card, and so does a multi-process run without
    ``LOCAL_RANK``: its global rank says nothing of its node."""
    resolve_device("cuda")
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
        node = int(os.environ.get("LOCAL_WORLD_SIZE", local + 1))
    elif world == 1:
        local, node = 0, 1
    else:
        raise RuntimeError(
            f"{world} ranks and LOCAL_RANK unset: launch with torchrun or "
            "pass device= to place the ranks")
    cards = torch.cuda.device_count()
    if max(node, local + 1) > cards:
        raise RuntimeError(
            f"{node} ranks but {cards} visible CUDA device(s) on this node: "
            "pass device= to place the ranks explicitly")
    return torch.device("cuda", local)


def default_mesh(axis_names: Sequence[str] = ("data",),
                 device=None) -> DataMesh:
    """The mesh of this run's ranks: the default process group when one is
    initialised (``initialize_multihost``), else this process alone.

    ``device`` is this rank's device; by default ``cuda:LOCAL_RANK``
    (``_local_card``: a node with more ranks than visible cards raises).  A
    device named by the caller is taken as given (two gloo ranks may share
    a card, or run on the CPU)."""
    if dist.is_available() and dist.is_initialized():
        world, rank, group = (dist.get_world_size(), dist.get_rank(),
                              dist.group.WORLD)
    else:
        world, rank, group = 1, 0, None
    device = _local_card(world) if device is None else resolve_device(device)
    return DataMesh(shape=mesh_shape(world, axis_names), rank=rank,
                    world_size=world, device=device, group=group)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """Which rows of a global batch this rank holds: its contiguous share
    along ``axis``, or every row when ``axis`` is None (replicated)."""

    mesh: DataMesh
    axis: Optional[str]

    def rows(self, n: int) -> slice:
        if self.axis is None:
            return slice(0, n)
        k = self.mesh.shards(self.axis)
        if n % k:
            raise ValueError(f"{n} rows do not split evenly over the {k} "
                             f"shards of axis {self.axis!r}")
        m = n // k
        return slice(self.mesh.rank * m, (self.mesh.rank + 1) * m)


def batch_sharding(mesh: DataMesh, axis: str = "data") -> Sharding:
    """Shard the leading (batch) dimension over ``axis``."""
    return Sharding(mesh, axis)


def replicated_sharding(mesh: DataMesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(tree, mesh: DataMesh, axis: str = "data"):
    """Every leaf (of a dict, list, tuple or dataclass of arrays) on this
    rank's device, the leaves with a leading dim cut to this rank's rows;
    scalars are kept whole."""
    sh = batch_sharding(mesh, axis)

    def put(x):
        x = torch.as_tensor(x, device=mesh.device)
        return x[sh.rows(x.shape[0])] if x.ndim >= 1 else x

    return collectives.tree_map(put, tree)


def make_global_batch(x, mesh: DataMesh, axis: str = "data",
                      local: bool = False) -> torch.Tensor:
    """This rank's rows of a batch sharded over ``axis``, on its device.

    - ``local=False``: every rank holds the FULL array (all load the same
      dataset, or computed it deterministically) and keeps its contiguous
      share, which must be even;
    - ``local=True``: each rank holds only ITS rows (per-rank dataset
      shards) and keeps them; the global batch is every rank's rows in rank
      order, and the counts may differ.

    ``collectives.all_gather_rows`` gives the global batch back."""
    x = torch.as_tensor(x, device=mesh.device)
    if local:
        mesh.shards(axis)
        return x
    return x[batch_sharding(mesh, axis).rows(x.shape[0])]


def replicate_to_mesh(tree, mesh: DataMesh):
    """Every leaf on this rank's device with rank 0's values (a broadcast
    from rank 0); the leaves must have the same shape and dtype on every
    rank."""
    def rep(x):
        x = torch.as_tensor(x, device=mesh.device)
        return collectives.broadcast(x, src=0, group=mesh.group)

    return collectives.tree_map(rep, tree)


def all_processes_min_max(x) -> tuple:
    """(global min, global max) of ``x`` over every rank's values, for
    data-dependent constants (the loss's box bounds) that must be identical
    on every rank when each rank sees only its own rows: 0-dim tensors on
    ``x``'s device (one MIN all-reduce when a process group is initialised;
    with one process the plain min and max)."""
    x = torch.as_tensor(x)
    both = collectives.all_reduce(torch.stack([x.min(), -x.max()]), op="min")
    return both[0], -both[1]


def initialize_multihost(**kwargs) -> None:
    """Join the process group of a multi-process run: a thin wrapper over
    ``torch.distributed.init_process_group``.

    The rendezvous is torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or the caller's
    ``init_method=``/``store=`` with ``world_size=`` and ``rank=``; other
    keyword arguments (``timeout=``) go to ``init_process_group``.
    ``device=`` is this rank's device (default ``cuda:LOCAL_RANK``, made
    current: ``default_mesh``'s rule), and the backend is NCCL for a CUDA device and gloo for the
    CPU unless ``backend=`` says otherwise.  A second call returns.  With
    no cluster environment it warns and the run stays single-process.  Any
    other failure raises: NCCL that cannot start, a card that is missing,
    a rendezvous that times out."""
    if dist.is_available() and dist.is_initialized():
        return
    device = kwargs.pop("device", None)
    backend = kwargs.pop("backend", None)
    if not ("init_method" in kwargs or "store" in kwargs
            or all(k in os.environ for k in _CLUSTER_ENV)):
        logging.getLogger(__name__).warning(
            "initialize_multihost: no cluster environment (%s unset, no "
            "init_method or store); continuing single-process",
            "/".join(_CLUSTER_ENV))
        return
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        resolve_device(device)
        if device.index is None:
            device = _local_card(int(kwargs.get(
                "world_size", os.environ.get("WORLD_SIZE", 1))))
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type == "cuda":
        # an eager communicator: a failing NCCL start raises here
        kwargs.setdefault("device_id", device)
    dist.init_process_group(backend=backend, **kwargs)
