"""Meshes and collectives over ``torch.distributed`` (port of
``parallel``).

The reference has no distributed communication: its only parallelism is a
share-nothing 22-process joblib pool
(OpenPyStruct_BeamOpt_training_MultiCore.py:258-262).  The JAX package
shards batch axes over a ``jax.sharding.Mesh`` and lets XLA insert the
collectives.  The port runs one process per device, launched by
``torchrun`` (or ``parallel.spawn``): ``fit(mesh=)`` trains data-parallel
with a gradient all-reduce, and ``generate_batch(mesh=)`` and
``generate_frame_batch(mesh=)`` give each rank its rows of the batch and
gather the results.  Importing the package initialises no process group.
"""

from openpystruct_tpu_torch.parallel.launch import spawn
from openpystruct_tpu_torch.parallel.mesh import (
    DataMesh,
    all_processes_min_max,
    batch_sharding,
    default_mesh,
    initialize_multihost,
    make_global_batch,
    mesh_shape,
    replicate_to_mesh,
    replicated_sharding,
    shard_batch,
)

__all__ = [
    "default_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "make_global_batch",
    "replicate_to_mesh",
    "all_processes_min_max",
    "initialize_multihost",
    "DataMesh",
    "mesh_shape",
    "spawn",
]
