"""Run a function on N local ranks without ``torchrun``.

``spawn(fn, world_size, init_file, args)`` starts ``world_size`` processes
with ``torch.multiprocessing``'s spawn method; each joins one process group
whose rendezvous is the file ``init_file`` (a ``file://`` store, no TCP
port: the file must not exist yet), with ``LOCAL_RANK`` set to its rank,
calls ``fn(rank, *args)``, and leaves the group.  ``fn`` must be
importable by name (a module-level function), and it returns its results
through files.
"""

from __future__ import annotations

import os
import time

import torch.distributed as dist
import torch.multiprocessing as mp

from openpystruct_tpu_torch.parallel.mesh import initialize_multihost


def _rank_main(rank, fn, world_size, init_file, backend, device, args):
    # every rank is on this node: its local rank is its rank, as torchrun
    # would say
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size))
    initialize_multihost(init_method=f"file://{init_file}",
                         world_size=world_size, rank=rank, backend=backend,
                         device=device)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, init_file, args=(), *, backend=None,
          device=None, timeout: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` on ``world_size`` ranks and wait for them.

    ``backend`` and ``device`` go to ``initialize_multihost`` (``device``
    is every rank's device, by default ``cuda:rank``).  A rank that raises
    ends the others and the error is raised here; past ``timeout`` seconds
    every rank is killed and ``TimeoutError`` is raised."""
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, str(init_file), backend, device,
                          tuple(args)),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
